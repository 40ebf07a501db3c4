"""Padded frames over the frames of every chunk the window's model calls
fed (the program's counters segment.padded_frames and
segment.stream_chunks)."""


def read(run):
    c = run.counters
    if not c.get("stream_chunks"):
        return None
    return 100.0 * c["padded_frames"] / (c["stream_chunks"]
                                         * c["context_frames"])
