"""Padded frames over the frames of every context the window fed the
model (the program's counters segment.padded_frames and segment.contexts)."""


def read(run):
    c = run.counters
    if not c.get("contexts"):
        return None
    return 100.0 * c["padded_frames"] / (c["contexts"] * c["context_frames"])
