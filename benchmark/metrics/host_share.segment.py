"""read_audio and the smoothing, as a share of request time."""

from benchmark.readers import span_share


def read(run):
    return span_share(run, ("read_audio", "smooth"), of="request")
