"""The spans around the segmenter's segment() less its smoothing, as a
share of request time (traced run: the featurize span ends in a
synchronise)."""

from benchmark.readers import span_share


def read(run):
    return span_share(run, ("segment",), minus=("smooth",), of="request")
