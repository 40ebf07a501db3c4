"""The benchmark's spans around each next() of the prefetched stream, as a
share of the window."""

from benchmark.readers import span_share


def read(run):
    return span_share(run, ("input_wait",))
