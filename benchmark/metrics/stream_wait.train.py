"""The program's stream.wait spans (the prefetched stream's queue), as a share of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.share(run, "stream.wait")
