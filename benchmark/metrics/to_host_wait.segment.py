"""The program's segment.to_host spans (the tracks' copies to the host, which wait for the model), as a share of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.share(run, "segment.to_host")
