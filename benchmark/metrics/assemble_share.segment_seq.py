"""The program's segment.assemble spans (cutting, padding and stacking
contexts), as a share of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.share(run, "segment.assemble")
