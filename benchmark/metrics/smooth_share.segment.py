"""The program's segment.smooth spans (median smoothing of the track), as a share of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.share(run, "segment.smooth")
