"""The program's train.forward spans (forward pass, losses, L2 term), as a share of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.share(run, "train.forward")
