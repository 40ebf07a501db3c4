"""The program's train.optimizer spans (the optimizer's step), as a share of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.share(run, "train.optimizer")
