"""The program's train.backward spans (zero_grad and backward()), as a share of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.share(run, "train.backward")
