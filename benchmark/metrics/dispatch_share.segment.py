"""The program's segment.model_call spans (the host queueing the model's work), as a share of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.share(run, "segment.model_call")
