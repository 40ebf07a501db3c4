"""Device operations in the trace per train step (the program's train.forward spans)."""

from benchmark import program_spans


def read(run):
    return program_spans.ops_per_step(run)
