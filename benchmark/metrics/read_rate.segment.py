"""Audio seconds read per second inside the program's audio.read spans."""

from benchmark import program_spans


def read(run):
    return program_spans.read_rate(run)
