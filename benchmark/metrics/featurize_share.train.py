"""The program's train.featurize spans (K1 and the patches, the noise augmentation), as a share of the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.share(run, "train.featurize")
