"""Valid bags trained a second by a single-model train step, over the whole window."""

from benchmark import readers


def read(run):
    return readers.bags_per_s(run)
