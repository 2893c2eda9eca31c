"""The (33, 1) value convolution's share of its roofline, forward and backward, in %."""

from benchmark import readers


def read(run):
    return readers.resconv_roofline(run)
