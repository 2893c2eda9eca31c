"""The reference's FLOPs of the traced window's work over its time at 989 TFLOP/s, in %."""

from benchmark import readers


def read(run):
    return readers.mfu(run)
