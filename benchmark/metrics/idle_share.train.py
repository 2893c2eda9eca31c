"""The share of the traced window in which no kernel or copy ran on the device, in %."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
