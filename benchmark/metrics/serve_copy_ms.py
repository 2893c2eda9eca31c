"""Device ms a request of the Scorer's host-to-device copies."""

from benchmark import readers


def read(run):
    return readers.htod_copy_ms(run)
