"""The 95th percentile of every request's latency in the window, host clock, call to logits on the host."""

from benchmark import readers


def read(run):
    return readers.p95_ms(run)
