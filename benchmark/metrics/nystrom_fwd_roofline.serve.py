"""K1, K2 and the K3p sweep (ops pass_a, pass_b, newton_schulz): share of their roofline, in %."""

from benchmark import readers


def read(run):
    return readers.nystrom_roofline(run)
