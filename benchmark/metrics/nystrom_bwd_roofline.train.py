"""K1b, K2b and K3p's reverse sweep (ops pass_a_backward, pass_b_backward, newton_schulz_backward): share of their roofline, in %."""

from benchmark import backward_work


def read(run):
    return backward_work.roofline(run)
