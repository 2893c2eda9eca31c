"""Valid bags trained a second by the MHIM teacher-student step, over the whole window."""

from benchmark import readers


def read(run):
    return readers.bags_per_s(run)
