"""Seconds from the process's start to the first timed step or request."""


def read(run):
    return run.setup_s
