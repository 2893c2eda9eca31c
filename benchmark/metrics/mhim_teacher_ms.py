"""Device ms a step of the kernels launched inside the step's mhim.teacher range."""

from benchmark import readers


def read(run):
    return readers.range_device_ms(run, "mhim.teacher")
