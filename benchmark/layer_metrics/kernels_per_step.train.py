"""kernels_per_step.train: device kernels launched a step in the traced
window (the host's dispatch work)."""

from benchmark import readers


def read(reading):
    return readers.kernels_per_unit(reading) if reading.kind == "train" else None
