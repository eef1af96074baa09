"""device_idle.train: the share of the traced window in which no operation
ran on the device, in the training cells."""

from benchmark import readers


def read(reading):
    return readers.device_idle(reading) if reading.kind == "train" else None
