"""device_idle.serve: the share of the traced window in which no operation
ran on the device, in the stream cells."""

from benchmark import readers


def read(reading):
    return readers.device_idle(reading) if reading.kind == "stream" else None
