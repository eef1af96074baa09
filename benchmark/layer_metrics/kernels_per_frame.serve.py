"""kernels_per_frame.serve: device kernels launched a served step (one frame of
every viewer) in the traced window (the host's dispatch work)."""

from benchmark import readers


def read(reading):
    return readers.kernels_per_unit(reading) if reading.kind == "stream" else None
