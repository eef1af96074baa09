"""mfu.serve: the whole served step's model FLOPs at the traced rate over the
configuration's peak, in %."""

from benchmark import readers


def read(reading):
    return readers.mfu(reading) if reading.kind == "stream" else None
