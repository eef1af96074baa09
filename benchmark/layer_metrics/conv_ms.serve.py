"""conv_ms.serve: device ms of the convolution kernels (cuDNN) a served step
(one frame of every viewer)."""

from benchmark import readers


def read(reading):
    return readers.conv_ms(reading) if reading.kind == "stream" else None
