"""conv_ms.train: device ms of the convolution kernels (cuDNN) a step."""

from benchmark import readers


def read(reading):
    return readers.conv_ms(reading) if reading.kind == "train" else None
