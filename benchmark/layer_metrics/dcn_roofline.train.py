"""dcn_roofline.train: the DCN-stage and warp kernels' (A, B, D) share of
their roofline, in %: their calls' least time at the card's peaks over
their device time in the trace."""

from benchmark import readers


def read(reading):
    return readers.dcn_roofline(reading) if reading.kind == "train" else None
