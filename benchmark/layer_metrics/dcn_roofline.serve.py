"""dcn_roofline.serve: the DCN-stage and warp kernels' (A, B, E) share of
their roofline, in %: their calls' least time at the card's peaks over
their device time in the trace."""

from benchmark import readers


def read(reading):
    return readers.dcn_roofline(reading) if reading.kind == "stream" else None
