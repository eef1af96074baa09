"""dispatch_us.serve: host us of a call of the dispatchers of kernels A, B, C
and E in serving (``crfp.kernel.*`` spans: allocation, launch and counter,
from the plan on), on average, from the program's spans
(``benchmark/spans.py``)."""

from benchmark import spans


def read(reading):
    return spans.mean_us(spans.records(), spans.SERVE_KERNELS) \
        if reading.kind == "stream" else None
