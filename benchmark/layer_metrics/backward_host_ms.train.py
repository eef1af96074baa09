"""backward_host_ms.train: host ms a step in the backward
(``crfp.train.backward``: ``loss.backward()``, remat's recompute included),
from the program's spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(reading):
    if reading.kind != "train":
        return None
    return spans.ms_per_unit(spans.records(), spans.TRAIN_UNITS, ("crfp.train.backward",))
