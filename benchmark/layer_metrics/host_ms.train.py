"""host_ms.train: host ms of a whole train step (``crfp.train.step``), from
the program's spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(reading):
    if reading.kind != "train":
        return None
    return spans.ms_per_unit(spans.records(), spans.TRAIN_UNITS, ("crfp.train.step",))
