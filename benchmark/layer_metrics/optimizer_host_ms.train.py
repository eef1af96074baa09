"""optimizer_host_ms.train: host ms a step in the optimizer
(``crfp.train.optimizer``: the schedules, ``zero_grad``, the flow-freeze drop
and ``opt.step()``), from the program's spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(reading):
    if reading.kind != "train":
        return None
    return spans.ms_per_unit(spans.records(), spans.TRAIN_UNITS, ("crfp.train.optimizer",))
