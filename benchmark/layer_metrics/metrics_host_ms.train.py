"""metrics_host_ms.train: host ms a step in its four PSNR/SSIM passes
(``crfp.train.metrics``), from the program's spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(reading):
    if reading.kind != "train":
        return None
    return spans.ms_per_unit(spans.records(), spans.TRAIN_UNITS, ("crfp.train.metrics",))
