"""host_ms.serve: host ms a served step (one frame of every viewer) inside the
program's entry points, ``crfp.serve.encode`` plus ``crfp.serve.step`` or
``step0``, from the program's spans (``benchmark/spans.py``)."""

from benchmark import spans


def read(reading):
    if reading.kind != "stream":
        return None
    return spans.ms_per_unit(spans.records(), spans.SERVE_UNITS, spans.SERVE_HOST)
