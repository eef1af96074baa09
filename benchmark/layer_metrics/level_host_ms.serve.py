"""level_host_ms.serve: host ms a served step inside the program's per-level
phase spans ``crfp.serve.lv0`` to ``crfp.serve.lv3`` (the full pyramid's
levels: resizes, warp, alignment, resblocks, tail), from the program's spans
(``benchmark/spans.py``); None for a program without them."""

from benchmark import spans

LEVELS = tuple(f"crfp.serve.lv{k}" for k in range(4))


def read(reading):
    if reading.kind != "stream":
        return None
    return spans.ms_per_unit(spans.records(), spans.SERVE_UNITS, LEVELS)
