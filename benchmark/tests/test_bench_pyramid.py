"""The cell ``pyramid_x8_mid64.stream_720p`` at ``tiny.py``'s sizes on the CPU:
a sound run is correct, each fault a stream cell can have makes it
incorrect, the control fails its limits, the counted FLOPs behind
``mfu.serve`` are a hand count of the model's convolutions and DCN
contractions, the family's inputs and names are what it says, and
``level_host_ms.serve`` reads the level spans or nothing."""

from __future__ import annotations

import pytest
import torch

from benchmark import manifest, stream, trace
from benchmark.reference import names
from benchmark.run import execute
from benchmark.tests.tiny import tiny_cell

CELL = "pyramid_x8_mid64.stream_720p"
CPU = torch.device("cpu")


def test_sound_run_is_correct():
    line = execute(tiny_cell(CELL), 2147483999, 0.0, False, CPU)
    assert line["correct"], line["checks"]
    assert line["attempted"] == tiny_cell(CELL)["traffic"]["viewers"] * 3


@pytest.mark.parametrize("fault", sorted(stream.FAULTS))
def test_fault_is_not_correct(fault):
    cell = tiny_cell(CELL)
    with stream.FAULTS[fault](cell["family"]):
        line = execute(cell, 52, 0.0, False, CPU)
    assert not line["correct"], line["checks"]


def test_control_fails_the_limits():
    cell = tiny_cell(CELL)
    numbers = stream.control(cell, 53, CPU)
    assert any(numbers[k] > v["limit"] for k, v in cell["limits"].items()), numbers


def _conv(n, h, w, cin, cout, k=3):
    return 2 * n * h * w * cin * cout * k * k


def hand_count(n: int, lr_hw, mid: int, dg: int) -> dict:
    """FLOPs of the first and a steady served step (encode included) of
    MRCF_x8: every convolution and each DCN's contraction, 2 a
    multiply-add."""
    h, w = lr_hw
    m = mid

    def at(k):  # level k's size
        return h << k, w << k

    hh, ww = at(3)
    encode = _conv(n, h, w, 3, m) + _conv(n, h, w, m, m)
    encode += _conv(n, hh, ww, 6, m) + 2 * _conv(n, hh, ww, m, m)
    encode += 3 * _conv(n, hh // 2, ww // 2, m, m) + 3 * _conv(n, hh // 4, ww // 4, m, m)
    emit = _conv(n, hh, ww, m, m) + _conv(n, hh, ww, m, 3)

    def level(k):  # the resblocks and the tail
        y, x = at(k)
        f = _conv(n, y, x, 2 * m, m) + 2 * (3, 3, 1, 1)[k] * _conv(n, y, x, m, m)
        return f + (_conv(n, y, x, m, 4 * m) if k < 3 else _conv(n, y, x, 2 * m, m))

    first = encode + sum(level(k) for k in range(4)) + emit
    hu, wu = -(-h // 32) * 32, -(-w // 32) * 32
    spynet = sum(_conv(n, hu >> s, wu >> s, cin, cout, 7) for s in range(6)
                 for cin, cout in ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2)))
    steady = encode + spynet + emit
    for k, g in enumerate((dg, dg, dg // 4, dg // 16)):
        y, x = at(k)
        steady += level(k) + _conv(n, y, x, 2 * m + 2, m) + 2 * _conv(n, y, x, m, m)
        steady += _conv(n, y, x, m, 27 * g) + 2 * n * y * x * m * m * 9
    return {"flops_first": first, "flops_steady": steady}


def test_counted_flops_are_the_hand_count():
    cell = tiny_cell(CELL)
    mix, model = cell["traffic"], cell["config"]["model"]
    counted = stream.counted(cell, stream.inputs(cell, 3, CPU))
    want = hand_count(mix["viewers"], mix["lr_hw"], model["mid_channels"], model["dg_num"])
    assert {k: counted[k] for k in want} == want
    # the DCN-stage bound: the four DCNs and four warps of a steady step
    assert counted["bound_s_first"] == 0 and counted["bound_s_steady"] > 0


def test_inputs_are_the_full_size_fovea_and_its_mask():
    cell = tiny_cell(CELL)
    mix = cell["traffic"]
    pool = stream.inputs(cell, 4, CPU)
    fh, fw = mix["fovea_hw"]
    h, w = mix["lr_hw"]
    s = mix["scale"]
    fv = pool["fv"]
    assert fv.shape == (mix["pool_frames"], mix["viewers"], h * s, w * s, 4)
    assert fv.dtype == manifest.DTYPES[cell["config"]["dtype"]]
    mask = torch.zeros(h * s, w * s)
    mask[:fh, :fw] = 1
    assert torch.equal(fv[..., 3].float(), mask.expand_as(fv[..., 3]))
    assert torch.equal(fv[..., fh:, :, :3].float().abs().sum(), torch.tensor(0.0))


def test_name_table_loads_strictly_into_both():
    cell = tiny_cell(CELL)
    cfg, mix, family = cell["config"], cell["traffic"], cell["family"]
    module = family.stream_reference(cfg, mix)
    w = names.seeded_weights(names.table(module), 1, "cpu")
    names.materialize(module, w, "cpu")  # strict
    served = family.stream_program(cfg, mix, w, CPU)  # strict, under the port's names
    port = served.model.state_dict()
    dcn = port["align_lv3.dcn_weight_lv3"]
    assert torch.equal(dcn, w["align_lv3.dcn_weight"].to(dcn.dtype))
    assert len(port) == len(w)


def test_level_host_ms_reads_the_level_spans_or_nothing(monkeypatch):
    from collections import namedtuple

    from benchmark import spans

    read = manifest.reader("level_host_ms.serve")
    reading = trace.Reading(kind="stream", units=2, window_s=1.0)
    span = namedtuple("span", "name start end")
    monkeypatch.setattr(spans, "records", lambda: [])
    assert read(reading) is None
    store = [span("crfp.serve.step", 0, 9_000_000), span("crfp.serve.step", 0, 9_000_000)]
    store += [span(f"crfp.serve.lv{k}", 0, 1_000_000) for k in range(4)] * 2
    store += [span("crfp.serve.flow", 0, 5_000_000)]
    monkeypatch.setattr(spans, "records", lambda: store)
    assert read(reading) == pytest.approx(4.0)
    assert read(trace.Reading(kind="train", units=2, window_s=1.0)) is None
