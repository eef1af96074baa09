"""The frozen reference against the port's plain CPU path at a tiny size, on
the benchmark's own weights: the batched streams (both configurations), one train
step, the name table and the configuration files' settings."""

from __future__ import annotations

import torch

from benchmark import compare, generate
from benchmark.reference import names
from benchmark.reference.trunk import charbonnier
from benchmark.tests.tiny import tiny_cell


def _stream_pair(name: str, seed: int):
    cell = tiny_cell(name)
    cfg, mix, family = cell["config"], cell["traffic"], cell["family"]
    cfg = dict(cfg, dtype="float32")  # the port's plain path and the reference alike
    rows = names.table(family.stream_reference(cfg, mix))
    w = names.seeded_weights(rows, seed, "cpu")
    port = family.stream_program(cfg, mix, w, torch.device("cpu"))
    ref, run = compare.stream_reference(family.stream_reference(cfg, mix), w, "cpu")
    return port, ref, run, generate.stream_pool(mix, seed, "cpu", torch.float32)


def test_stream_deploy_and_ref_match_the_port():
    for name in ("deploy.streams4_1080p", "ref.streams4_1080p"):
        port, ref, run, pool = _stream_pair(name, 21)
        state = r_state = prev = None
        with torch.no_grad():
            for j in range(3):
                lr, fv = pool["lr"][j], pool["fv"][j]
                x_lr, x_hr = port.encode(lr, fv)
                lr_c, fv_c = lr.permute(0, 3, 1, 2), fv.permute(0, 3, 1, 2)
                if j == 0:
                    state, out = port.step0(lr, x_lr, x_hr)
                    r_state, r_out = run(lambda: ref.step0(lr_c, *ref.encode(lr_c, fv_c)))
                else:
                    state, out = port.step(state, lr, prev, x_lr, x_hr)
                    p_c = prev.permute(0, 3, 1, 2)
                    r_state, r_out = run(lambda: ref.step(r_state, lr_c, p_c,
                                                          *ref.encode(lr_c, fv_c)))
                prev = lr
                torch.testing.assert_close(out.permute(0, 3, 1, 2), r_out, atol=1e-5, rtol=1e-5)
                torch.testing.assert_close(state["hr"].permute(0, 3, 1, 2), r_state["hr"],
                                           atol=1e-5, rtol=1e-5)


def test_train_step_matches_the_port():
    cell = tiny_cell("ref.train_sh")
    cfg, mix, family = cell["config"], cell["traffic"], cell["family"]
    w = names.seeded_weights(names.table(family.train_reference(cfg)), 22, "cpu")
    batch = generate.train_pool(mix, 22, "cpu")[0]
    model, _, _, _ = family.train_program(cfg, w, torch.device("cpu"))
    ref = names.materialize(family.train_reference(cfg), w, "cpu")
    pred = model(batch["lr"], batch["fv"], batch["mk"]).float()
    loss = charbonnier(pred, batch["hr"])
    loss.backward()
    lr, fv, mk, hr = compare.batch_nchw(batch)
    r_loss = charbonnier(ref(lr, fv, mk), hr)
    r_loss.backward()
    torch.testing.assert_close(loss, r_loss, atol=0, rtol=1e-5)
    grads = dict(ref.named_parameters())
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[n].grad, atol=1e-7, rtol=1e-4)


def test_name_table_loads_strictly_into_both():
    for name in ("deploy.streams4_1080p", "ref.train_sh"):
        cell = tiny_cell(name)
        cfg, mix, family = cell["config"], cell["traffic"], cell["family"]
        train = mix["kind"] == "train"
        module = family.train_reference(cfg) if train else family.stream_reference(cfg, mix)
        rows = names.table(module)
        w = names.seeded_weights(rows, 1, "cpu")
        again = names.seeded_weights(rows, 1, "cpu")
        assert all(torch.equal(w[k], again[k]) for k in w)
        names.materialize(module, w, "cpu")  # strict
        if train:
            family.train_program(cfg, w, torch.device("cpu"))  # strict
        else:
            family.stream_program(cfg, mix, w, torch.device("cpu"))


def test_configuration_files_state_what_main_runs():
    """The ref configuration's model and trainer fields are what ``python -m
    crfp_torch.main`` derives from its ``train.sh`` flags."""
    cell = tiny_cell("ref.train_sh")
    cfg, family = cell["config"], cell["family"]
    mcfg, tcfg = family.train_settings(cfg)
    assert mcfg == family.model_config(cfg)
    t = cfg["train"]
    assert (tcfg.lr_rate, tcfg.lr_rate_flow, tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.min_lr,
            tcfg.flow_freeze_iters, tcfg.rec_w, tcfg.amp) == (
        t["lr_rate"], t["lr_rate_flow"], t["beta1"], t["beta2"], t["eps"], t["min_lr"],
        t["flow_freeze_iters"], t["rec_w"], False)
    assert tcfg.periods == (t["period"],)
    assert torch.backends.cudnn.allow_tf32 == cfg["cudnn_allow_tf32"]


def test_fp8_round_is_coarser_than_bf16():
    x = torch.linspace(-3, 3, 1001)
    e8 = (compare.fp8_round(x) - x).abs().max()
    e16 = (x.to(torch.bfloat16).float() - x).abs().max()
    assert e8 > 4 * e16
