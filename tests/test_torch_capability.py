"""The capability ablation of the port (crfp_torch/bench/capability.py)
against the JAX package's on the CPU, at hr 128, 3 frames, sigma 10, mid 8.

The checkpoints are the port's seeded trunks (v18 and basic_fvsr with
random offset/mask heads and DCN weights) written with ``params.save_npz``,
the file both packages load; a JAX ``init`` of the three trunks takes over
a minute here.

- bf16 (the deployment precision, which JAX's ``run_capability`` fixes;
  its v18 row's ``hr_s2d``/``dcn_anchor`` run the plain clamp on the CPU):
  the same keys; the bicubic row equal to 1e-6; each model row's per-zone
  PSNR within 0.05 dB (the deployment gate's bound) and SSIM within 1e-3.
- f32: the same rows against an oracle built here from JAX's ``CRFP``,
  ``StreamingRunner`` and ``OnChipZoneEval`` on the same inputs, PSNR
  within 1e-3 dB and SSIM within 1e-5.
- Without a card the harness raises unless asked for the CPU.
"""

import sys

import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

MID, HR, FRAMES, SIGMA = 8, 128, 3, 10.0
VARIANTS = {"v18": dict(variant="v18"),
            "no_dcn": dict(variant="no_dcn", hr_dcn=False),
            "basic_fvsr": dict(variant="basic_fvsr", hr_dcn=False)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, save_npz, to_jax

    d = tmp_path_factory.mktemp("capability")
    out = {}
    for i, (name, kw) in enumerate(VARIANTS.items()):
        sd = CRFP(ModelConfig(mid_channels=MID, **kw), device="cpu", seed=i).state_dict()
        out[name] = str(d / f"{name}.npz")
        save_npz(from_jax(tp.perturb_heads(to_jax(sd), seed=i)), out[name])
    return out


def _port(ckpts, bf16):
    from crfp_torch.bench.capability import run_capability

    return run_capability(ckpts, sigmas=(SIGMA,), hr_size=HR, frames=FRAMES, mid=MID,
                          bf16=bf16, device="cpu")


def _compare(got, want, psnr_tol, ssim_tol):
    assert got.keys() == want.keys()
    assert got["rows"].keys() == want["rows"].keys()
    assert got["deltas"].keys() == want["deltas"].keys()
    for row, per in want["rows"].items():
        assert got["rows"][row].keys() == per.keys(), row
        for s, m in per.items():
            g = got["rows"][row][s]
            assert g.keys() == m.keys(), (row, s)
            for k, v in m.items():
                tol = 1e-6 if row == "bicubic" else (psnr_tol if k.startswith("psnr")
                                                     else ssim_tol)
                assert np.isfinite(g[k]) and abs(g[k] - v) <= tol, (row, k, g[k], v)


def test_bf16_matches_jax_run_capability(ckpts):
    from crfp_tpu.bench.capability import run_capability as jax_run

    want = jax_run(ckpts, sigmas=(SIGMA,), hr_size=HR, frames=FRAMES, mid=MID)
    got = _port(ckpts, bf16=True)
    _compare(got, want, psnr_tol=0.05, ssim_tol=1e-3)


def _jax_f32_oracle(ckpts, skip=2):
    """JAX's run_capability loop in float32: its clip, bicubic and gaze, its
    StreamingRunner per row (the plain clamp at v18's windows 8/32) and its
    OnChipZoneEval."""
    import jax.numpy as jnp

    from crfp_tpu.bench import capability as jc
    from crfp_tpu.eval.zones import OnChipZoneEval, zone_masks_step
    from crfp_tpu.models.crfp import CRFP, ModelConfig
    from crfp_tpu.models.streaming import StreamingRunner
    from crfp_tpu.utils.params_io import load_params

    cfgs = {"no_dcn": ModelConfig(variant="no_dcn", mid_channels=MID, hr_dcn=False),
            "basic_fvsr": ModelConfig(variant="basic_fvsr", mid_channels=MID, hr_dcn=False,
                                      dcn_window=8),
            "v18": ModelConfig(variant="v18", mid_channels=MID, dcn_window=8,
                               dcn_window_hr=32)}
    runners = {k: StreamingRunner(CRFP(c), load_params(ckpts[k]), donate=False)
               for k, c in cfgs.items()}
    rng = np.random.default_rng(9000)
    lr, hr = jc._held_out_clip(9100, FRAMES, HR, HR)
    bic = jc._bicubic8(lr, HR, HR)
    gaze = np.stack([SIGMA * rng.standard_normal(FRAMES) + HR / 2,
                     SIGMA * rng.standard_normal(FRAMES) + HR / 2], axis=1)
    evs = {r: OnChipZoneEval(jc.FV_SIZE) for r in ["bicubic", *cfgs]}
    for i in range(FRAMES):
        z = zone_masks_step(HR, HR, tuple(gaze[i]), jc.FV_SIZE)
        gt = jnp.asarray(hr[i][None])
        evs["bicubic"].update(jnp.asarray(bic[i][None]), gt, z)
        for name, runner in runners.items():
            out = jnp.clip(runner(jnp.asarray(lr[i][None]), gt, jnp.asarray(z.mask[None])), 0, 1)
            evs[name].update(out, gt, z)
    return {r: {k: float(np.mean(v[max(skip - 1, 0) if k.endswith("past") else skip:]))
                for k, v in ev.results.items()} for r, ev in evs.items()}


def test_f32_matches_jax_oracle(ckpts):
    want = _jax_f32_oracle(ckpts)
    got = _port(ckpts, bf16=False)
    assert list(got["rows"]) == ["bicubic", "no_dcn", "basic_fvsr", "v18"]
    for row, m in want.items():
        g = got["rows"][row][f"{SIGMA:g}"]
        assert g.keys() == m.keys(), row
        for k, v in m.items():
            tol = 1e-3 if k.startswith("psnr") else 1e-5
            assert abs(g[k] - v) <= tol, (row, k, g[k], v)


def test_capability_needs_a_card_unless_asked_for_the_cpu(ckpts):
    from crfp_torch.bench.capability import main, run_capability

    with pytest.raises(ValueError, match="none of the trained rows"):
        run_capability({}, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_capability(ckpts, sigmas=(SIGMA,), hr_size=HR, frames=FRAMES, mid=MID)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--mid", str(MID)])
