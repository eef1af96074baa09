"""The window-quality harnesses of the port (crfp_torch/bench/quality_window.py,
crfp_torch/bench/quality_trained.py) against the JAX package's on the CPU,
f32, at lr (16, 24), mid 8, velocities (1, 6), window 8, 3 frames.

Both packages run the same weights: the port's seeded init (zero offset
heads, as the JAX init has), handed to JAX's ``run_window_quality`` in
place of its own ``init`` (a JAX ``init`` of the trunk takes ~45 s here),
and for ``run_trained_quality`` that init with random offset/mask heads and
DCN weights, written with ``params.save_npz`` (the file both load). Every
PSNR below 99 agrees within 0.01 dB, and the port gives 99 wherever JAX
does. ``anchor=True`` raises, and so does a run without a card unless it
asks for the CPU."""

import sys

import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

SMALL = dict(velocities=(1.0, 6.0), windows=(8,), lr_hw=(16, 24), frames=3, mid_channels=8)


def _seeded_state(seed=0):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP

    return CRFP(ModelConfig(variant="v18", mid_channels=8), device="cpu", seed=seed).state_dict()


def _agree(got, want, keys):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.v_px, g.window) == (w.v_px, w.window)
        for k in keys:
            a, b = getattr(g, k), getattr(w, k)
            if b >= 99.0:
                assert a == 99.0, (k, g, w)
            else:
                assert abs(a - b) <= 0.01, (k, g, w)


def test_window_quality_matches_jax(monkeypatch):
    import crfp_tpu.bench.quality_window as jq

    from crfp_torch.bench.quality_window import run_window_quality
    from crfp_torch.params import to_jax

    sd = _seeded_state()
    params = tp.unflatten(to_jax(sd))

    class SeededCRFP(jq.CRFP):
        """JAX's trunk, initialised with the port's seeded weights."""

        def init(self, *args, **kwargs):
            return params

    monkeypatch.setattr(jq, "CRFP", SeededCRFP)
    want = jq.run_window_quality(**SMALL)
    got = run_window_quality(**SMALL, state_dict=sd, device="cpu")
    _agree(got, want, ["psnr_db"])
    # within the window the two paths agree; 6 px a frame (12 at the
    # trunk) crosses D = 8
    assert got[0].psnr_db >= 80.0 and got[1].psnr_db < 80.0, got


def test_trained_quality_matches_jax(tmp_path):
    from crfp_tpu.bench.quality_trained import run_trained_quality as jax_run

    from crfp_torch.bench.quality_trained import run_trained_quality
    from crfp_torch.params import from_jax, save_npz, to_jax

    sd = from_jax(tp.perturb_heads(to_jax(_seeded_state(seed=4)), seed=1))
    ckpt = str(tmp_path / "v18_mid8.npz")
    save_npz(sd, ckpt)
    want = jax_run(ckpt, **SMALL)
    got = run_trained_quality(ckpt, **SMALL, device="cpu")
    _agree(got, want, ["agree_db", "exact_db", "win_db"])
    assert all(np.isfinite([r.agree_db, r.exact_db, r.win_db]).all() for r in got)


def test_anchor_and_missing_card_raise(tmp_path):
    from crfp_torch.bench.quality_trained import run_trained_quality
    from crfp_torch.bench.quality_window import main, run_window_quality

    with pytest.raises(ValueError, match="anchored windows"):
        run_window_quality(**SMALL, anchor=True, device="cpu")
    with pytest.raises(ValueError, match="anchored windows"):
        main(["--anchor", "--cpu"])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_window_quality(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_trained_quality(str(tmp_path / "unused.npz"), **SMALL)
