"""Every variant of the port's trunk streamed frame by frame, on the CPU,
f32, on a smooth moving 3-frame clip (LR 8x12) with a wandering gaze: the
port's ``StreamingRunner`` against its own batch forward to 2e-5 (the JAX
package's bound for the same pair, tests/test_models.py:39-53) and against
JAX's ``StreamingRunner`` with and without the regional gate ``fg`` to
1e-4 (mid 16, windows 8/32, random heads); the two trained mid-32
checkpoints of ``no_dcn`` and ``basic_fvsr``, loaded strictly, against the
JAX trunk to 1e-4; the ``y_only`` evaluation against the JAX evaluator,
with ``LR_sr`` from the port's ``clip_sample``, itself equal to the JAX
procedural datasets' sample; and ``train_procedural --variant basic_fvsr``,
which must build the trunk without the HR-level cascade."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402
from test_torch_variants import CASES, _IDS, WIN, leaves  # noqa: E402

torch.set_num_threads(1)

MID, T, H, W, S = 16, 3, 8, 12, 8
_ROOT = Path(__file__).resolve().parents[1]
CKPTS = {"no_dcn": "checkpoints/no_dcn_mid32_struct.npz",
         "basic_fvsr": "checkpoints/basic_fvsr_mid32_struct.npz"}


def _clip(seed=0):
    """lr (T, 1, h, w, 3), fv = hr * mk (T, 1, 8h, 8w, 3), mk and fg (T, 1,
    8h, 8w, 1), and hr (T, 1, 8h, 8w, 3): a smooth plane moving a few
    pixels a frame, the gaze wandering around the centre."""
    from crfp_torch.eval.zones import zone_masks_step

    rng = np.random.default_rng(seed)
    hh, hw = H * S, W * S
    yy, xx = np.mgrid[0:hh, 0:hw].astype(np.float32)
    fr = rng.uniform(-0.15, 0.15, (2, 3)).astype(np.float32)
    ph = rng.uniform(0, 6.3, (3,)).astype(np.float32)
    hr = np.stack([0.5 + 0.4 * np.sin((yy[..., None] + 3.0 * t) * fr[0]
                                      + (xx[..., None] + 5.0 * t) * fr[1] + ph)
                   for t in range(T)]).astype(np.float32)
    lr = hr.reshape(T, H, S, W, S, 3).mean((2, 4))
    zones = [zone_masks_step(hh, hw, (hh / 2 + 8 * rng.standard_normal(),
                                      hw / 2 + 12 * rng.standard_normal()),
                             24, regional_dcn=True, dcn_size=48) for _ in range(T)]
    mk = np.stack([z.mask for z in zones])
    fg = np.stack([z.fg for z in zones])
    return tuple(a[:, None] for a in (lr, hr * mk, mk, fg, hr))


@pytest.fixture(scope="module")
def clip():
    return _clip()


def _torch_model(flat, fields, mid=MID, **cfg):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax

    model = CRFP(ModelConfig(mid_channels=mid, **fields, **cfg), device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    return model.eval()


def _jax_model(fields, mid=MID, **cfg):
    from crfp_tpu.models.crfp import CRFP, ModelConfig

    return CRFP(ModelConfig(mid_channels=mid, **fields, **cfg))


def _stream(runner, clip, use_fg):
    lr, fv, mk, fg, _ = clip
    runner.clear_states()
    return [np.asarray(runner(lr[i], fv[i], mk[i], fg[i] if use_fg else None))
            for i in range(T)]


def _out_shape(fields):
    return (1, H * S, W * S, 1 if fields.get("y_only") else 3)


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_streaming_equals_batch(case, clip):
    from crfp_torch.models.streaming import StreamingRunner

    _, fields = case
    model = _torch_model(leaves(case), fields, **WIN)
    lr, fv, mk, _, _ = clip
    with torch.no_grad():
        batch = model(*(torch.from_numpy(a.transpose(1, 0, 2, 3, 4)) for a in (lr, fv, mk)))
    frames = _stream(StreamingRunner(model), clip, use_fg=False)
    for i, f in enumerate(frames):
        assert f.shape == _out_shape(fields)
        np.testing.assert_allclose(f, batch[:, i].numpy(), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_streaming_matches_jax_runner_with_and_without_fg(case, clip):
    """basic_fvsr ignores ``fg`` (both packages), so its two runs agree too."""
    from crfp_tpu.models.streaming import StreamingRunner as JRunner
    from crfp_torch.models.streaming import StreamingRunner

    _, fields = case
    flat = leaves(case)
    model = _torch_model(flat, fields, **WIN)
    jm = _jax_model(fields, **WIN)
    outs = {}
    for use_fg in (False, True):
        jr = JRunner(jm, tp.unflatten(flat), use_fg=use_fg, donate=False)
        want = _stream(jr, tuple(map(jnp.asarray, clip)), use_fg)
        got = _stream(StreamingRunner(model, use_fg=use_fg), clip, use_fg)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape == _out_shape(fields)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=f"fg {use_fg} frame {i}")
        outs[use_fg] = got
    # the gate changes the steady frames of every variant but basic_fvsr
    moved = float(np.abs(outs[True][-1] - outs[False][-1]).max())
    assert (moved == 0.0) == (fields["variant"] == "basic_fvsr"), moved


@pytest.mark.parametrize("variant", sorted(CKPTS))
def test_trained_checkpoint_loads_strictly_and_matches_jax(variant, clip):
    """The trained mid-32 weights at their recipe's windows 8/32 (the
    checkpoints' _curve.json): the JAX batch trunk and the port's, and the
    port's stream of the same clip."""
    from crfp_torch.models.streaming import StreamingRunner
    from crfp_torch.params import load_npz

    flat = load_npz(str(_ROOT / CKPTS[variant]))
    fields = dict(variant=variant, hr_dcn=False)
    model = _torch_model(flat, fields, mid=32, **WIN)
    assert len(model.state_dict()) == len(flat) == {"no_dcn": 86, "basic_fvsr": 128}[variant]
    lr, fv, mk, _, _ = clip
    args = [a.transpose(1, 0, 2, 3, 4) for a in (lr, fv, mk)]
    want = np.asarray(jax.jit(_jax_model(fields, mid=32, **WIN).apply)(
        tp.unflatten(flat), *map(jnp.asarray, args)))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape == (1, T, H * S, W * S, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    frames = _stream(StreamingRunner(model), clip, use_fg=False)
    np.testing.assert_allclose(np.stack(frames, 1), want, rtol=0, atol=1e-4)


def test_clip_sample_equals_jax_dataset_sample():
    """``clip_sample`` is the JAX EvalSet's sample of the same clip, with
    LR_sr only for y_only."""
    from types import SimpleNamespace

    from crfp_tpu.data.procedural import EvalSet
    from crfp_torch.data.procedural import clip_sample, make_clip

    args = SimpleNamespace(scale=S, GT_size=64, FV_size=16, N_frames=3)
    want = EvalSet(args)[1]
    hr = make_clip(np.random.default_rng(EvalSet.seed_base + 1), 3, 64, S)
    got = clip_sample(hr, 16, EvalSet.scan, y_only=True)
    assert sorted(got) == sorted(k for k in want if k != "FV_sp")
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert "LR_sr" not in clip_sample(hr, 16, EvalSet.scan)


def test_y_only_evaluation_matches_jax(tmp_path):
    """Two batches of a y_only v18 trunk through both evaluators: the
    model's Y beside the UV of LR_sr; batch 0 drops its first frame."""
    from crfp_tpu.eval.evaluator import evaluate_clips as jeval
    from crfp_torch.data.procedural import clip_sample, make_clip
    from crfp_torch.eval.evaluator import evaluate_clips as teval

    case = next(c for c in CASES if c[0] == "v18_y_only")
    fields = case[1]
    loader = []
    for i in range(2):
        hr = make_clip(np.random.default_rng(10 + i), T, 64, S)
        sample = clip_sample(hr, 16, "Evenscan", y_only=True)
        loader.append({k: v[None] for k, v in sample.items()})
    flat = leaves(case)
    want = jeval(_jax_model(fields, **WIN), tp.unflatten(flat), loader, y_only=True)
    got = teval(_torch_model(flat, fields, **WIN), loader, y_only=True,
                save_dir=str(tmp_path / "sr"))
    assert got.n_frames == want.n_frames == 2 * T - 1
    np.testing.assert_allclose(got.psnr, want.psnr, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.psnr_y, want.psnr_y, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.ssim, want.ssim, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.ssim_y, want.ssim_y, atol=1e-5, rtol=0)
    assert len(list((tmp_path / "sr").glob("sr_*.png"))) == 2 * T


def test_train_procedural_basic_fvsr_runs_without_the_hr_cascade(tmp_path, monkeypatch):
    """Two CPU steps of ``--variant basic_fvsr``: the saved weights have the
    trained checkpoint's leaves (a per-tap dcn_3, no downsample) and load
    strictly into the hr_dcn=False trunk."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax, load_npz
    from crfp_torch.tools import train_procedural

    assert not train_procedural.variant_hr_dcn("basic_fvsr")
    assert not train_procedural.variant_hr_dcn("no_dcn")
    assert train_procedural.variant_hr_dcn("v13")
    ref = load_npz(str(_ROOT / CKPTS["basic_fvsr"]))
    monkeypatch.chdir(tmp_path)  # the clip-pool cache goes under runs/ here
    save = str(tmp_path / "basic.npz")
    train_procedural.main(["--cpu", "--variant", "basic_fvsr", "--iters", "2", "--b", "1",
                           "--t", "3", "--gt", "64", "--mid", str(MID), "--pool", "2",
                           "--flow_freeze", "0", "--save", save])
    flat = load_npz(save)
    assert sorted(flat) == sorted(ref)
    assert flat["params/dcn_3/dcn_offset/conv/kernel"].shape == (3, 3, MID, 8 * 9 * 2)
    model = CRFP(ModelConfig(variant="basic_fvsr", hr_dcn=False, mid_channels=MID),
                 device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
