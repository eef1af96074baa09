"""The port's deployment quality gate (crfp_torch.bench.deploy_gate) on the
CPU at the JAX package's smoke size (tests/test_deploy_gate.py:
checkpoints/v18_mid16_procedural.npz, sigma 30, LR 24x32, 4 frames, mid
16): four rows in zone order, finite, |dPSNR| <= 0.05 dB, exact-vs-deploy
agreement >= 40 dB, with ``dcn_fused`` off and on; the EXACT side's zone
numbers against the JAX StreamingRunner + OnChipZoneEval on the same clip
and gaze (1e-3 dB, SSIM 1e-5). The JAX ``run_gate`` itself is not called:
it compiles two models and its own test is marked slow. Also the demo tool
``crfp_torch.tools.test_video`` on a generated 64x64 clip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CKPT = "checkpoints/v18_mid16_procedural.npz"
SMOKE = dict(sigmas=(30.0,), lr_hw=(24, 32), frames=4, mid_channels=16, skip=2)


@pytest.fixture(scope="module", params=[False, True], ids=["structured", "dcn_fused"])
def gate(request):
    from crfp_torch.bench.deploy_gate import run_gate

    return run_gate(CKPT, **SMOKE, dcn_fused=request.param, device="cpu")


def test_gate_smoke_budget(gate):
    rows, extras = gate
    assert [r.zone for r in rows] == ["whole", "fovea", "outskirt", "past"]
    for r in rows:
        assert r.sigma == 30.0
        for v in (r.exact_psnr, r.exact_ssim, r.deploy_psnr, r.deploy_ssim):
            assert np.isfinite(v), r
        assert abs(r.d_psnr) <= 0.05, (r.zone, r.d_psnr)
    assert extras["agree_db_min"] >= 40.0, extras
    assert len(extras["agree_db"]) == 1
    assert extras["exact_ms_per_frame"] > 0 and extras["deploy_ms_per_frame"] > 0


def test_gate_table_and_cli(gate, capsys):
    from crfp_torch.bench import deploy_gate

    table = deploy_gate.format_table(gate[0])
    assert table.count("\n") == 5 and "| 30 | past |" in table
    deploy_gate.main(["--cpu", "--ckpt", CKPT, "--mid", "16", "--frames", "3",
                      "--lr_hw", "16", "24", "--sigmas", "20", "--dcn_fused"])
    out = capsys.readouterr().out
    assert "worst per-zone |dPSNR|" in out and "| 20 | whole |" in out


def test_gate_exact_side_matches_jax_runner_and_zone_eval(gate):
    """The same clip, gaze and checkpoint through the JAX StreamingRunner
    (f32, no windows) and the JAX OnChipZoneEval."""
    from crfp_tpu.eval.zones import OnChipZoneEval, zone_masks_step
    from crfp_tpu.models.crfp import CRFP, ModelConfig
    from crfp_tpu.models.streaming import StreamingRunner
    from crfp_tpu.tools.train_procedural import load_params
    from crfp_torch.bench.deploy_gate import FV_SIZE, gate_clip

    rows, _ = gate
    h, w = SMOKE["lr_hw"]
    frames, skip = SMOKE["frames"], SMOKE["skip"]
    lr, hr, gaze = gate_clip(np.random.default_rng(42), 30.0, (h, w), frames)
    runner = StreamingRunner(CRFP(ModelConfig(variant="v18", mid_channels=16)),
                             load_params(CKPT), donate=False)
    ev = OnChipZoneEval(FV_SIZE)
    for i in range(frames):
        z = zone_masks_step(h * 8, w * 8, tuple(gaze[i]), FV_SIZE)
        out = np.clip(np.asarray(runner(jnp.asarray(lr[i][None]), jnp.asarray(hr[i][None]),
                                        jnp.asarray(z.mask[None]))), 0, 1)
        ev.update(jnp.asarray(out), jnp.asarray(hr[i][None]), z)
    for r in rows:
        s0 = max(skip - 1, 0) if r.zone == "past" else skip
        want_p = float(np.mean(ev.results[f"psnr_{r.zone}"][s0:]))
        want_s = float(np.mean(ev.results[f"ssim_{r.zone}"][s0:]))
        assert abs(r.exact_psnr - want_p) <= 1e-3, (r.zone, r.exact_psnr, want_p)
        assert abs(r.exact_ssim - want_s) <= 1e-5, (r.zone, r.exact_ssim, want_s)


@pytest.mark.parametrize("regional", [False, True], ids=["whole_frame", "regional_dcn"])
def test_test_video_procedural_demo(tmp_path, regional):
    from crfp_torch.tools import test_video

    argv = ["--cpu", "--procedural", "--procedural_hw", "64", "64", "--n_frames", "3",
            "--video_num", "0", "--mid_channels", "16", "--model_path", CKPT,
            "--fv_size", "16", "--sigma", "8", "--save_dir", str(tmp_path),
            "--save_gif", "--heatmaps"]
    if regional:
        argv += ["--regional_dcn", "--dcn_size", "32"]
    summary = test_video.main(argv)
    assert set(summary) == {f"{m}_{z}" for m in ("psnr", "ssim")
                            for z in ("whole", "fovea", "outskirt", "past")}
    assert all(np.isfinite(v) for v in summary.values()), summary
    assert len(list((tmp_path / "000").glob("sr_*.png"))) == 3
    for name in ("sr", "bicubic", "gt", "psnr_heat"):
        assert (tmp_path / f"{name}_000.gif").stat().st_size > 0
    # y_only and every variant are ported: a y_only demo on seeded weights
    # (its Y beside the bicubic LR's UV), and hr_dcn=False refused for v18
    # as the JAX trunk refuses it
    small = ["--cpu", "--procedural", "--procedural_hw", "64", "64", "--n_frames", "2",
             "--video_num", "0", "--mid_channels", "16", "--fv_size", "16",
             "--save_dir", str(tmp_path / "y_only")]
    summary = test_video.main(small + ["--y_only"])
    assert all(np.isfinite(v) for v in summary.values()), summary
    with pytest.raises(ValueError, match="hr_dcn"):
        test_video.main(small + ["--hr_dcn", "false"])
    # without --procedural the clips are REDS frames on disk: none here
    with pytest.raises(FileNotFoundError):
        test_video.main(["--cpu", "--dataset_dir", str(tmp_path)])
