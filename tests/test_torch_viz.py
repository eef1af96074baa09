"""The port's training dashboard (crfp_torch/train/viz.py): the cases of
tests/test_viz.py (the full PNG set and the HTML viewer, the cadence, the
time-lapse copy, the discretized SSIM bands) on the port, and its PNGs
within 1 LSB of crfp_tpu.train.viz.TrainViz's from the same weights and
batch (CPU, f32)."""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

torch.set_num_threads(1)

B, T, H, W, S, MID = 1, 2, 8, 8, 8, 8
NAMES = ("sr", "gt", "fv", "absdiff", "psnr_map", "ssim_map", "ssim_map_discrete")


@pytest.fixture(scope="module")
def case():
    """(batch, JAX model, JAX params, the port's model on those weights)."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import from_jax
    from crfp_tpu.models.crfp import CRFP as JCRFP
    from crfp_tpu.models.crfp import ModelConfig as JConfig
    from tests.torch_parity import flat_params

    rng = np.random.default_rng(0)
    batch = {
        "lr": rng.uniform(0, 1, (B, T, H, W, 3)).astype(np.float32),
        "fv": rng.uniform(0, 1, (B, T, H * S, W * S, 3)).astype(np.float32),
        "hr": rng.uniform(0, 1, (B, T, H * S, W * S, 3)).astype(np.float32),
        "mk": (rng.uniform(0, 1, (B, T, H * S, W * S, 1)) > 0.5).astype(np.float32),
    }
    jmodel = JCRFP(JConfig(variant="v18", mid_channels=MID))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch["lr"], batch["fv"],
                                  batch["mk"])
    model = CRFP(ModelConfig(variant="v18", mid_channels=MID), device="cpu")
    model.load_state_dict(from_jax(flat_params(params)), strict=True)
    return batch, jmodel, params, model


def test_trainviz_dumps_frames_and_dashboard(tmp_path, case):
    from crfp_torch.train.viz import TrainViz

    batch, _, _, model = case
    viz = TrainViz(str(tmp_path), every=2)
    assert not viz.update(1, model, batch)   # off-cadence: no-op
    assert viz.update(2, model, batch)
    d = tmp_path / "viz"
    for n in NAMES:
        p = d / f"latest_{n}.png"
        assert p.exists() and p.stat().st_size > 0, n
    assert (d / "sr_iter0000002.png").exists()  # time-lapse copy
    html = (tmp_path / "dashboard.html").read_text()
    assert "metrics.jsonl" in html and "latest_" in html
    im = np.asarray(Image.open(d / "latest_sr.png"))
    assert im.shape == (H * S, W * S, 3) and im.dtype == np.uint8
    # the discretized ssim map holds only the reference's 0.1-step bands
    sd = np.unique(np.asarray(Image.open(d / "latest_ssim_map_discrete.png")))
    bands = {int(v * 255 + 0.5) for v in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)}
    assert set(sd.tolist()) <= bands, sd
    # the batch may also be tensors (the train step's own form)
    assert viz.update(4, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert (d / "sr_iter0000004.png").exists()


def test_trainviz_cli_flag_parses():
    from crfp_torch.config import parse_args

    assert parse_args(["--viz_every", "250"]).viz_every == 250
    assert parse_args([]).viz_every == 0


def test_trainviz_pngs_match_jax(tmp_path, case):
    from crfp_torch.train.viz import TrainViz
    from crfp_tpu.train.viz import TrainViz as JViz

    batch, jmodel, params, model = case
    assert JViz(jmodel, str(tmp_path / "jax"), every=3).update(3, params, batch)
    assert TrainViz(str(tmp_path / "port"), every=3).update(3, model, batch)
    for n in [f"latest_{n}" for n in NAMES] + ["sr_iter0000003"]:
        want = np.asarray(Image.open(tmp_path / "jax" / "viz" / f"{n}.png")).astype(int)
        got = np.asarray(Image.open(tmp_path / "port" / "viz" / f"{n}.png")).astype(int)
        assert got.shape == want.shape, n
        assert np.abs(got - want).max() <= 1, (n, np.abs(got - want).max())
    assert ((tmp_path / "jax" / "dashboard.html").read_text().replace("crfp_tpu", "crfp_torch")
            == (tmp_path / "port" / "dashboard.html").read_text())
