"""Clips on disk for the port's test_video (crfp_torch/tools/test_video.py):
its Pillow loader equals root ``test_video.py::load_clip`` (OpenCV)
exactly on synthetic REDS trees, the crops of 1080p-class frames
included, and the tool streams such a clip on the CPU from a checkpoint
directory of the port's manager."""

import importlib.util
import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(importlib.util.find_spec("cv2") is None,
                                reason="root test_video.py::load_clip reads with OpenCV")


def _write_tree(root, gt_hw, n_frames, seed=0, lr_hw=None, mode="RGB"):
    """A REDS clip 000 of the train set: smooth GT frames and their x8 box
    means as LR (or LR frames of ``lr_hw``, not tied to the GT)."""
    rng = np.random.default_rng(seed)
    sub = os.path.join("train", "train", "train_sharp", "000")
    gt_dir = os.path.join(root, "REDS_sharp", sub)
    lr_dir = os.path.join(root, "REDS_sharp_BI_x8", sub)
    os.makedirs(gt_dir)
    os.makedirs(lr_dir)
    h, w = gt_hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n_frames):
        f = rng.uniform(0.01, 0.08, (2, 3))
        gt = 127.5 + 120 * np.sin(yy[..., None] * f[0] + xx[..., None] * f[1] + i)
        gt = gt.astype(np.uint8)
        if lr_hw is None:
            lr = gt.reshape(h // 8, 8, w // 8, 8, 3).mean((1, 3)).round().astype(np.uint8)
        else:
            lr = rng.integers(0, 256, (*lr_hw, 3), np.uint8)
        img = PIL.Image.fromarray(gt)
        (img.convert(mode) if mode != "RGB" else img).save(
            os.path.join(gt_dir, f"{i:08d}.png"))
        PIL.Image.fromarray(lr).save(os.path.join(lr_dir, f"{i:08d}.png"))
    return os.path.join(root, "REDS_sharp"), gt_dir, lr_dir


@pytest.mark.parametrize("gt_hw,lr_hw,mode,n", [
    ((64, 96), None, "RGB", 3),
    ((64, 96), None, "RGBA", 2),
    ((1080, 1928), (136, 248), "RGB", 2),  # both crops cut
], ids=["small", "rgba", "crops"])
def test_load_clip_equals_root_loader(tmp_path, gt_hw, lr_hw, mode, n):
    import test_video as root_tool
    from crfp_torch.tools import test_video

    dataset_dir, gt_dir, lr_dir = _write_tree(str(tmp_path), gt_hw, n + 1, lr_hw=lr_hw,
                                              mode=mode)
    assert test_video.clip_dirs(dataset_dir, "train", 0) == (gt_dir, lr_dir)
    got = test_video.load_clip(gt_dir, lr_dir, n)
    want = root_tool.load_clip(gt_dir, lr_dir, n)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and g.dtype == w_.dtype == np.float32
        np.testing.assert_array_equal(g, w_)
    assert got[0].shape[0] == n and got[0].shape[1:3] == (min(gt_hw[0], 1072),
                                                         min(gt_hw[1], 1920))


def test_streams_a_clip_on_disk_from_a_checkpoint_directory(tmp_path):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.tools import test_video
    from crfp_torch.train.checkpoint import CheckpointManager
    from crfp_torch.train.loop import TrainConfig, make_optimizer

    dataset_dir, _, _ = _write_tree(str(tmp_path / "data"), (64, 64), 3)
    model = CRFP(ModelConfig(mid_channels=16), device="cpu", seed=3)
    ckpt = CheckpointManager(str(tmp_path / "model"))
    ckpt.save(7, model, make_optimizer(model, TrainConfig()))
    seen = []
    summary = test_video.main(
        ["--cpu", "--dataset_dir", dataset_dir, "--video_set", "train", "--video_num", "0",
         "--mid_channels", "16", "--model_path", str(tmp_path / "model" / "7"),
         "--n_frames", "3", "--fv_size", "16", "--sigma", "4",
         "--save_dir", str(tmp_path / "out")],
        on_frame=lambda v, i, sr: seen.append((v, i, tuple(sr.shape))))
    assert seen == [(0, i, (1, 64, 64, 3)) for i in range(3)]
    assert all(np.isfinite(v) for v in summary.values()), summary
    assert len(list((tmp_path / "out" / "000").glob("sr_*.png"))) == 3
