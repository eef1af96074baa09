"""The port's data path against the JAX package's on the same synthetic
trees and seeds (CPU): every reader (REDS, Vimeo, procedural; TrainSet
with and without ``minimal``, EvalSet, TestSet) gives the same samples,
atol 0, on both preprocess paths (the native library and Pillow, forced
in both packages by patching ``native_available``); the Loader yields
the same batches in the same order; the frame cache gives the bytes of
the plain read in the JAX cache's file layout; crop-then-resize equals
resize-then-crop."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.test_data import _make_fake_reds  # noqa: E402
from tests.test_vimeo import _make_fake_vimeo  # noqa: E402

PATHS = ["native", "pillow"]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native bindings on a private build of its library
    (``torch_parity.jax_native_oracle``): its in-place build can be
    half-written when several test workers build it at once."""
    from tests.torch_parity import jax_native_oracle

    return jax_native_oracle(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """The preprocess path both packages take. On the native path the JAX
    reader's ``crfp_tpu.native`` (crfp_tpu/data/reds.py:56) takes the
    private oracle's entry points for the test's duration."""
    import crfp_torch.native
    import crfp_tpu.native

    if request.param == "pillow":
        monkeypatch.setattr(crfp_tpu.native, "native_available", lambda: False)
        monkeypatch.setattr(crfp_torch.native, "native_available", lambda: False)
    elif not crfp_torch.native.native_available():
        pytest.skip("no C++ toolchain: the native library does not build")
    else:
        oracle = request.getfixturevalue("jax_native")
        for name in crfp_tpu.native.__all__:
            monkeypatch.setattr(crfp_tpu.native, name, getattr(oracle, name))
    from crfp_torch.data.reds import preprocess_path

    assert preprocess_path() == request.param
    return request.param


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    _make_fake_reds(str(root), n_frames=4, gt_hw=(96, 128))
    _make_fake_vimeo(str(root / "vimeo"), n_seqs=3, hw=(64, 96))
    return root


def _args(trees, dataset, **kw):
    base = dict(scale=8, FV_size=16, y_only=False, frame_cache=None, procedural_clips=3,
                batch_size=2, num_workers=1, dataset=dataset)
    if dataset == "reds":
        base.update(GT_size=64, N_frames=2, dataset_dir=str(trees / "REDS_sharp"))
    elif dataset == "vimeo":
        base.update(GT_size=32, N_frames=7, dataset_dir=str(trees / "vimeo"))
    else:
        base.update(GT_size=32, N_frames=2)
    base.update(kw)
    return SimpleNamespace(**base)


def _modules(dataset):
    if dataset == "reds":
        from crfp_torch.data import reds as t
        from crfp_tpu.data import reds as j
    elif dataset == "vimeo":
        from crfp_torch.data import vimeo as t
        from crfp_tpu.data import vimeo as j
    else:
        from crfp_torch.data import procedural as t
        from crfp_tpu.data import procedural as j
    return j, t


def _assert_samples_equal(got, want, tag):
    assert sorted(got) == sorted(want), (tag, sorted(got), sorted(want))
    for k in want:
        assert got[k].dtype == want[k].dtype, (tag, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{tag} {k}")


@pytest.mark.parametrize("dataset", ["reds", "vimeo", "procedural"])
@pytest.mark.parametrize("split", ["train", "train_minimal", "eval", "test"])
def test_reader_equals_jax(trees, path, dataset, split):
    j, t = _modules(dataset)
    args = _args(trees, dataset)
    if split.startswith("train"):
        minimal = split == "train_minimal"
        want_ds = j.TrainSet(args, rng=np.random.default_rng(5), minimal=minimal)
        got_ds = t.TrainSet(args, rng=np.random.default_rng(5), minimal=minimal)
    else:
        cls = "EvalSet" if split == "eval" else "TestSet"
        want_ds, got_ds = getattr(j, cls)(args), getattr(t, cls)(args)
    assert len(got_ds) == len(want_ds) > 0
    # every item, twice over for the train sets: the crops, fovea scans
    # and flips draw from the shared rng in order
    for i in list(range(len(want_ds))) * (2 if split.startswith("train") else 1):
        _assert_samples_equal(got_ds[i], want_ds[i], f"{dataset} {split} {path} [{i}]")


@pytest.mark.parametrize("y_only", [False, True], ids=["rgb", "y_only"])
def test_reds_train_minimal_keeps_lr_sr_for_y_only(trees, y_only):
    _, t = _modules("reds")
    args = _args(trees, "reds", y_only=y_only)
    sample = t.TrainSet(args, rng=np.random.default_rng(0), minimal=True)[0]
    assert ("LR_sr" in sample) == y_only
    assert ("Ref" in sample) == y_only


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_equals_jax(trees, drop_last):
    from crfp_torch.data.loader import Loader as TLoader
    from crfp_tpu.data.loader import Loader as JLoader

    j, t = _modules("reds")
    args = _args(trees, "reds")
    kw = dict(batch_size=2, shuffle=True, num_workers=1, drop_last=drop_last, seed=3)
    want = list(JLoader(j.TrainSet(args, rng=np.random.default_rng(1)), **kw))
    got = list(TLoader(t.TrainSet(args, rng=np.random.default_rng(1)), **kw))
    n = len(t.TrainSet(args))
    assert len(got) == len(want) == (n // 2 if drop_last else -(-n // 2))
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_samples_equal(g, w, f"batch {i}")


@pytest.mark.parametrize("dataset", ["reds", "vimeo", "procedural"])
def test_get_dataloader_fixed_splits_equal_jax(trees, dataset):
    """The eval and test loaders of ``get_dataloader`` (Evenscan/Hscan, no
    rng) give the JAX loaders' batches; the train loader is shuffled at the
    batch size and drops the last partial batch."""
    from crfp_torch.data.loader import get_dataloader as tget
    from crfp_tpu.data.loader import get_dataloader as jget

    args = _args(trees, dataset)
    args.dataset = {"reds": "Reds", "vimeo": "vimeo7"}.get(dataset, dataset)
    want, got = jget(args), tget(args)
    assert got["train"].shuffle and got["train"].drop_last
    assert got["train"].batch_size == args.batch_size
    assert len(got["train"]) == len(want["train"])
    for split in ("eval", "test"):
        w, g = list(want[split]), list(got[split])
        assert len(g) == len(w) > 0
        for i, (gb, wb) in enumerate(zip(g, w)):
            _assert_samples_equal(gb, wb, f"{dataset} {split} batch {i}")


def test_process_loader_equals_thread_loader(trees):
    """``processes=True`` (spawned workers) yields the thread pool's batches."""
    from crfp_torch.data.loader import Loader

    _, t = _modules("reds")
    ds = t.EvalSet(_args(trees, "reds"))
    threads = list(Loader(ds, batch_size=2, num_workers=2))
    procs = list(Loader(ds, batch_size=2, num_workers=2, processes=True))
    assert len(procs) == len(threads) > 0
    for i, (p, w) in enumerate(zip(procs, threads)):
        _assert_samples_equal(p, w, f"batch {i}")


def test_loader_reraises_a_reader_error_and_stops_when_abandoned():
    from crfp_torch.data.loader import Loader

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("frame 2")
            return {"x": np.full((1,), i, np.float32)}

    it = iter(Loader(Broken(), batch_size=2, num_workers=1))
    assert next(it)["x"].tolist() == [[0.0], [1.0]]
    with pytest.raises(KeyError, match="frame 2"):
        next(it)
    # a consumer that stops after one batch leaves no producer behind
    import threading

    before = threading.active_count()
    for _ in Loader(Broken(), batch_size=1, num_workers=1, prefetch=1):
        break
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_frame_cache_equals_plain_read_and_jax_layout(trees, tmp_path):
    from crfp_torch.data.cache import FrameCache
    from crfp_tpu.data.cache import FrameCache as JCache

    _, t = _modules("reds")
    args = _args(trees, "reds")
    plain = t.TrainSet(args, rng=np.random.default_rng(7))
    cached = t.TrainSet(_args(trees, "reds", frame_cache=str(tmp_path / "t")),
                        rng=np.random.default_rng(7))
    for i in (0, 3, 0):
        _assert_samples_equal(cached[i], plain[i], f"cached [{i}]")

    files = plain.gt_windows[1]
    import PIL.Image

    want = np.stack([np.array(PIL.Image.open(f)) for f in files])
    tc, jc = FrameCache(str(tmp_path / "t2")), JCache(str(tmp_path / "j2"))
    np.testing.assert_array_equal(tc.load_window(files), want)
    np.testing.assert_array_equal(tc.load_window(files, (3, 40, 5, 70)),
                                  want[:, 3:40, 5:70])
    assert tc.frame_shape(files[0]) == want.shape[1:]
    jc.load_window(files)
    # the same key and file layout as the JAX cache: either package reads
    # the other's files
    assert sorted(os.listdir(tmp_path / "t2")) == sorted(os.listdir(tmp_path / "j2"))
    for name in os.listdir(tmp_path / "t2"):
        a = (tmp_path / "t2" / name).read_bytes()
        assert a == (tmp_path / "j2" / name).read_bytes(), name
    # memmaps and locks do not cross process boundaries: a pickled cache
    # re-opens its files
    import pickle

    again = pickle.loads(pickle.dumps(tc))
    np.testing.assert_array_equal(again.load_window(files), want)


def test_bicubic_x8_cropped_equals_resize_then_crop(path):
    from crfp_torch.data.reds import _bicubic_upsample, _bicubic_x8_cropped
    from crfp_tpu.data.reds import _bicubic_upsample as jup

    rng = np.random.default_rng(0)
    lr_win = rng.integers(0, 256, (2, 24, 40, 3), np.uint8)
    scale, lr_size = 8, 8
    full = _bicubic_upsample(lr_win, 24 * scale, 40 * scale)
    np.testing.assert_array_equal(full, jup(lr_win, 24 * scale, 40 * scale))
    for rnd_h, rnd_w in [(0, 0), (3, 7), (16, 32), (5, 0), (0, 29)]:
        want = full[:, rnd_h * scale : (rnd_h + lr_size) * scale,
                    rnd_w * scale : (rnd_w + lr_size) * scale]
        got = _bicubic_x8_cropped(lr_win, rnd_h, rnd_w, lr_size, scale)
        np.testing.assert_array_equal(got, want, err_msg=f"crop ({rnd_h},{rnd_w})")


def test_gaussian_downsample_equals_jax():
    from crfp_torch.data.vimeo import gaussian_downsample
    from crfp_tpu.data.vimeo import gaussian_downsample as jgd

    x = np.random.default_rng(2).uniform(0, 1, (2, 33, 41, 3)).astype(np.float32)
    for scale in (2, 3, 4):
        np.testing.assert_array_equal(gaussian_downsample(x, scale), jgd(x, scale))
