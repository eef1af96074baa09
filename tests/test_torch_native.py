"""The port's host preprocessing library (crfp_torch/native, built with g++
into crfp_torch/build/) against the JAX package's library, byte for byte,
on its three entry points, and against Pillow/numpy as
tests/test_native.py holds the JAX one. Skipped without g++.

The JAX library is built privately for this module
(``torch_parity.jax_native_oracle``): the JAX package's own in-place build
can be half-written when several test workers build it at once."""

import os
import shutil
import sys

import numpy as np
import PIL.Image
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    from crfp_torch import native
    from torch_parity import jax_native_oracle

    jnative = jax_native_oracle(tmp_path_factory.mktemp("jax_native"))
    assert native.native_available()
    return native, jnative


def test_library_builds_into_the_port_build_dir(libs):
    from crfp_torch.native import bindings

    path = bindings.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent.name == "crfp_torch"


@pytest.mark.parametrize("dh,dw", [(32, 48), (128, 192), (17, 31), (64, 96)])
def test_bicubic_equals_jax_library_and_matches_pil(libs, dh, dw):
    native, jnative = libs
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (2, 64, 96, 3), np.uint8)
    got = native.resize_bicubic_u8(src, dh, dw)
    np.testing.assert_array_equal(got, jnative.resize_bicubic_u8(src, dh, dw))
    np.testing.assert_array_equal(native.resize_bicubic_u8(src, dh, dw, nthreads=2), got)
    for f in range(2):
        want = np.array(PIL.Image.fromarray(src[f]).resize((dw, dh), PIL.Image.BICUBIC))
        diff = np.abs(got[f].astype(int) - want.astype(int))
        # Pillow uses 8-bit fixed-point tap weights, the library doubles:
        # up to 1 LSB apart on a minority of pixels
        assert diff.max() <= 1, (dh, dw, diff.max())
        assert (diff > 0).mean() < 0.2


@pytest.mark.parametrize("hflip,vflip", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_crop_normalize_flip_equals_jax_library_and_numpy(libs, hflip, vflip):
    native, jnative = libs
    src = np.random.default_rng(1).integers(0, 256, (3, 20, 24, 3), np.uint8)
    got = native.crop_normalize_flip_f32(src, 2, 3, 10, 12, hflip=hflip, vflip=vflip)
    want_lib = jnative.crop_normalize_flip_f32(src, 2, 3, 10, 12, hflip=hflip, vflip=vflip)
    assert got.tobytes() == want_lib.tobytes()
    want = src[:, 2:12, 3:15].astype(np.float32) / 255.0
    if hflip:
        want = want[:, :, ::-1]
    if vflip:
        want = want[:, ::-1]
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    with pytest.raises(ValueError, match="outside"):
        native.crop_normalize_flip_f32(src, 15, 3, 10, 12)


@pytest.mark.parametrize("method", ["Evenscan", "Hscan"])
def test_fill_fovea_equals_jax_library_and_generator(libs, method):
    from crfp_torch.data.fovea import fovea_generator

    native, jnative = libs
    gt = np.random.default_rng(2).uniform(0, 1, (5, 64, 64, 3)).astype(np.float32)
    fv_ref, mk_ref, coords = fovea_generator(gt, method=method, fv_hw=(16, 16))
    fv, mk = native.fill_fovea_f32(gt, coords.astype(np.int32), 16, 16)
    jfv, jmk = jnative.fill_fovea_f32(gt, coords.astype(np.int32), 16, 16)
    assert fv.tobytes() == jfv.tobytes() and mk.tobytes() == jmk.tobytes()
    np.testing.assert_array_equal(fv, fv_ref)
    np.testing.assert_array_equal(mk, mk_ref)
