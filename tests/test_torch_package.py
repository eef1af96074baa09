"""crfp_torch package rules: no JAX in the port, dispatchers that take the
plain version only for CPU tensors, a build that raises instead of falling
back, and (on a card only, marker ``cuda``) every kernel against its plain
version."""

import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

_ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "crfp_tpu")


def _port_files():
    files = sorted((_ROOT / "crfp_torch").rglob("*.py"))
    files.append(_ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_no_jax():
    files = _port_files()
    assert (_ROOT / "chip_smoke.py").exists()
    assert len(files) > 15, files
    # the training and evaluation slices' modules are scanned too
    for rel in ("models/crfp.py", "train/loop.py", "train/schedule.py", "ops/metrics.py",
                "ops/color.py", "ops/cuda/ssim.py", "data/fovea.py", "data/procedural.py",
                "tools/train_procedural.py", "bench/train.py", "models/streaming.py",
                "ops/cuda/dcn_fused.py", "eval/__init__.py", "eval/zones.py",
                "eval/foveated.py", "eval/matlab_metrics.py", "eval/evaluator.py",
                "bench/deploy_gate.py", "tools/test_video.py", "models/config.py",
                "nn/lte.py", "nn/align.py", "nn/flow.py", "nn/pcd.py", "models/runtime.py",
                "models/pyramid.py", "eval/flow_warp_eval.py", "ops/warp.py",
                # the entry point and its host data path
                "main.py", "config.py", "data/loader.py", "data/reds.py", "data/vimeo.py",
                "data/cache.py", "native/__init__.py", "native/bindings.py",
                "train/checkpoint.py", "train/viz.py", "utils/__init__.py",
                "utils/logging.py", "utils/params_io.py",
                # the tools and benches
                "tools/convert_torch.py", "tools/test_runtime.py", "tools/bench.py",
                "tools/video.py", "bench/__init__.py", "bench/runtime.py",
                "bench/profile.py", "bench/capability.py", "bench/quality_window.py",
                "bench/quality_trained.py", "bench/trace_table.py"):
        assert _ROOT / "crfp_torch" / rel in files, rel
    bad = {str(f.relative_to(_ROOT)): sorted(_imported_roots(f) & set(_FORBIDDEN))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}, bad


def test_port_and_chip_smoke_helpers_load_no_jax():
    """What the AST scan cannot see: a module the port or chip_smoke.py loads
    at run time that imports JAX itself. In a fresh interpreter, import every
    module of the port and chip_smoke.py, and write a v18 trunk under the
    reference's names as phase 11 does; no JAX module may have been loaded."""
    import subprocess
    import sys

    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(_ROOT)!r})
import chip_smoke, crfp_torch
for m in pkgutil.walk_packages(crfp_torch.__path__, "crfp_torch."):
    importlib.import_module(m.name)
from crfp_torch.models.config import ModelConfig
from crfp_torch.models.crfp import CRFP
from crfp_torch.params import convert_state_dict
sd = CRFP(ModelConfig(mid_channels=8), device="cpu").state_dict()
back = convert_state_dict(chip_smoke._reference_named(sd)["state_dict"])
assert back.keys() == sd.keys() and all(back[k].equal(sd[k]) for k in sd)
print(sorted(m for m in sys.modules if m.split(".")[0] in {_FORBIDDEN!r}))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout[-2000:]


def _dcn_args(shared: bool):
    g, k2 = (1, 9) if shared else (2, 9)
    taps = 1 if shared else k2
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 6, 7, generator=gen)
    off = torch.randn(1, g * taps * 2, 6, 7, generator=gen) * 3
    mask = torch.rand(1, g * taps, 6, 7, generator=gen)
    w = torch.randn(4, 4, 3, 3, generator=gen)
    b = torch.randn(4, generator=gen)
    return x, off, mask, w, b


@pytest.mark.parametrize("shared", [False, True], ids=["per_tap", "shared"])
def test_dcn_dispatcher_takes_plain_version_on_cpu(shared):
    from crfp_torch.ops.cuda import dcn
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    args = _dcn_args(shared)
    before = dcn.launches
    kw = dict(max_displacement=2, shared_taps=shared, shared_mask=shared)
    got = dcn.deform_conv2d_windowed(*args, **kw)
    assert torch.equal(got, deform_conv2d_windowed_ref(*args, **kw))
    assert dcn.launches == before


def test_warp_and_emit_dispatchers_take_plain_version_on_cpu():
    from crfp_torch.ops.cuda import emit, warp
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 3, 8, 9, generator=gen)
    flow = torch.randn(1, 2, 8, 9, generator=gen) * 4
    before = (warp.launches, emit.launches)
    assert torch.equal(warp.flow_warp_windowed(x, flow, 2),
                       flow_warp_windowed_ref(x, flow, 2))
    y = torch.randn(1, 48, 2, 3, generator=gen)
    lr = torch.rand(1, 3, 1, 1, generator=gen)
    frame = emit.emit_frame(y, lr, r=4)
    assert frame.shape == (1, 8, 12, 3)
    assert torch.equal(frame, emit.emit_frame_ref(y, lr, r=4))
    assert (warp.launches, emit.launches) == before


def _launch_counts():
    from crfp_torch.ops.cuda import dcn, dcn_fused, emit, ssim, warp

    return (dcn.launches, dcn.bwd_launches, warp.launches, warp.bwd_launches,
            emit.launches, dcn_fused.launches, ssim.launches)


def _run_model(name):
    """One small call of a model of the models slice on CPU tensors."""
    from crfp_torch.models.config import ModelConfig

    gen = torch.Generator().manual_seed(2)
    lr = torch.rand(1, 2, 8, 8, 3, generator=gen)
    if name.startswith("pyramid"):
        from crfp_torch.models.pyramid import CRFPPyramidX4, CRFPPyramidX8

        if name == "pyramid_x8_cra":
            return CRFPPyramidX8(16, cra=True, device="cpu")(lr, torch.rand(1, 2, 16, 16, 3))
        cls, s = (CRFPPyramidX8, 8) if name == "pyramid_x8" else (CRFPPyramidX4, 4)
        hw = (8 * s, 8 * s)
        return cls(16, device="cpu")(lr, torch.rand(1, 2, *hw, 3), torch.ones(1, 2, *hw, 1))
    if name == "pcd":
        from crfp_torch.nn.pcd import PCDAlign

        x = torch.rand(1, 16, 12, 12, generator=gen)
        return PCDAlign(16, 2, device="cpu")(x, x, x, torch.zeros(1, 2, 12, 12))
    if name == "flow_warp_eval":
        import numpy as np

        from crfp_torch.eval.flow_warp_eval import flow_warp_propagation_eval

        rng = np.random.default_rng(0)
        return flow_warp_propagation_eval(rng.uniform(0, 1, (3, 8, 8, 3)),
                                          rng.uniform(0, 1, (3, 64, 64, 3)), device="cpu")
    from crfp_torch.models.runtime import CRFPRuntimeSimple, CRFPRuntimeV18

    if name == "runtime_nofv":
        model = CRFPRuntimeV18(ModelConfig(mid_channels=16), (64, 64), nofv=True,
                               device="cpu")
    else:
        model = CRFPRuntimeSimple(ModelConfig(variant="v15", mid_channels=16), (64, 64),
                                  device="cpu")
    lr, fv = torch.rand(1, 8, 8, 3, generator=gen), torch.rand(1, 32, 32, 3, generator=gen)
    x_lr, x_hr = model.encode(lr, None if name == "runtime_nofv" else fv)
    state, _ = model.step0(lr, x_lr, x_hr)
    return model.step(state, lr, lr, x_lr, x_hr)


@pytest.mark.parametrize("name", ["pyramid_x8", "pyramid_x8_cra", "pyramid_x4", "pcd",
                                  "flow_warp_eval", "runtime_simple", "runtime_nofv"])
def test_models_take_plain_versions_on_cpu(name):
    """The models slice's entry points on CPU tensors launch no kernel."""
    before = _launch_counts()
    with torch.no_grad():
        _run_model(name)
    assert _launch_counts() == before


def test_dispatchers_raise_for_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a card is refused, never
    sent to the plain version."""
    from crfp_torch.ops.cuda import dcn, emit, warp

    x, off, mask, w, b = (t.to("meta") for t in _dcn_args(False))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dcn.deform_conv2d_windowed(x, off, mask, w, b, max_displacement=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp.flow_warp_windowed(x, torch.zeros(1, 2, 6, 7, device="meta"), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        emit.emit_frame(torch.zeros(1, 3, 8, 8, device="meta"),
                        torch.zeros(1, 3, 1, 1, device="meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from crfp_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.function("dcn_fwd", "crfp_dcn_fwd", [])
    assert not (tmp_path / "build").exists()


def test_build_targets_follow_the_sources():
    """One library per csrc/*.cu, named by a hash of source and flags."""
    from crfp_torch.ops.cuda import _build

    names = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    assert names == ["dcn_bwd", "dcn_fused", "dcn_fwd", "emit", "flow_warp",
                     "flow_warp_bwd", "ssim"]
    # the header kernels A and E share is part of every library's hash
    assert (_build.SRC_DIR / "common.cuh").exists()
    t = _build._target(_build.SRC_DIR / "emit.cu")
    assert t.parent == _build.BUILD_DIR and t.name.startswith("libemit-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_every_port_module_imports_without_jax():
    """Importing every module of the port (the eval package included) in a
    fresh interpreter loads neither JAX nor the JAX package."""
    import subprocess
    import sys

    mods = sorted(".".join(f.relative_to(_ROOT).with_suffix("").parts)
                  for f in (_ROOT / "crfp_torch").rglob("*.py") if f.name != "__init__.py")
    assert "crfp_torch.eval.zones" in mods and "crfp_torch.bench.deploy_gate" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {_FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr[-2000:]


# ---- on the card -------------------------------------------------------
# The skip condition is a string, so pytest evaluates it when the test is
# set up, not when the module is imported.

_NEEDS_CARD = pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU and nvcc")


def _cuda_dcn(shared: bool, dtype: torch.dtype, window: int | None = 2):
    from crfp_torch.ops.cuda import dcn
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    x, off, mask, w, b = (t.cuda() for t in _dcn_args(shared))
    kw = dict(max_displacement=window, shared_taps=shared, shared_mask=shared)
    want = deform_conv2d_windowed_ref(x, off, mask, w, b, **kw)
    got = dcn.deform_conv2d_windowed(x.to(dtype), off, mask, w, b, **kw)
    torch.cuda.synchronize()
    return got.float(), want


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("shared", [False, True], ids=["per_tap", "shared"])
def test_kernel_a_matches_plain_on_card(shared):
    got, want = _cuda_dcn(shared, torch.float32)
    assert float((got - want).abs().max()) <= 1e-4
    got, _ = _cuda_dcn(shared, torch.bfloat16)
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("shared", [False, True], ids=["per_tap", "shared"])
def test_kernel_a_unclamped_matches_plain_on_card(shared):
    """max_displacement=None (the exact DCN) launches the kernel unclamped."""
    from crfp_torch.ops.cuda import dcn

    before = dcn.launches
    got, want = _cuda_dcn(shared, torch.float32, window=None)
    assert float((got - want).abs().max()) <= 1e-4
    assert dcn.launches == before + 1


@pytest.mark.cuda
@_NEEDS_CARD
def test_kernel_b_and_c_match_plain_on_card():
    from crfp_torch.ops.cuda import emit, warp
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 24, 30, 33, generator=gen).cuda()
    flow = (torch.randn(1, 2, 30, 33, generator=gen) * 12).cuda()
    got = warp.flow_warp_windowed(x, flow, 8)
    assert float((got - flow_warp_windowed_ref(x, flow, 8)).abs().max()) <= 1e-5
    for r in (1, 4):
        y = torch.randn(1, 3 * r * r, 64 // r, 96 // r, generator=gen).cuda()
        lr = torch.rand(1, 3, 8, 12, generator=gen).cuda()
        err = (emit.emit_frame(y, lr, r) - emit.emit_frame_ref(y, lr, r)).abs().max()
        assert float(err) <= 1e-5
    torch.cuda.synchronize()


def _grads(fn, inputs, grad_out):
    """Gradients of ``fn(*inputs)`` for ``grad_out``, by autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out.backward(grad_out)
    return out.detach(), [t.grad for t in leaves]


def _rel_err(got, want):
    return float((got.float() - want).abs().max() / want.abs().max())


# (name, c, o, g, shared): the DCN stages of the v18 models at mid 32 and
# mid 16 (dcn_0/1/2 per-tap, dcn_3 shared)
_D_WIDTHS = [("O32_cpg4_per_tap", 32, 32, 8, False), ("O4_cpg4_shared", 4, 4, 1, True),
             ("O16_cpg2_per_tap", 16, 16, 8, False), ("O2_cpg2_shared", 2, 2, 1, True)]


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [2, None], ids=["clamped", "unclamped"])
@pytest.mark.parametrize("width", _D_WIDTHS, ids=[w[0] for w in _D_WIDTHS])
def test_kernel_d_dcn_backward_matches_plain_on_card(width, window):
    """Autograd through the DCN dispatcher on CUDA tensors launches kernel
    A forward and kernel D backward; every gradient agrees with autograd
    of the plain version: f32 to 1e-4 of max|ref|, bf16 x and output
    gradient to 2e-2 of max|ref| of the f32 plain version on the same
    (rounded) values."""
    from crfp_torch.ops.cuda import dcn
    from crfp_torch.ops.dcn_windowed import deform_conv2d_windowed_ref

    _, c, o, g, shared = width
    gen = torch.Generator().manual_seed(3)
    taps = 1 if shared else 9
    x = torch.randn(2, c, 13, 17, generator=gen).cuda()
    off = (torch.randn(2, g * taps * 2, 13, 17, generator=gen) * 3).cuda()
    mask = torch.rand(2, g * taps, 13, 17, generator=gen).cuda()
    w = (torch.randn(o, c, 3, 3, generator=gen) * 0.2).cuda()
    b = torch.randn(o, generator=gen).cuda()
    gout = torch.randn(2, o, 13, 17, generator=gen).cuda()
    kw = dict(max_displacement=window, shared_taps=shared, shared_mask=shared)
    before = (dcn.launches, dcn.bwd_launches)
    out, got = _grads(lambda *a: dcn.deform_conv2d_windowed(*a, **kw),
                      (x, off, mask, w, b), gout)
    torch.cuda.synchronize()
    assert (dcn.launches, dcn.bwd_launches) == (before[0] + 1, before[1] + 1)
    _, want = _grads(lambda *a: deform_conv2d_windowed_ref(*a, **kw),
                     (x, off, mask, w, b), gout)
    for name, gg, ww in zip(("x", "offset", "mask", "weight", "bias"), got, want):
        assert _rel_err(gg, ww) <= 1e-4, name
    xb, gb = x.to(torch.bfloat16), gout.to(torch.bfloat16)
    _, gotb = _grads(lambda *a: dcn.deform_conv2d_windowed(*a, **kw), (xb, off, mask, w, b), gb)
    _, wantb = _grads(lambda *a: deform_conv2d_windowed_ref(*a, **kw),
                      (xb.float(), off, mask, w, b), gb.float())
    torch.cuda.synchronize()
    for name, gg, ww in zip(("x", "offset", "mask", "weight", "bias"), gotb, wantb):
        assert _rel_err(gg, ww) <= 2e-2, name


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [8, None], ids=["clamped", "unclamped"])
def test_kernel_d_warp_backward_matches_plain_on_card(window):
    from crfp_torch.ops.cuda import warp
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 24, 30, 33, generator=gen).cuda()
    flow = (torch.randn(2, 2, 30, 33, generator=gen) * 12).cuda()
    gout = torch.randn(2, 24, 30, 33, generator=gen).cuda()
    before = warp.bwd_launches
    _, got = _grads(lambda *a: warp.flow_warp_windowed(*a, window), (x, flow), gout)
    torch.cuda.synchronize()
    assert warp.bwd_launches == before + 1
    _, want = _grads(lambda *a: flow_warp_windowed_ref(*a, window), (x, flow), gout)
    for name, gg, ww in zip(("x", "flow"), got, want):
        assert _rel_err(gg, ww) <= 1e-4, name


# the unclamped warps of the trunk variants without the HR-level cascade:
# lv3_state of no_dcn and hr_dcn=False, basic_fvsr's four stacked states, at
# the 720p clip (LR 90x160) and at the recipe's training shapes (B 2, GT 192)
_UNCLAMPED = [("lv3_720p", (1, 32, 180, 320), False),
              ("stack_720p", (1, 128, 180, 320), False),
              ("stack_train", (2, 128, 48, 48), True)]


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("shape,backward", [u[1:] for u in _UNCLAMPED],
                         ids=[u[0] for u in _UNCLAMPED])
def test_kernel_b_and_d_unclamped_at_the_variant_shapes_match_plain_on_card(shape, backward):
    """Kernel B with no clamp (window None) against the plain warp to 1e-5;
    at the training shape kernel D at k=1 against autograd of the plain
    warp to 1e-4 of max|ref|, d-flow bit-equal over two runs."""
    from crfp_torch.ops.cuda import warp
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    gen = torch.Generator().manual_seed(5)
    n, _, h, w = shape
    x = torch.randn(*shape, generator=gen).cuda()
    flow = (torch.randn(n, 2, h, w, generator=gen) * 12).cuda()
    before = warp.launches
    got = warp.flow_warp_windowed(x, flow, None)
    torch.cuda.synchronize()
    assert warp.launches == before + 1
    assert float((got - flow_warp_windowed_ref(x, flow, None)).abs().max()) <= 1e-5
    if not backward:
        return
    gout = torch.randn(*shape, generator=gen).cuda()
    before = warp.bwd_launches
    _, grads = _grads(lambda *a: warp.flow_warp_windowed(*a, None), (x, flow), gout)
    torch.cuda.synchronize()
    assert warp.bwd_launches == before + 1
    _, want = _grads(lambda *a: flow_warp_windowed_ref(*a, None), (x, flow), gout)
    for name, gg, ww in zip(("x", "flow"), grads, want):
        assert _rel_err(gg, ww) <= 1e-4, name
    first = warp.flow_warp_backward(x, flow, gout, None)[1]
    assert torch.equal(first, warp.flow_warp_backward(x, flow, gout, None)[1])


@pytest.mark.cuda
@_NEEDS_CARD
def test_kernel_f_ssim_matches_plain_on_card():
    from crfp_torch.ops.cuda import ssim

    gen = torch.Generator().manual_seed(5)
    hr = torch.rand(3, 3, 70, 101, generator=gen).cuda()
    sr = (hr + 0.1 * torch.randn(3, 3, 70, 101, generator=gen).cuda()).clamp(0, 1)
    before = ssim.launches
    got = ssim.ssim_map(sr, hr)
    torch.cuda.synchronize()
    assert ssim.launches == before + 1
    assert float((got - ssim.ssim_map_ref(sr, hr)).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="no backward"):
        ssim.ssim_map(sr.requires_grad_(True), hr)


def _fused_args(dtype, n=1, c=32, g=8, hw=(21, 37), seed=6):
    gen = torch.Generator().manual_seed(seed)
    h, w = hw
    x = torch.randn(n, c, h, w, generator=gen)
    raw = torch.randn(n, g * 18, h, w, generator=gen) * 0.5
    rawm = torch.randn(n, g * 9, h, w, generator=gen) * 1.5
    flow = torch.stack([torch.randn(n, h, w, generator=gen) + 2.5,
                        torch.randn(n, h, w, generator=gen) * 3 - 1.0], dim=1)
    wt = torch.randn(32, c, 3, 3, generator=gen) * 0.1
    b = torch.randn(32, generator=gen)
    return [x.cuda().to(dtype), raw.cuda().to(dtype), rawm.cuda().to(dtype),
            flow.cuda(), wt.cuda(), b.cuda()]


@pytest.mark.cuda
@_NEEDS_CARD
@pytest.mark.parametrize("window", [8, None], ids=["clamped", "unclamped"])
def test_kernel_e_matches_plain_on_card(window):
    from crfp_torch.ops.cuda import dcn_fused
    from crfp_torch.ops.dcn_windowed import deform_conv2d_fusedprep_ref

    args = _fused_args(torch.float32, n=2)
    before = dcn_fused.launches
    got = dcn_fused.deform_conv2d_fusedprep(*args, max_displacement=window)
    torch.cuda.synchronize()
    assert dcn_fused.launches == before + 1
    want = deform_conv2d_fusedprep_ref(*args, max_displacement=window)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    argsb = _fused_args(torch.bfloat16, n=2)
    gotb = dcn_fused.deform_conv2d_fusedprep(*argsb, max_displacement=window)
    torch.cuda.synchronize()
    assert gotb.dtype == torch.bfloat16
    assert float((gotb.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())
    with pytest.raises(ValueError, match="no backward"):
        dcn_fused.deform_conv2d_fusedprep(args[0].requires_grad_(True), *args[1:],
                                          max_displacement=window)


@pytest.mark.cuda
@_NEEDS_CARD
def test_kernel_e_matches_prologue_then_kernel_a_on_card():
    """E against the PyTorch prologue followed by kernel A on the same
    operands, on a smooth field: f32 rounding (1e-5)."""
    from crfp_torch.ops.cuda import dcn, dcn_fused
    from crfp_torch.ops.dcn_windowed import fusedprep_offsets_and_mask

    x, raw, rawm, flow, wt, b = _fused_args(torch.float32)
    h, w = x.shape[-2:]
    yy = torch.arange(h, device="cuda").view(1, 1, h, 1)
    xx = torch.arange(w, device="cuda").view(1, 1, 1, w)
    fr = torch.linspace(-0.3, 0.3, 32, device="cuda").view(1, 32, 1, 1)
    x = torch.sin(yy * fr + xx * fr.flip(1) + 10 * fr).contiguous()
    got = dcn_fused.deform_conv2d_fusedprep(x, raw, rawm, flow, wt, b, max_displacement=8)
    off, mask = fusedprep_offsets_and_mask(raw, rawm, flow, 10.0)
    want = dcn.deform_conv2d_windowed(x, off, mask, wt, b, max_displacement=8)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
