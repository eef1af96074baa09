"""The launch path of the port's CUDA kernels, on the CPU.

``crfp_torch/ops/cuda/_build.py`` configures each C entry once and makes
every launch through one helper; ``crfp_torch/ops/cuda/warp.py`` launches
kernel B without an ``autograd.Function`` where autograd records nothing
and checks its operands in one pass. None of that may change what the
dispatcher computes or refuses: the windowed warp still equals its plain
version and the JAX package's warp (crfp_tpu/ops/warp.py::flow_warp on the
clipped flow) on the same numpy inputs, f32, to 1e-6, and its gradients
equal the plain version's.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


class _FakeEntry:
    """Stands in for a ctypes function pointer: counts configuration and
    calls, returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.argtypes_set = 0
        self.calls = []

    def __setattr__(self, name, value):
        if name == "argtypes":
            object.__setattr__(self, "argtypes_set", self.argtypes_set + 1)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _FakeLibrary:
    loaded = []

    def __init__(self, path):
        _FakeLibrary.loaded.append(path)
        self.crfp_error_string = _FakeEntry(rc=b"an illegal memory access")
        self.crfp_flow_warp = _FakeEntry()
        self.crfp_failing = _FakeEntry(rc=700)


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """``_build`` with the compiler and the loader replaced by stubs, its
    caches empty, and a current CUDA device 0 with stream handle 77."""
    from crfp_torch.ops.cuda import _build

    builds = []

    def build_all():
        builds.append(1)
        return {"flow_warp": tmp_path / "libflow_warp-0.so"}

    entered = []

    class DeviceContext:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            return False

    _FakeLibrary.loaded = []
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLibrary)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "stream_handle", lambda index: 77 + index)
    monkeypatch.setattr(_build.torch.cuda, "device", DeviceContext)
    return _build, builds, entered


def test_function_builds_loads_and_configures_once(fake_build):
    _build, builds, _ = fake_build
    argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn = _build.function("flow_warp", "crfp_flow_warp", argtypes)
    again = _build.function("flow_warp", "crfp_flow_warp", argtypes)
    assert again is fn
    assert len(builds) == 1 and len(_FakeLibrary.loaded) == 1
    assert fn.argtypes_set == 1 and fn.argtypes == argtypes
    assert fn.restype is ctypes.c_int
    # a second entry of the same library: no second build or load
    other = _build.function("flow_warp", "crfp_failing", argtypes)
    assert other is not fn and other.argtypes_set == 1
    assert len(builds) == 1 and len(_FakeLibrary.loaded) == 1


def test_launch_configures_once_and_appends_the_stream(fake_build):
    _build, builds, entered = fake_build
    argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    for _ in range(3):
        _build.launch("flow_warp", "crfp_flow_warp", argtypes,
                      torch.device("cuda", 0), 4096, 5)
    fn = _build.function("flow_warp", "crfp_flow_warp", argtypes)
    # plain ints in, the current stream's handle last; configured once
    assert fn.calls == [(4096, 5, 77)] * 3
    assert fn.argtypes_set == 1 and len(builds) == 1
    assert entered == []  # the current device: no device context
    _build.launch("flow_warp", "crfp_flow_warp", argtypes, torch.device("cuda", 1), 0, 1)
    assert entered == [torch.device("cuda", 1)]
    assert fn.calls[-1] == (0, 1, 78)  # that device's stream


def test_launch_raises_with_the_entry_name_on_a_cuda_error(fake_build):
    _build, _, _ = fake_build
    with pytest.raises(RuntimeError, match=r"crfp_failing: CUDA error 700: an illegal"):
        _build.launch("flow_warp", "crfp_failing", [ctypes.c_void_p],
                      torch.device("cuda", 0))


def _warp_inputs(seed=0, d=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (2, 14, 18, 5)).astype(np.float32)
    flow = (rng.standard_normal((2, 14, 18, 2)) * 1.5 * d).astype(np.float32)
    assert (np.abs(flow) > d).mean() > 0.2  # the clamp is exercised
    return x, flow, d


@pytest.mark.parametrize("no_grad", [False, True], ids=["grad_mode", "no_grad"])
@pytest.mark.parametrize("needs", ["none", "x", "flow", "both"])
def test_warp_dispatcher_on_cpu_equals_plain_and_jax(needs, no_grad):
    """(c): with and without ``requires_grad``, inside and outside
    ``torch.no_grad()``; f32, 1e-6 against JAX on the same numpy inputs."""
    from crfp_tpu.ops.warp import flow_warp as jwarp
    from crfp_torch.ops.cuda import warp
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    x, flow, d = _warp_inputs()
    want_jax = np.asarray(jwarp(jnp.asarray(x), jnp.clip(jnp.asarray(flow), -d, d)))

    def leaves():
        tx = _nchw(x).requires_grad_(needs in ("x", "both"))
        tf = _nchw(flow).requires_grad_(needs in ("flow", "both"))
        return tx, tf

    before = (warp.launches, warp.bwd_launches)
    tx, tf = leaves()
    with torch.set_grad_enabled(not no_grad):
        got = warp.flow_warp_windowed(tx, tf, d)
    rx, rf = leaves()
    with torch.set_grad_enabled(not no_grad):
        ref = flow_warp_windowed_ref(rx, rf, d)
    assert torch.equal(got, ref)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), want_jax,
                               atol=1e-6, rtol=0)
    recorded = needs != "none" and not no_grad
    assert got.requires_grad == recorded
    if recorded:
        ct = torch.from_numpy(np.random.default_rng(1).standard_normal(
            tuple(got.shape)).astype(np.float32))
        got.backward(ct)
        ref.backward(ct)
        for a, b in ((tx, rx), (tf, rf)):
            assert (a.grad is None) == (b.grad is None)
            if a.grad is not None:
                assert torch.equal(a.grad, b.grad)
    assert (warp.launches, warp.bwd_launches) == before  # no kernel on the CPU


def _good():
    return torch.zeros(1, 3, 6, 7), torch.zeros(1, 2, 6, 7)


_BAD_OPERANDS = {
    "meta_device": (lambda x, f: (x.to("meta"), f.to("meta")), "CUDA tensor"),
    "cpu_tensor": (lambda x, f: (x, f), "CUDA tensor"),
    "x_3d": (lambda x, f: (x[0], f), r"must be \(N, C, H, W\)"),
    "flow_shape": (lambda x, f: (x, torch.zeros(1, 2, 6, 8)), r"flow \(1, 2, 6, 8\) !="),
    "flow_channels": (lambda x, f: (x, torch.zeros(1, 3, 6, 7)), r"flow \(1, 3, 6, 7\) !="),
    "flow_3d": (lambda x, f: (x, f[0]), r"flow \(2, 6, 7\) !="),
    "x_float16": (lambda x, f: (x.half(), f), "x dtype torch.float16"),
    "flow_float64": (lambda x, f: (x, f.double()), "flow must be float32"),
    "x_not_contiguous": (lambda x, f: (torch.zeros(1, 3, 7, 6).transpose(2, 3), f),
                         "must be contiguous"),
    "flow_not_contiguous": (lambda x, f: (x, torch.zeros(1, 2, 7, 6).transpose(2, 3)),
                            "must be contiguous"),
}


@pytest.mark.parametrize("case", sorted(_BAD_OPERANDS))
def test_warp_check_refuses_every_wrong_operand(case):
    """(d): the one-pass check drops nothing; a failed pass names the fault
    (the device comes last, so the other faults can be told apart here)."""
    from crfp_torch.ops.cuda import warp

    make, message = _BAD_OPERANDS[case]
    x, flow = make(*_good())
    with pytest.raises(ValueError, match=message):
        warp._check(x, flow)
    if x.device.type != "cpu":  # the dispatcher itself refuses it too
        with pytest.raises(ValueError, match=message):
            warp.flow_warp_windowed(x, flow, 2)
        with pytest.raises(ValueError, match=message):
            warp.flow_warp_backward(x, flow, torch.zeros_like(x), 2)


@pytest.mark.parametrize("needs_grad,no_grad,through_function", [
    (False, False, False), (False, True, False), (True, True, False), (True, False, True)])
def test_warp_skips_the_autograd_function_where_nothing_is_recorded(
        monkeypatch, needs_grad, no_grad, through_function):
    """Off the CPU the dispatcher goes to the kernel launch; through the
    ``autograd.Function`` only if an operand requires grad in grad mode.
    The launch is replaced by a stub on meta tensors, with the argument
    list held against the entry's argument types."""
    from crfp_torch.ops.cuda import _build, warp

    sent = []

    def launch(lib, entry, argtypes, device, *args):
        assert len(args) == len(argtypes) - 1  # the helper appends the stream
        sent.append((lib, entry))

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(warp, "_check", lambda x, flow: x.shape)
    x = torch.zeros(1, 3, 6, 7, device="meta", requires_grad=needs_grad)
    flow = torch.zeros(1, 2, 6, 7, device="meta")
    before = (warp.launches, warp.bwd_launches)
    with torch.set_grad_enabled(not no_grad):
        out = warp.flow_warp_windowed(x, flow, 8)
    assert out.shape == x.shape and out.device.type == "meta"
    assert (out.grad_fn is not None) == through_function
    assert sent == [("flow_warp", "crfp_flow_warp")]
    assert warp.launches == before[0] + 1
    if through_function:
        (dx,) = torch.autograd.grad(out, x, torch.zeros_like(out))
        assert dx.shape == x.shape and dx.dtype == x.dtype
        assert sent[-1] == ("flow_warp_bwd", "crfp_flow_warp_bwd")
        assert warp.bwd_launches == before[1] + 1
    monkeypatch.setattr(warp, "launches", before[0])
    monkeypatch.setattr(warp, "bwd_launches", before[1])


def test_merged_lv3_warps_would_not_be_bit_equal_in_d_flow():
    """Why the trunk keeps two warps by ``flow_lv3`` (lv3_state, and the
    three lv states): one warp of their concatenation gives the same
    output and the same dx bit for bit, but d-flow becomes one sum over 56
    channels instead of the sum of two, which differs in the last bits."""
    from crfp_torch.ops.warp import flow_warp_windowed_ref

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(2, 32, 12, 12, generator=gen).requires_grad_(True)
    b = torch.randn(2, 24, 12, 12, generator=gen).requires_grad_(True)
    f = (torch.randn(2, 2, 12, 12, generator=gen) * 3).requires_grad_(True)
    ga = torch.randn(2, 32, 12, 12, generator=gen)
    gb = torch.randn(2, 24, 12, 12, generator=gen)
    two = [flow_warp_windowed_ref(a, f, 8), flow_warp_windowed_ref(b, f, 8)]
    one = flow_warp_windowed_ref(torch.cat([a, b], 1), f, 8)
    one = [one[:, :32], one[:, 32:]]
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    g_two = torch.autograd.grad(two, [a, b, f], [ga, gb])
    g_one = torch.autograd.grad(one, [a, b, f], [ga, gb])
    assert torch.equal(g_one[0], g_two[0]) and torch.equal(g_one[1], g_two[1])
    d = float((g_one[2] - g_two[2]).abs().max())
    assert 0 < d <= 1e-4 * float(g_two[2].abs().max())
