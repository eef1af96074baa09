"""Helpers for the port's parity tests: run the JAX CRFPRuntimeV18 and the
crfp_torch port on the same numpy inputs and weights, on the CPU, in f32.

Inputs are made with numpy from a seed; weights move JAX -> port through
``crfp_torch.params.from_jax``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

LR_HW = (16, 24)
WARP = (64, 64)
FV = 32


def clip(t: int = 3, seed: int = 0, lr_hw=LR_HW, fv: int = FV):
    """(lrs (t, 1, h, w, 3), fvs (t, 1, fv, fv, 3)) float32 in [0, 1)."""
    rng = np.random.default_rng(seed)
    lrs = rng.uniform(0, 1, (t, 1, *lr_hw, 3)).astype(np.float32)
    fvs = rng.uniform(0, 1, (t, 1, fv, fv, 3)).astype(np.float32)
    return lrs, fvs


def flat_params(tree) -> dict[str, np.ndarray]:
    import flax

    return {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(tree, sep="/").items()}


def perturb_heads(flat: dict[str, np.ndarray], seed: int = 0,
                  offset_std: float = 0.05) -> dict[str, np.ndarray]:
    """Copy of ``flat`` with random DCN offset/mask heads and DCN weights:
    the init's zero heads and identity weight would leave the offsets at
    the flow and every mask at 0.5, so parity would not see the DCN."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for k, v in flat.items():
        if "/dcn_offset/" in k:
            out[k] = rng.normal(0, offset_std, v.shape).astype(np.float32)
        elif "/dcn_mask/" in k or k.endswith(("/dcn_weight", "/dcn_bias")):
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
    return out


def unflatten(flat: dict[str, np.ndarray]):
    import flax

    return flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def jax_model(warp=WARP, **cfg):
    from crfp_tpu.models.crfp import ModelConfig
    from crfp_tpu.models.runtime import CRFPRuntimeV18

    return CRFPRuntimeV18(ModelConfig(variant="v18", **cfg), warp_size=warp)


def jax_init(model, lrs, fvs, seed: int = 0) -> dict[str, np.ndarray]:
    """The JAX model's init tree, flattened to numpy."""
    lr, fv = jnp.asarray(lrs[0]), jnp.asarray(fvs[0])

    def run(mdl):
        x_lr, x_hr = mdl.encode(lr, fv)
        state, _ = mdl.step0(lr, x_lr, x_hr)
        mdl.step(state, lr, lr, x_lr, x_hr)

    return flat_params(jax.jit(lambda k: model.init(k, method=run))(
        jax.random.PRNGKey(seed)))


def jax_frames(model, flat, lrs, fvs) -> list[np.ndarray]:
    """step0 + (t-1) steps of the JAX model; NHWC frames as numpy."""
    from crfp_tpu.models.runtime import CRFPRuntimeV18 as M

    params = unflatten(flat)
    enc = jax.jit(lambda p, a, b: model.apply(p, a, b, method=M.encode))
    step0 = jax.jit(lambda p, a, xl, xh: model.apply(p, a, xl, xh, method=M.step0))
    step = jax.jit(lambda p, s, a, pa, xl, xh: model.apply(
        p, s, a, pa, xl, xh, method=M.step))
    outs = []
    state = None
    for i in range(len(lrs)):
        lr, fv = jnp.asarray(lrs[i]), jnp.asarray(fvs[i])
        x_lr, x_hr = enc(params, lr, fv)
        if i == 0:
            state, out = step0(params, lr, x_lr, x_hr)
        else:
            state, out = step(params, state, lr, jnp.asarray(lrs[i - 1]), x_lr, x_hr)
        outs.append(np.asarray(out))
    return outs


def torch_model(flat, warp=WARP, **cfg):
    """The port's model on the CPU with the JAX leaves ``flat`` loaded
    (strict: every port parameter must come from the JAX tree)."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.params import from_jax

    model = CRFPRuntimeV18(ModelConfig(**cfg), warp_size=warp, device="cpu")
    model.load_state_dict(from_jax(flat), strict=True)
    return model.eval()


@torch.no_grad()
def torch_frames(model, lrs, fvs) -> list[np.ndarray]:
    outs = []
    state = None
    for i in range(len(lrs)):
        lr, fv = torch.from_numpy(lrs[i]), torch.from_numpy(fvs[i])
        x_lr, x_hr = model.encode(lr, fv)
        if i == 0:
            state, out = model.step0(lr, x_lr, x_hr)
        else:
            state, out = model.step(state, lr, torch.from_numpy(lrs[i - 1]),
                                    x_lr, x_hr)
        outs.append(out.numpy())
    return outs


def anchored_jax_dispatch(monkeypatch) -> None:
    """Route the JAX models' windowed dispatch to the anchored Pallas
    kernels in interpret mode wherever a call asks for ``anchor``: off the
    TPU ``crfp_tpu``'s dispatch drops it and computes the plain clamp
    (crfp_tpu/nn/align.py:41-84, crfp_tpu/ops/pallas/warp.py:89-124). With
    ``anchor_vjp`` (a model trained with ``dcn_anchor_vjp``) the calls go
    to the differentiable entries with ``anchor_vjp=True``, as the TPU
    branch makes them: the training grid, the anchored backward. The
    models import both dispatchers at call time, so patching the modules'
    attributes reaches them; nothing in ``crfp_tpu`` changes."""
    import crfp_tpu.nn.align as jalign
    import crfp_tpu.ops.pallas.warp as jwarp
    from crfp_tpu.ops.pallas.dcn import deform_conv2d_pallas_vjp

    dcn, warp, warp_s2d = (jalign._windowed_dcn, jwarp.flow_warp_maybe_windowed,
                           jwarp.flow_warp_maybe_windowed_s2d)

    def windowed_dcn(x, off, mask, weight, bias, window, shared=False, shared_mask=False,
                     s2d=1, anchor=False, anchor_vjp=False):
        if not anchor:
            return dcn(x, off, mask, weight, bias, window, shared, shared_mask, s2d)
        # the TPU branch's request (crfp_tpu/nn/align.py:59)
        band = 32 if x.dtype == jnp.bfloat16 else 8
        return deform_conv2d_pallas_vjp(x, off, mask, weight, bias, max_displacement=window,
                                        shared_taps=shared, shared_mask=shared_mask, s2d=s2d,
                                        band=band, anchor=True, anchor_vjp=anchor_vjp,
                                        interpret=True)

    def warp_full(x, flow, window, *, anchor=False, anchor_vjp=False):
        if not anchor or window is None:
            return warp(x, flow, window)
        return jwarp.flow_warp_windowed_pallas(x, flow, max_displacement=window,
                                               anchor=True, anchor_vjp=anchor_vjp,
                                               interpret=True)

    def warp_s2d_(x, flow, window, r=4, *, anchor=False, anchor_vjp=False):
        if not anchor or window is None:
            return warp_s2d(x, flow, window, r)
        return jwarp.flow_warp_windowed_pallas_s2d(x, flow, r=r, max_displacement=window,
                                                   anchor=True, anchor_vjp=anchor_vjp,
                                                   interpret=True)

    monkeypatch.setattr(jalign, "_windowed_dcn", windowed_dcn)
    monkeypatch.setattr(jwarp, "flow_warp_maybe_windowed", warp_full)
    monkeypatch.setattr(jwarp, "flow_warp_maybe_windowed_s2d", warp_s2d_)


def jax_native_oracle(directory):
    """A private instance of the JAX package's native bindings
    (crfp_tpu/native/bindings.py), its library built into ``directory``.

    The JAX package builds ``libcrfp_native.so`` in place, straight onto
    the path it then loads, and a failed load disables the library for the
    life of the process; several test workers that build it at once on a
    fresh tree can load a half-written file. So the port's tests do not
    take their oracle from that shared build: they load the module file a
    second time under another name, point its ``_LIB`` at a temporary name
    in ``directory``, build with the module's own ``_build`` (the JAX
    package's g++ line), move the file into place with ``os.replace`` and
    load it from there. Nothing in ``crfp_tpu`` changes."""
    import importlib.util
    import os

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "crfp_tpu", "native", "bindings.py")
    spec = importlib.util.spec_from_file_location("crfp_tpu_native_oracle", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    final = os.path.join(str(directory), "libcrfp_native.so")
    mod._LIB = f"{final}.{os.getpid()}.tmp"
    mod._build()
    os.replace(mod._LIB, final)
    mod._LIB = final
    if not mod.native_available():
        raise RuntimeError(f"the JAX package's native library did not load from {final}")
    return mod


def set_flow_bias(flat: dict[str, np.ndarray], dy: float, dx: float,
                  scale: float = 0.1) -> dict[str, np.ndarray]:
    """Copy of ``flat`` whose FNet returns about (dx, dy) LR pixels
    everywhere, plus its own weights' variation times ``scale``: the bias of
    ``flow_conv2`` set to ``atanh(f / 256)`` (FNet ends in ``256 tanh``),
    its kernel scaled. So the 8x flow moves coherently past the HR window."""
    out = dict(flat)
    for k, v in flat.items():
        if k.endswith("flow_conv2/conv/bias"):
            out[k] = np.arctanh(np.asarray([dx, dy], np.float32) / 256.0).astype(np.float32)
        elif k.endswith("flow_conv2/conv/kernel"):
            out[k] = (v * scale).astype(np.float32)
    return out
