"""Checkpoints: the JAX package's flat flax ``.npz`` onto the port's modules.

The ``.npz`` format is that of crfp_tpu/utils/params_io.py::save_params_npz
(:27): one array per flax leaf, keyed ``params/<module path>/<leaf>``. The
port's module tree follows the flax names, so the mapping is mechanical:

- ``a/b/conv/kernel`` (HWIO) -> ``a.b.conv.weight`` (OIHW);
- ``a/dcn_weight`` and the pyramid's ``a/dcn_weight_lv{k}`` (kh, kw, C, O)
  -> (O, C, kh, kw);
- every other leaf (biases, ``dcn_bias``) passes through.

:func:`to_jax` is the inverse, and :func:`save_npz` writes the flat format,
so the JAX package loads a checkpoint the port trained
(crfp_tpu/utils/params_io.py::load_params).
"""

from __future__ import annotations

import re

import numpy as np
import torch


# the DCN weight leaves: the trunk's and the pyramid levels' (models/pyramid.py)
_DCN_WEIGHT = re.compile(r"^dcn_weight(_lv\d+)?$")


def load_npz(path: str) -> dict[str, np.ndarray]:
    """The flat {flax path: array} dict of a ``.npz`` checkpoint."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax leaves -> the port's state_dict (float tensors on the CPU)."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        a = np.asarray(value)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            a = a.transpose(3, 2, 0, 1)
        elif _DCN_WEIGHT.match(parts[-1]):
            a = a.transpose(3, 2, 0, 1)
        out[".".join(parts)] = torch.tensor(np.ascontiguousarray(a))
    return out


def to_jax(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's state_dict -> flat flax leaves ``params/<path>/<leaf>``, as
    numpy copies: ``a.b.conv.weight`` (OIHW) -> ``a/b/conv/kernel`` (HWIO),
    ``a.dcn_weight`` and ``a.dcn_weight_lv{k}`` (O, C, kh, kw) -> (kh, kw,
    C, O), every other leaf as it is."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        a = value.detach().cpu().numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            a = a.transpose(2, 3, 1, 0)
        elif _DCN_WEIGHT.match(parts[-1]):
            a = a.transpose(2, 3, 1, 0)
        # a copy: .numpy() shares the parameter's storage
        out["/".join(["params", *parts])] = np.array(a, order="C")
    return out


def save_npz(state_dict: dict[str, torch.Tensor], path: str) -> None:
    """Write ``state_dict`` as a flat flax ``.npz`` (the format of
    crfp_tpu/utils/params_io.py::save_params_npz)."""
    np.savez_compressed(path, **to_jax(state_dict))


_RB_INPUT = re.compile(r"^(forward_resblocks_)(\d)\.input_conv(\..*)$")
_RB_ANY = re.compile(r"^(forward_resblocks_)(\d)(\..*)$")


def runtime_params_from_batch(
    batch_flat: dict[str, np.ndarray], init_state: dict[str, torch.Tensor]
) -> tuple[dict[str, torch.Tensor], int]:
    """Adapt a batch-trunk checkpoint onto the runtime model's state_dict
    (crfp_tpu/models/runtime.py:448-496, without flax).

    The runtime trunk splits each batch ``forward_resblocks_i`` into a
    cold-start copy ``forward_resblocks_i_`` (its input conv has a smaller
    arity, so only its residual blocks take the trained weights) and a
    steady-state stitching block whose ``conv1`` and ``conv2`` both take
    the batch block's ``input_conv``. Everything else maps name for name.

    ``init_state``: the runtime model's state_dict, which supplies every
    leaf the checkpoint cannot (``CRFPRuntimeV18`` initialises its
    parameters from a seeded ``torch.Generator``). Returns (state_dict,
    number of leaves kept from ``init_state``)."""
    mapped = {}
    for k, v in from_jax(batch_flat).items():
        m = _RB_INPUT.match(k)
        if m:
            pre, i, rest = m.groups()
            mapped[f"{pre}{i}.conv1{rest}"] = v
            mapped[f"{pre}{i}.conv2{rest}"] = v
            mapped[f"{pre}{i}_.input_conv{rest}"] = v
            continue
        m = _RB_ANY.match(k)
        if m:
            pre, i, rest = m.groups()
            mapped[k] = v
            mapped[f"{pre}{i}_{rest}"] = v
            continue
        mapped[k] = v

    out = {}
    n_unmapped = 0
    for k, init in init_state.items():
        v = mapped.get(k)
        if v is not None and tuple(v.shape) == tuple(init.shape):
            out[k] = v.to(device=init.device, dtype=init.dtype)
        else:
            out[k] = init
            n_unmapped += 1
    return out, n_unmapped
