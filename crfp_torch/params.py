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

The reference's own PyTorch checkpoints map onto the same tree by the JAX
package's name map (crfp_tpu/tools/convert_torch.py::convert_state_dict,
:116), kept here as a copy: each reference name becomes a flax path, so
the port's key is that path joined by dots with ``kernel`` read as
``weight``. The reference and the port both keep torch's OIHW convolution
weights and the DCNv2 weight as (O, C, kh, kw), so no array is transposed.
It covers the reference's checkpoint surface:
- model checkpoints ``model_{epoch}_{iter}.pt`` saved by its trainer with
  the ``module.`` prefix stripped by a substring replace, which mangles
  ``basic_module.`` into ``basic_``;
- the ``basic_`` -> ``basic_module.`` SPyNet key remap its loader applies;
- pretrained flow nets ``fnet.pth`` / ``spynet_*.pth``.
:func:`to_reference` names a batch trunk's state_dict the reference's way.
"""

from __future__ import annotations

import re
from typing import Any

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
    batch_state: dict[str, torch.Tensor], init_state: dict[str, torch.Tensor]
) -> tuple[dict[str, torch.Tensor], int]:
    """Adapt a batch trunk's state_dict (any checkpoint
    ``crfp_torch.utils.params_io.load_params`` reads) onto the runtime
    model's state_dict (crfp_tpu/models/runtime.py:448-496, without flax).

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
    for k, v in batch_state.items():
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


# ---- the reference's PyTorch checkpoints (crfp_tpu/tools/convert_torch.py) ----

_LEAF = {"weight": "kernel", "bias": "bias"}

_SEQ2NAME_FNET = {
    # torch Sequential index -> flax Conv name, for each FNet block
    "encoder1": {"0": "encoder1_conv1", "2": "encoder1_conv2"},
    "encoder2": {"0": "encoder2_conv1", "2": "encoder2_conv2"},
    "encoder3": {"0": "encoder3_conv1", "2": "encoder3_conv2"},
    "decoder1": {"0": "decoder1_conv1", "2": "decoder1_conv2"},
    "decoder2": {"0": "decoder2_conv1", "2": "decoder2_conv2"},
    "decoder3": {"0": "decoder3_conv1", "2": "decoder3_conv2"},
    "flow": {"0": "flow_conv1", "2": "flow_conv2"},
}


def _map_fnet(rest: list[str]) -> list[str]:
    # e.g. ['encoder1', '0', 'weight']
    block, idx, leaf = rest
    return [_SEQ2NAME_FNET[block][idx], "conv", _LEAF[leaf]]


def _map_spynet(rest: list[str]) -> list[str]:
    # basic_module.{L}.basic_module.{j}.conv.{weight,bias} (after the remap)
    level, j, leaf = rest[1], rest[3], rest[5]
    return [f"basic_module{level}", f"conv{j}", "conv", _LEAF[leaf]]


def _map_dcn(rest: list[str]) -> list[str] | None:
    kind = _LEAF[rest[-1]]
    head = rest[0]
    if head == "dcn_block":
        return [f"dcn_block_conv{int(rest[1]) // 2 + 1}", "conv", kind]
    if head.isdigit():
        # no_dcn variant: dcn_i is a plain Sequential
        return [f"conv{int(head) // 2 + 1}", "conv", kind]
    if head in ("dcn_offset", "dcn_mask", "conv_fuse"):
        return [head, "conv", kind]
    if head == "dcn":
        return ["dcn_weight" if rest[-1] == "weight" else "dcn_bias"]
    if head == "upsample":
        return ["upsample", "upsample_conv", "conv", kind]
    return None


def _map_lte(rest: list[str]) -> list[str]:
    leaf = _LEAF[rest[-1]]
    if rest[0].startswith("slice"):
        return [f"{rest[0]}_conv{int(rest[1]) // 2 + 1}", "conv", leaf]
    if rest[0].startswith("conv_lv"):
        return [rest[0], "conv", leaf]
    raise KeyError(rest)


def _map_resblocks(rest: list[str], stitching: bool) -> list[str] | None:
    """Batch naming: main.0 = input conv, main.2.{i}.conv{1,2} = residual
    blocks. Runtime naming: conv1 (+ a dead conv2 on the cold-start blocks),
    main.1.{i}.conv{1,2}. ``stitching``: the two-input block, whose conv1
    and conv2 both live. None for the reference's dead parameters."""
    leaf = _LEAF[rest[-1]]
    if rest[0] == "conv1":
        return ["conv1", "conv", leaf] if stitching else ["input_conv", "conv", leaf]
    if rest[0] == "conv2":
        return ["conv2", "conv", leaf] if stitching else None
    if rest[0] != "main" or rest[1] not in ("0", "1", "2"):
        raise KeyError(rest)
    if rest[1] == "0":
        return ["input_conv", "conv", leaf]
    # main.1 (runtime naming: main = [lrelu, blocks]) or main.2 (batch)
    return [f"block{rest[2]}", rest[3], "conv", leaf]


def _is_level(top: str) -> bool:
    """A gen-1 pyramid's per-level name: ``..._lv{k}``."""
    return top[-4:-1] == "_lv" and top[-1].isdigit()


def _path(key: str) -> list[str] | None:
    """The flax path of one (prefix-stripped, remapped) reference key; None
    for a parameter the model has no use for. Raises KeyError when unmapped."""
    parts = key.split(".")
    top, rest = parts[0], parts[1:]
    leaf = parts[-1]
    if top == "spynet":
        if rest[0] == "basic_module":
            return ["spynet", *_map_spynet(rest)]
        if rest[0] in ("mean", "std"):
            return None  # constants baked into the module
        return ["spynet", *_map_fnet(rest)]
    if top.startswith("dcn_") and _is_level(top):
        # the pyramid's flat naming: dcn_pre_lvK / dcn_block_lvK.{1,3} /
        # dcn_offset_lvK / dcn_mask_lvK / dcn_lvK -> under align_lvK
        lv = top[-1]
        if top.startswith("dcn_block_lv"):
            # Sequential(lrelu, conv, lrelu, conv, lrelu): 1 -> conv1, 3 -> conv2
            return [f"align_lv{lv}", f"{top}_conv{(int(rest[0]) - 1) // 2 + 1}", "conv",
                    _LEAF[leaf]]
        if top.startswith(("dcn_pre_lv", "dcn_offset_lv", "dcn_mask_lv")):
            return [f"align_lv{lv}", top, "conv", _LEAF[leaf]]
        if top != f"dcn_lv{lv}":
            raise KeyError(key)
        return [f"align_lv{lv}", f"dcn_weight_lv{lv}" if leaf == "weight" else f"dcn_bias_lv{lv}"]
    if top.startswith("dcn_"):
        sub = _map_dcn(rest)
        if sub is None:
            raise KeyError(key)
        return [top, *sub]
    if top in ("encoder_lr", "encoder_hr"):
        return [top, *_map_lte(rest)]
    if top.startswith("forward_resblocks"):
        # the runtime's stitching blocks (no trailing underscore) keep conv1
        # and conv2; the cold-start blocks' conv2 is dead, and so is that of
        # the pyramid's forward_resblocks_lv{k}
        stitching = (not top.endswith("_") and not _is_level(top)
                     and rest[0] in ("conv1", "conv2"))
        sub = _map_resblocks(rest, stitching)
        return None if sub is None else [top, *sub]
    if top == "downsample":
        return [top, "downsample_conv", "conv", _LEAF[leaf]]
    if top in ("upsample", "upsample_post") or (top.startswith("upsample")
                                                and top[-1].isdigit()):
        # upsample0/1/2: the pyramid's per-level 2x packs
        return [top, "upsample_conv", "conv", _LEAF[leaf]]
    if top.startswith(("conv_tttf", "conv_last", "conv_hr")):
        return [top, "conv", _LEAF[leaf]]
    raise KeyError(key)


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(value, dtype=np.float32))


def convert_state_dict(state_dict: dict[str, Any], strict: bool = True
                       ) -> dict[str, torch.Tensor]:
    """Reference name -> tensor (torch or numpy) to the port's state_dict
    (float32 CPU tensors). ``strict``: raise KeyError on a name the map
    does not know; otherwise skip it and say which were skipped."""
    out: dict[str, torch.Tensor] = {}
    unused = []
    for key, val in state_dict.items():
        # only the LEADING DataParallel prefix; the reference's own save
        # replaced it everywhere, hence the basic_ remap
        if key.startswith("module."):
            key = key[len("module."):]
        if "basic_" in key and "basic_module." not in key:
            key = key.replace("basic_", "basic_module.")
        try:
            path = _path(key)
        except (KeyError, IndexError, ValueError):
            if strict:
                raise KeyError(key) from None
            unused.append(key)
            continue
        if path is None:
            continue
        if path[-1] == "kernel":
            path[-1] = "weight"
        out[".".join(path)] = _tensor(val)
    if unused:
        print(f"convert_state_dict: skipped {len(unused)} unmapped keys: {unused[:8]}...")
    return out


def load_torch_checkpoint(path: str, strict: bool = True) -> dict[str, torch.Tensor]:
    """A reference ``.pt``/``.pth`` file (tensors only; a ``state_dict``
    entry is unwrapped) as the port's state_dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return convert_state_dict(sd, strict=strict)


_SEQ_CONV = re.compile(r"^(.+)_conv(\d)$")  # conv n of a torch Sequential, by flax name


def _reference_key(key: str) -> str:
    """The reference's name of the port's ``key`` (a batch trunk's, a flow
    net's or a gen-1 pyramid's): the inverse of :func:`_path`."""
    parts = key.split(".")
    if parts[-2:-1] == ["conv"]:
        del parts[-2]  # the flax Conv wrapper
    top, mid, leaf = parts[0], parts[1:-1], parts[-1]
    if top.startswith("align_lv"):  # the pyramid's flat names, one level each
        if not mid:
            return f"dcn_lv{top[-1]}.{leaf[len('dcn_'):-len('_lvK')]}"
        (name,) = mid
        m = _SEQ_CONV.match(name)
        # dcn_block_lvK: Sequential(lrelu, conv, lrelu, conv, lrelu)
        return f"{m[1]}.{2 * int(m[2]) - 1}.{leaf}" if m else f"{name}.{leaf}"
    if leaf in ("dcn_weight", "dcn_bias"):
        return ".".join([top, *mid, "dcn", leaf[len("dcn_"):]])
    # residual trunks: the batch naming main.0 / main.2.{i}; the pyramid's
    # levels keep the runtime naming conv1 / main.1.{i}
    level = _is_level(top)
    out = [top]
    for seg in mid:
        if top.startswith("forward_resblocks") and seg == "input_conv":
            out += ["conv1"] if level else ["main", "0"]
        elif top.startswith("forward_resblocks") and re.fullmatch(r"block\d+", seg):
            out += ["main", "1" if level else "2", seg[len("block"):]]
        elif top == "spynet" and re.fullmatch(r"basic_module\d+", seg):
            out += ["basic_module", seg[len("basic_module"):], "basic_module"]
        elif top == "spynet" and re.fullmatch(r"conv\d+", seg):
            out += [seg[len("conv"):], "conv"]
        elif top.startswith("dcn_") and re.fullmatch(r"conv\d", seg):  # no_dcn's Sequential
            out.append(str(2 * int(seg[-1]) - 2))
        elif (m := _SEQ_CONV.match(seg)) and not top.startswith("forward_resblocks"):
            out += [m[1], str(2 * int(m[2]) - 2)]
        else:
            out.append(seg)
    return ".".join([*out, leaf])


def to_reference(state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's state_dict of a batch trunk (or a flow net or a gen-1
    pyramid; not the runtime trunk, whose stitching blocks take one batch
    tensor twice) under the reference's names, the tensors shared: what
    :func:`convert_state_dict` maps back onto ``state_dict`` key for key.
    Raises KeyError on a name with no reference counterpart."""
    out = {}
    for key, value in state_dict.items():
        try:
            ref = _reference_key(key)
            path = _path(ref)
        except (KeyError, IndexError, ValueError):
            ref, path = None, None
        if path is not None and path[-1] == "kernel":
            path[-1] = "weight"
        if path is None or ".".join(path) != key:
            raise KeyError(f"{key}: no reference name ({ref} maps to {path})")
        out[ref] = value
    return out
