"""The pyramid_x8 family: CRFP's first-generation full pyramid ``MRCF_x8``
(https://github.com/eugenelet/CRFP, ``model/CRFP_runtime.py:1556-2335``) as
the benchmark builds it, the port beside its plain reference.

What is measured, from a configuration file's ``model`` fields, in its
``dtype``: the port's ``crfp_torch.models.pyramid.CRFPPyramidX8`` served
frame by frame through its NHWC ``encode(lr, fv, mk)``, ``step0`` and
``step``, eval mode, against ``benchmark/reference/pyramid.py::PyramidX8``
(unclamped and plain only: ``cra`` false, ``dcn_window`` null).

The stream kind hands a family's model ``encode(lr, fv)``; here ``fv`` is
the full-size fovea frame with its mask as a fourth channel (made at set-up
by :func:`stream_inputs`), and the served model's ``encode`` splits the two
channels' views apart for the port's ``encode(lr, fv, mk)``, with no
arithmetic. The port's weights are the benchmark's seeded ones, loaded
strictly under the reference's parameter names, each level's DCN weight and
bias renamed to the port's ``dcn_weight_lv{k}`` / ``dcn_bias_lv{k}``.
"""

from __future__ import annotations

import re

import torch

from benchmark import manifest
from benchmark.reference.pyramid import PyramidX8

_DCN_PARAM = re.compile(r"align_lv(\d)\.(dcn_weight|dcn_bias)\Z")


def _checked(cfg: dict) -> dict:
    m = cfg["model"]
    if m["cra"] or m["dcn_window"] is not None or m["scale"] != PyramidX8.SCALE:
        raise ValueError("the pyramid_x8 reference is MRCF_x8: cra false, dcn_window null, "
                         "scale 8")
    return m


def port_name(name: str) -> str:
    """The port's name of the reference's parameter ``name``."""
    return _DCN_PARAM.sub(lambda mt: f"align_lv{mt[1]}.{mt[2]}_lv{mt[1]}", name)


def stream_reference(cfg: dict, mix: dict) -> PyramidX8:
    """The plain MRCF_x8 on the meta device (``encode``, ``step0``, ``step``;
    NCHW)."""
    m = _checked(cfg)
    return PyramidX8(m["mid_channels"], m["dg_num"], m["max_residue_magnitude"])


class Served:
    """The port's pyramid behind the stream kind's calls: ``encode(lr, fv)``
    with ``fv`` (N, H, W, 4) the fovea frame and its mask."""

    def __init__(self, model):
        self.model = model

    def encode(self, lr, fv):
        return self.model.encode(lr, fv[..., :3], fv[..., 3:])

    def step0(self, lr, x_lr, x_hr):
        return self.model.step0(lr, x_lr, x_hr)

    def step(self, state, lr, pre_lr, x_lr, x_hr):
        return self.model.step(state, lr, pre_lr, x_lr, x_hr)


def stream_program(cfg: dict, mix: dict, weights: dict[str, torch.Tensor], device) -> Served:
    """The port's CRFPPyramidX8 on ``device`` in the configuration's dtype,
    eval, with ``weights`` loaded strictly."""
    from crfp_torch.models.pyramid import CRFPPyramidX8

    m = _checked(cfg)
    model = CRFPPyramidX8(m["mid_channels"], cra=False, dg_num=m["dg_num"],
                          max_residue_magnitude=m["max_residue_magnitude"], dcn_window=None,
                          device=device)
    model.load_state_dict({port_name(k): v for k, v in weights.items()}, strict=True)
    return Served(model.to(manifest.DTYPES[cfg["dtype"]]).eval())


def stream_inputs(pool: dict, mix: dict) -> dict:
    """Each pool frame's 'lr' as the pool holds it and 'fv' (P, V, sh, sw, 4):
    the full-size fovea frame, the pool's top-left crop in place and zeros
    elsewhere, with its mask (1 on the crop) as the fourth channel."""
    lr, crop = pool["lr"], pool["fv"]
    p, v, h, w, _ = lr.shape
    s = mix["scale"]
    fh, fw = crop.shape[2:4]
    fv = crop.new_zeros(p, v, h * s, w * s, 4)
    fv[:, :, :fh, :fw, :3] = crop
    fv[:, :, :fh, :fw, 3] = 1
    return {"lr": lr, "fv": fv}


def state_nchw(state: torch.Tensor) -> torch.Tensor:
    """The port's carried state (lv3, NHWC) in the reference's form: NCHW
    float32."""
    return state.permute(0, 3, 1, 2).float()
