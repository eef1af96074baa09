"""Reference checkpoints onto the port (crfp_torch/params.py::convert_state_dict)
against the JAX package's converter (crfp_tpu/tools/convert_torch.py), on
the CPU, f32.

Each reference-named torch mirror of the JAX tests (v18, v18_cra,
basic_fvsr, v13/v15, no_dcn, the runtime v18, the X8 pyramid, SPyNet) goes
through the port's ``convert_state_dict``: the result must equal JAX's
conversion read through ``params.from_jax`` bit for bit (the same leaves;
OIHW kept, so no transposition on the port's side), load strictly into the
port's module (but for what the reference builds and never calls, which
the JAX tree lacks too: BasicFVSR's ``downsample`` and the runtime model's
``conv2`` of its three same-size stitching blocks) and give the mirror's outputs to
atol 1e-5 (tests/test_convert.py's tolerance). SPyNet and the v18 trunk
are also applied in JAX on the converted tree and held to the port's
outputs to 1e-5. ``load_params`` reads a ``.pt`` file written here with a
``state_dict`` wrapper, a ``module.`` prefix and the mangled ``basic_``
names equal to the direct conversion; strict conversion raises on an
unknown key and lenient conversion skips it."""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5


def _nchw_clip(a):
    return torch.from_numpy(a).permute(0, 1, 4, 2, 3)


def _inputs(seed=0, b=1, t=3, h=8, w=8, s=8):
    """tests/test_variant_parity.py::_inputs: a clip and its centre mask."""
    rng = np.random.default_rng(seed)
    lrs = rng.uniform(0, 1, (b, t, h, w, 3)).astype(np.float32)
    fvs = rng.uniform(0, 1, (b, t, h * s, w * s, 3)).astype(np.float32)
    mks = np.zeros((b, t, h * s, w * s, 1), np.float32)
    mks[:, :, 16:48, 16:48] = 1.0
    return lrs, fvs, mks


def _trunk_mirror(kind):
    """(mirror, reference state_dict, port ModelConfig kwargs)."""
    from test_full_parity import TorchCRFP_DSV
    from test_variant_parity import TorchBasicFVSR, TorchCRA, TorchNoDCN, TorchV13V15

    torch.manual_seed(0)
    if kind == "v18":
        tm, cfg = TorchCRFP_DSV(mid=16), dict(variant="v18")
    elif kind == "v18_cra":
        tm, cfg = TorchCRA(mid=16), dict(variant="v18_cra")
    elif kind == "basic_fvsr":
        tm, cfg = TorchBasicFVSR(mid=16), dict(variant="basic_fvsr", hr_dcn=False)
    elif kind in ("v13", "v15"):
        tm, cfg = TorchV13V15(mid=16, three_way=kind == "v15"), dict(variant=kind)
    else:
        tm, cfg = TorchNoDCN(mid=16), dict(variant="no_dcn", hr_dcn=False)
    sd = tm.reference_state_dict() if kind == "no_dcn" else tm.state_dict()
    return tm.eval(), sd, cfg


def _jax_converted(sd):
    """JAX's conversion, read the way the port reads a JAX tree."""
    from crfp_tpu.tools.convert_torch import convert_state_dict as jax_convert

    from crfp_torch.params import from_jax

    return from_jax(tp.flat_params(jax_convert(sd)["params"]))


def _same_state(got, want):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


# parameters a reference model builds and never calls, which the JAX tree
# (and so the port's module) does not have: BasicFVSR's downsample pack
_DEAD = {"basic_fvsr": ["downsample.downsample_conv.conv"]}


def _load(model, state, dead=()):
    """Load strictly but for the ``dead`` modules' weight and bias, which
    must be exactly the keys the model lacks."""
    res = model.load_state_dict(state, strict=False)
    assert not res.missing_keys, res.missing_keys
    assert sorted(res.unexpected_keys) == sorted(
        f"{m}.{leaf}" for m in dead for leaf in ("weight", "bias")), res.unexpected_keys


def _close(got, want, what):
    d = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert d <= ATOL, f"{what}: max|d| {d:.3e} > {ATOL}"


@pytest.mark.parametrize("kind", ["v18", "v18_cra", "basic_fvsr", "v13", "v15", "no_dcn"])
def test_trunk_mirror_converts_strictly_and_matches(kind):
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import convert_state_dict

    tm, sd, cfg = _trunk_mirror(kind)
    port_sd = convert_state_dict(sd)
    _same_state(port_sd, _jax_converted(sd))
    model = CRFP(ModelConfig(mid_channels=16, **cfg), device="cpu").eval()
    _load(model, port_sd, _DEAD.get(kind, ()))

    lrs, fvs, mks = _inputs()
    with torch.no_grad():
        want = tm(_nchw_clip(lrs), _nchw_clip(fvs), _nchw_clip(mks)).permute(0, 1, 3, 4, 2)
        got = model(*(torch.from_numpy(a) for a in (lrs, fvs, mks)))
    assert got.shape == want.shape
    _close(got, want, f"{kind}: port vs mirror")
    if kind == "v18":
        from crfp_tpu.models import CRFP as JaxCRFP
        from crfp_tpu.models import ModelConfig as JaxConfig
        from crfp_tpu.tools.convert_torch import convert_state_dict as jax_convert

        jax_out = jax.jit(JaxCRFP(JaxConfig(variant="v18", mid_channels=16)).apply)(
            jax_convert(sd), lrs, fvs, mks)
        _close(got, jax_out, "v18: port vs JAX apply of JAX's conversion")


def test_runtime_mirror_converts_and_matches():
    """The runtime trunk's names (cold-start blocks with a dead conv2,
    stitching blocks with conv1 and conv2) through the same map."""
    from runtime_mirror import TorchRuntimeV18

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.params import convert_state_dict

    torch.manual_seed(0)
    tm = TorchRuntimeV18(mid=16).eval()
    sd = tm.state_dict()
    port_sd = convert_state_dict(sd)
    _same_state(port_sd, _jax_converted(sd))
    warp = (64, 64)
    model = CRFPRuntimeV18(ModelConfig(mid_channels=16), warp_size=warp, device="cpu").eval()
    # the stitching blocks of the same-size ROI stages never call conv2
    _load(model, port_sd, [f"forward_resblocks_{i}.conv2.conv" for i in range(3)])

    lrs, fvs = tp.clip(t=3, lr_hw=(16, 24), fv=32)
    with torch.no_grad():
        # tp.clip is (t, 1, ...); the mirror takes (1, t, ...)
        want = tm(_nchw_clip(lrs.swapaxes(0, 1)), _nchw_clip(fvs.swapaxes(0, 1)),
                  warp).permute(0, 1, 3, 4, 2)[0]
        lr = [torch.from_numpy(a) for a in lrs]
        fv = [torch.from_numpy(a) for a in fvs]
        outs = []
        x_lr, x_hr = model.encode(lr[0], fv[0])
        state, out = model.step0(lr[0], x_lr, x_hr)
        outs.append(out)
        for i in range(1, len(lr)):
            x_lr, x_hr = model.encode(lr[i], fv[i])
            state, out = model.step(state, lr[i], lr[i - 1], x_lr, x_hr)
            outs.append(out)
    got = torch.cat(outs)
    assert got.shape == want.shape
    _close(got, want, "runtime v18: port vs mirror")


def test_pyramid_x8_mirror_converts_strictly_and_matches():
    from test_pyramid_parity import TorchPyramidX8

    from crfp_torch.models.pyramid import CRFPPyramidX8
    from crfp_torch.params import convert_state_dict

    torch.manual_seed(0)
    tm = TorchPyramidX8(mid=16, dg_num=16, cra=False).eval()
    with torch.no_grad():  # sampling positions stay sane, as the JAX test does
        for lvl in tm.levels:
            lvl.off.weight *= 0.05
            lvl.off.bias *= 0.05
    sd = tm.reference_state_dict()
    port_sd = convert_state_dict(sd)
    _same_state(port_sd, _jax_converted(sd))
    model = CRFPPyramidX8(16, cra=False, dg_num=16, device="cpu").eval()
    model.load_state_dict(port_sd, strict=True)

    rng = np.random.default_rng(3)
    t, h, w = 3, 8, 8
    lrs = rng.uniform(0, 1, (1, t, h, w, 3)).astype(np.float32)
    fvs = rng.uniform(0, 1, (1, t, 8 * h, 8 * w, 3)).astype(np.float32)
    mks = np.zeros((1, t, 8 * h, 8 * w, 1), np.float32)
    mks[:, :, 8:40, 16:48] = 1.0
    with torch.no_grad():
        want = tm(_nchw_clip(lrs), _nchw_clip(fvs), _nchw_clip(mks)).permute(0, 1, 3, 4, 2)
        got = model(*(torch.from_numpy(a) for a in (lrs, fvs, mks)))
    assert got.shape == want.shape == (1, t, 8 * h, 8 * w, 3)
    _close(got, want, "X8 pyramid: port vs mirror")


def test_spynet_mirror_converts_strictly_and_matches():
    from crfp_tpu.nn.flow import SPyNet as JaxSPyNet
    from crfp_tpu.tools.convert_torch import convert_state_dict as jax_convert
    from test_spynet import TorchSPyNet

    from crfp_torch.nn.flow import SPyNet
    from crfp_torch.params import convert_state_dict

    torch.manual_seed(0)
    tm = TorchSPyNet().eval()
    sd = {f"spynet.{k}": v for k, v in tm.state_dict().items()}
    port_sd = convert_state_dict(sd)  # mean and std are constants: dropped
    _same_state(port_sd, _jax_converted(sd))
    net = SPyNet().eval()
    net.load_state_dict({k[len("spynet."):]: v for k, v in port_sd.items()}, strict=True)

    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 1, (1, 36, 52, 3)).astype(np.float32)  # not /32-divisible
    supp = rng.uniform(0, 1, (1, 36, 52, 3)).astype(np.float32)
    a, b = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in (ref, supp))
    with torch.no_grad():
        want = tm(a, b).permute(0, 2, 3, 1)
        got = net(a, b).permute(0, 2, 3, 1)
    _close(got, want, "SPyNet: port vs mirror")
    jax_out = JaxSPyNet().apply({"params": jax_convert(sd)["params"]["spynet"]}, ref, supp)
    _close(got, jax_out, "SPyNet: port vs JAX apply of JAX's conversion")


def _mirror_state(kind):
    """(reference state_dict, port state_dict) of a mirror that
    ``to_reference`` names: the batch trunks, the X8 pyramid, SPyNet."""
    from crfp_torch.params import convert_state_dict

    if kind == "x8":
        from test_pyramid_parity import TorchPyramidX8

        torch.manual_seed(0)
        sd = TorchPyramidX8(mid=16, dg_num=16, cra=False).reference_state_dict()
    elif kind == "spynet":
        from test_spynet import TorchSPyNet

        torch.manual_seed(0)
        sd = {f"spynet.{k}": v for k, v in TorchSPyNet().state_dict().items()}
    else:
        sd = _trunk_mirror(kind)[1]
    return sd, convert_state_dict(sd)


@pytest.mark.parametrize("kind", ["v18", "v18_cra", "basic_fvsr", "v13", "v15", "no_dcn",
                                  "x8", "spynet"])
def test_to_reference_inverts_the_name_map(kind):
    """``to_reference`` gives back the mirror's own names for every tensor
    the port keeps (the reference's constants and dead packs aside), and
    converting them again is the identity."""
    from crfp_torch.params import _path, convert_state_dict, to_reference

    sd, port_sd = _mirror_state(kind)
    ref = to_reference(port_sd)
    kept = {k for k in sd if _path(k) is not None}
    assert set(ref) == kept, sorted(set(ref) ^ kept)
    _same_state(convert_state_dict(ref), port_sd)
    for k, v in ref.items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(KeyError, match="no reference name"):
        to_reference({**port_sd, "dcn_0.mystery.conv.weight": torch.zeros(1)})


def _reference_file_dict(sd):
    """What the reference's trainer writes: ``module.`` replaced everywhere,
    which turns ``basic_module.`` into ``basic_``, under ``state_dict``."""
    return {"state_dict": {"module." + k.replace("module.", ""): v for k, v in sd.items()}}


def test_load_params_reads_reference_pt_files(tmp_path):
    from test_spynet import TorchSPyNet

    from crfp_torch.params import convert_state_dict
    from crfp_torch.utils.params_io import load_params

    tm, sd, _ = _trunk_mirror("v18")
    torch.manual_seed(1)
    # the v18 trunk with SPyNet's names: the mangled basic_ keys
    sd = {k: v for k, v in sd.items() if not k.startswith("spynet.")}
    sd.update({f"spynet.{k}": v for k, v in TorchSPyNet().state_dict().items()})
    on_disk = _reference_file_dict(sd)
    assert any(".basic_0." in k for k in on_disk["state_dict"]), list(on_disk["state_dict"])[:4]
    want = convert_state_dict(sd)
    for name in ("model_1_1000.pt", "spynet.pth"):
        torch.save(on_disk, tmp_path / name)
        _same_state(load_params(str(tmp_path / name)), want)
    # a bare dict (pretrained flow nets) loads too
    torch.save(sd, tmp_path / "bare.pt")
    _same_state(load_params(str(tmp_path / "bare.pt")), want)
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP

    CRFP(ModelConfig(mid_channels=16, flow_net="spynet"), device="cpu").load_state_dict(
        want, strict=True)


def test_strict_raises_and_lenient_skips(capsys):
    from crfp_torch.params import convert_state_dict

    _, sd, _ = _trunk_mirror("v18")
    bad = {**sd, "not_a_module.weight": torch.zeros(1), "dcn_0.mystery.weight": torch.zeros(1)}
    with pytest.raises(KeyError, match="not_a_module"):
        convert_state_dict(bad)
    got = convert_state_dict(bad, strict=False)
    _same_state(got, convert_state_dict(sd))
    assert "skipped 2 unmapped keys" in capsys.readouterr().out


def test_cli_writes_the_npz_both_packages_read(tmp_path):
    from crfp_tpu.utils.params_io import load_params as jax_load

    from crfp_torch.params import from_jax
    from crfp_torch.params import convert_state_dict
    from crfp_torch.utils.params_io import load_params

    _, sd, _ = _trunk_mirror("no_dcn")
    torch.save({"state_dict": sd}, tmp_path / "ref.pt")
    out = tmp_path / "out.npz"
    r = subprocess.run([sys.executable, "-m", "crfp_torch.tools.convert_torch",
                        str(tmp_path / "ref.pt"), str(out)], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "parameters" in r.stdout
    want = convert_state_dict(sd)
    _same_state(load_params(str(out)), want)
    _same_state(from_jax(tp.flat_params(jax_load(str(out)))), want)
