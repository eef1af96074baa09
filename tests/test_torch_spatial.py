"""Height-sharded frames (crfp_torch.parallel.spatial) on the CPU, in gloo
ranks spawned on localhost (tests/torch_dist.py), against the JAX package.

- ``halo_exchange``, at 2 and 4 ranks, equals JAX's ``halo_exchange``
  under ``shard_map`` bit for bit on tests/test_spatial.py's input (and the
  replicate edge repeats the band's own edge row); ``sharded_conv3x3``
  equals ``F.conv2d`` and JAX's ``sharded_conv3x3`` to 1e-5 on
  tests/test_spatial.py's shapes. ``shard_frame_height`` refuses 90 rows
  over 4 ranks and takes 92, as JAX's does over 4 of the conftest's 8
  virtual devices: the heights the port splits are the ones JAX splits.
- ``SpatialStreamingRunner`` over two ranks, on tests/test_spatial.py's case
  (v18 mid 16, LR 32x16, 3 frames) with random offset/mask heads, matches
  JAX's ``StreamingRunner`` frame by frame to 2e-4 abs / 1e-4 rel,
  unclamped and with windows 8/32, and the port's own ``StreamingRunner``
  to 1e-5; ``clear_states`` restarts the clip. With every halo row forced
  to zero the frames differ, so the exchange carries the result.
- The anchored runner (``dcn_anchor``, ``hr_s2d``, windows 8/32, the flow
  past ±32 HR px) over two ranks at LR 36x16, where a 32-row cell of the HR
  warp's grid spans the two bands, matches JAX's anchored ``StreamingRunner``
  (its dispatch routed to the anchored Pallas kernels) and the port's own at
  the same tolerances; the clamped model misses JAX's frames, and with the
  anchored calls' side operands zero outside the band the frames differ.
  The anchored grids do not depend on the height.
- Operations the runner does not cover raise, and an LR height the ranks
  do not divide is refused.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist as td  # noqa: E402
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

MID, H, W, S, T = 16, 32, 16, 8, 3


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange_and_sharded_conv_match_jax(world, tmp_path):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from crfp_tpu.parallel import data_parallel_mesh
    from crfp_tpu.parallel.spatial import halo_exchange, shard_frame_height, sharded_conv3x3

    x = np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
    rng = np.random.default_rng(0)
    cx = rng.standard_normal((2, 64, 32, 8)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 8, 16)) * 0.1).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    weight = np.ascontiguousarray(k.transpose(3, 2, 0, 1))
    out = td.run_ranks(td.halos, world, tmp_path, x, cx, weight, b)

    mesh = data_parallel_mesh(world)
    want = np.asarray(shard_map(lambda xb: halo_exchange(xb, 1, "data"), mesh=mesh,
                                in_specs=P(None, "data", None, None),
                                out_specs=P(None, "data", None, None))(jnp.asarray(x)))
    rows = 16 // world
    want = want.reshape(world, rows + 2)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["halo"].reshape(-1), want[r], err_msg=f"rank {r}")
        rep = o["halo_replicate"].reshape(-1)
        np.testing.assert_array_equal(rep[1:-1], want[r][1:-1])
        assert rep[0] == (x[0, 0, 0, 0] if r == 0 else want[r][0])
        assert rep[-1] == (x[0, -1, 0, 0] if r == world - 1 else want[r][-1])

    got = np.concatenate([o["conv"] for o in out], axis=1)
    full = F.conv2d(torch.from_numpy(cx).permute(0, 3, 1, 2), torch.from_numpy(weight),
                    torch.from_numpy(b), padding=1).permute(0, 2, 3, 1).numpy()
    jgot = np.asarray(sharded_conv3x3(shard_frame_height(jnp.asarray(cx), mesh),
                                      jnp.asarray(k), jnp.asarray(b), mesh))
    np.testing.assert_allclose(got, full, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, jgot, atol=1e-5, rtol=1e-5)

    # the heights each side splits: JAX's device_put refuses what the port refuses
    jax_rows = {}
    for h in (90, 92):
        try:
            xs = shard_frame_height(jnp.zeros((1, h, 160, 3)), mesh)
            jax_rows[h] = xs.addressable_shards[0].data.shape
        except ValueError:
            jax_rows[h] = None
    for h in (90, 92):
        port = out[0][f"rows{h}"]
        if jax_rows[h] is None:
            assert isinstance(port, str) and "does not divide evenly" in port, (h, port)
        else:
            assert port == tuple(jax_rows[h]), (h, port, jax_rows[h])
    assert (jax_rows[90] is None) == (world == 4)


def _clip(h=H):
    rng = np.random.default_rng(0)
    lrs = rng.uniform(0, 1, (T, 1, h, W, 3)).astype(np.float32)
    fvs = rng.uniform(0, 1, (T, 1, h * S, W * S, 3)).astype(np.float32)
    mks = (rng.uniform(0, 1, (T, 1, h * S, W * S, 1)) > 0.5).astype(np.float32)
    return lrs, fvs, mks


@pytest.fixture(scope="module")
def weights():
    """JAX init leaves of v18 mid 16 with random offset/mask heads."""
    from crfp_tpu.models import CRFP, ModelConfig

    lrs, fvs, mks = _clip()
    model = CRFP(ModelConfig(variant="v18", mid_channels=MID))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *(
        jnp.asarray(a.transpose(1, 0, 2, 3, 4)) for a in (lrs, fvs, mks)))
    return tp.perturb_heads(tp.flat_params(params), seed=1)


@pytest.mark.parametrize("windows", [None, (8, 32)], ids=["unclamped", "windows_8_32"])
def test_spatial_runner_matches_jax_streaming_runner(windows, weights, tmp_path):
    from crfp_tpu.models import CRFP, ModelConfig
    from crfp_tpu.models.streaming import StreamingRunner

    cfg = {} if windows is None else {"dcn_window": windows[0], "dcn_window_hr": windows[1]}
    lrs, fvs, mks = _clip()
    out = td.run_ranks(td.spatial_frames, 2, tmp_path, weights, MID, cfg, lrs, fvs, mks)
    jrun = StreamingRunner(CRFP(ModelConfig(variant="v18", mid_channels=MID, **cfg)),
                           tp.unflatten(weights), donate=False)
    want = [np.asarray(jrun(jnp.asarray(lrs[i]), jnp.asarray(fvs[i]), jnp.asarray(mks[i])))
            for i in range(T)]
    for r, o in enumerate(out):
        d_port = max(float(np.abs(g - w).max()) for g, w in zip(o["got"], o["want"]))
        d_jax = max(float(np.abs(g - w).max()) for g, w in zip(o["got"], want))
        print(f"rank {r} {windows}: max|d| against the port's StreamingRunner {d_port:.3e}, "
              f"against JAX's {d_jax:.3e}")
        for i in range(T):
            assert o["got"][i].shape == (1, H * S, W * S, 3)
            np.testing.assert_allclose(o["got"][i], want[i], atol=2e-4, rtol=1e-4,
                                       err_msg=f"rank {r} frame {i}")
            np.testing.assert_allclose(o["got"][i], o["want"][i], atol=1e-5, rtol=0,
                                       err_msg=f"rank {r} frame {i}")
        np.testing.assert_array_equal(o["again"], o["got"][0])
    np.testing.assert_array_equal(out[0]["got"][-1], out[1]["got"][-1])


def test_spatial_runner_without_halos_differs(weights, tmp_path):
    lrs, fvs, mks = _clip()
    cfg = {"dcn_window": 8, "dcn_window_hr": 32}
    out = td.run_ranks(td.spatial_frames, 2, tmp_path, weights, MID, cfg, lrs, fvs, mks, True)
    d = max(float(np.abs(g - w).max()) for g, w in zip(out[0]["got"], out[0]["want"]))
    print(f"with the halo rows forced to zero: max|d| {d:.3e}")
    assert d > 1e-2, d


# The anchored runner (bench.py's _DEPLOY anchoring: windows 8/32, hr_s2d,
# dcn_anchor) at an LR height whose bands split a cell of the HR warp's
# grid: 18 LR rows a rank are 144 HR rows, and the 32-row cell at HR rows
# 128-159 spans the two bands. The flow is pushed past the HR window.
ANCHOR_H = 36
ANCHOR_CFG = {"dcn_window": 8, "dcn_window_hr": 32, "hr_s2d": True, "dcn_anchor": True}


@pytest.fixture(scope="module")
def anchored_weights(weights):
    return tp.set_flow_bias(weights, dy=4.6, dx=-5.3)


def test_spatial_runner_anchored_matches_jax_streaming_runner(anchored_weights, tmp_path,
                                                              monkeypatch):
    """Two ranks of the anchored model against JAX's anchored
    ``StreamingRunner`` (its dispatch routed to the anchored Pallas kernels,
    ``torch_parity.anchored_jax_dispatch``) and the port's own, at the
    tolerances of the unanchored runs; a cell of the HR warp's grid spans
    the bands, and the HR motion passes the window."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.ops.anchor import warp_geometry
    from crfp_tpu.models import CRFP, ModelConfig as JConfig
    from crfp_tpu.models.streaming import StreamingRunner

    cfg = ModelConfig(mid_channels=MID, **ANCHOR_CFG)
    band_rows = ANCHOR_H * S // 2
    geom = warp_geometry(ANCHOR_H * S, W * S, cfg.last_channels, 32, bf16=False,
                         s2d=cfg.anchor_s2d)
    assert band_rows % geom.band, (band_rows, geom.band)  # a cell spans the bands
    lrs, fvs, mks = _clip(ANCHOR_H)
    out = td.run_ranks(td.spatial_frames, 2, tmp_path, anchored_weights, MID, ANCHOR_CFG,
                       lrs, fvs, mks)
    tp.anchored_jax_dispatch(monkeypatch)
    jrun = StreamingRunner(CRFP(JConfig(variant="v18", mid_channels=MID, **ANCHOR_CFG)),
                           tp.unflatten(anchored_weights), donate=False)
    want = [np.asarray(jrun(jnp.asarray(lrs[i]), jnp.asarray(fvs[i]), jnp.asarray(mks[i])))
            for i in range(T)]
    for r, o in enumerate(out):
        d_jax = max(float(np.abs(g - w).max()) for g, w in zip(o["got"], want))
        print(f"rank {r} anchored: max|d| against JAX's StreamingRunner {d_jax:.3e}")
        for i in range(T):
            assert o["got"][i].shape == (1, ANCHOR_H * S, W * S, 3)
            np.testing.assert_allclose(o["got"][i], want[i], atol=2e-4, rtol=1e-4,
                                       err_msg=f"rank {r} frame {i}")
            np.testing.assert_allclose(o["got"][i], o["want"][i], atol=1e-5, rtol=0,
                                       err_msg=f"rank {r} frame {i}")
        np.testing.assert_array_equal(o["again"], o["got"][0])
    # the clamp misses JAX's anchored frames: the anchors carry the result
    from crfp_torch.models.streaming import StreamingRunner as PortRunner

    clamp = PortRunner(td.torch_crfp(anchored_weights, MID, dcn_window=8, dcn_window_hr=32))
    clamped = [clamp(lrs[i], fvs[i], mks[i]).numpy() for i in range(2)]
    miss = float(np.abs(clamped[1] - want[1]).max())
    print(f"the clamped model against JAX's anchored frame 1: max|d| {miss:.3e}")
    assert miss > 1e-2, miss


def test_spatial_runner_anchored_needs_the_whole_side_operands(anchored_weights, tmp_path):
    """With an anchored call's offsets, mask and flow zero outside the band
    (the unanchored calls' side operands), a cell that spans the bands
    averages over zeros. Two ranks of the anchored warp and DCN on 32-row
    cells: the whole side operands give the whole frame's result exactly,
    the zeroed ones miss it by more than 0.1. The frames of the anchored
    runner then leave the one-process runner's beyond the 1e-5 that holds
    them with the whole side operands (the HR warp's output reaches the
    frame only through dcn_3's offset heads)."""
    lrs, fvs, mks = (a[:2] for a in _clip(ANCHOR_H))
    out = td.run_ranks(td.anchored_side_rows, 2, tmp_path, anchored_weights, MID, ANCHOR_CFG,
                       lrs, fvs, mks)
    exact, zeroed = [o["exact"] for o in out], [o["zeroed"] for o in out]
    print(f"anchored ops on bands: whole side operands {exact}, zeroed {zeroed}")
    for o in exact:
        assert o == {"warp": 0.0, "dcn": 0.0}, o
    for key in ("warp", "dcn"):
        assert max(o[key] for o in zeroed) > 0.1, (key, zeroed)
    frames = out[0]["frames"]
    d = max(float(np.abs(g - w).max()) for g, w in zip(frames["got"], frames["want"]))
    print(f"frames with the side operands zero outside the band: max|d| {d:.3e}")
    assert d > 1e-5, d


@pytest.mark.parametrize("mid", [16, 32])
def test_anchored_grids_do_not_depend_on_the_height(mid):
    """The anchored cell grid (crfp_tpu/ops/pallas/dcn.py:816-909: the
    request, its quanta and the VMEM guard, which reads no height) is the
    same from a band as from the frame, for dcn_3 and the HR warp in every
    form the models build them: so the geometry a model builds on its band
    in the runner is the frame's."""
    from crfp_torch.ops import anchor as an

    c = mid // 8  # dcn_3's and the HR state's channels
    for frame, band in ((720, 360), (720, 180), (ANCHOR_H * S, ANCHOR_H * S // 2)):
        for bf16 in (False, True):
            for fullgrad in (False, True):
                for s2d in (1, 4):
                    def warp(h):
                        return an.warp_geometry(h, 1280, c, 32, bf16=bf16, s2d=s2d,
                                                fullgrad=fullgrad)
                    assert warp(band) == warp(frame)
                    x = torch.zeros(1, c, band, 64, dtype=torch.bfloat16 if bf16 else
                                    torch.float32)
                    assert an.hr_warp_geometry(x, 32, True, s2d, fullgrad) == warp(frame)

                def dcn3(h):
                    return an.dcn_geometry(h, 1280, c, c, 1, 3, 32, bf16=bf16,
                                           shared_taps=True, shared_mask=True,
                                           fullgrad=fullgrad)
                assert dcn3(band) == dcn3(frame)


def test_uncovered_operations_raise(tmp_path):
    out = td.run_ranks(td.refusals, 2, tmp_path)
    for o in out:
        assert o.pop("passes") == (1, 2, 2, 6, 5)
        uneven = o.pop("uneven")
        assert uneven and "do not divide evenly over 2 ranks" in uneven, uneven
        for name, msg in o.items():
            assert msg and "not covered on a band of rows" in msg, (name, msg)
