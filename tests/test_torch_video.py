"""The video tools of the port (crfp_torch/tools/video.py) against the JAX
package's (crfp_tpu/tools/video.py) on the CPU.

- ``flow_to_color`` (with and without ``clip_flow``) and ``result_comp``
  bit-equal to JAX's on seeded arrays.
- ``combine_gifs`` (Pillow) against JAX's (imageio) on the same two GIFs,
  side by side and stacked: the same frame count and shapes, and the
  decoded frames equal. The frames hold 16 colours, so each 256-colour
  palette holds every colour exactly: the palette's rounding is 0 here.
- ``frames_to_mp4`` -> ``video_to_frames`` round trip with OpenCV: the
  frame count, the centre crop, and the frames within a mean 4 levels of
  255 (mp4v is lossy).
- The CLI's three commands take root ``gen_video.py``'s, ``png2mp4.py``'s
  and ``gif_combine.py``'s arguments with their names and defaults.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

_ROOT = Path(__file__).resolve().parents[1]


def _flow(seed=0, h=33, w=47):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, w, 2)) * 3).astype(np.float32)


@pytest.mark.parametrize("clip_flow", [None, 2.0])
def test_flow_to_color_bit_equal(clip_flow):
    from crfp_tpu.tools import video as jv

    from crfp_torch.tools import video as pv

    flow = _flow()
    flow[0, 0] = 0.0  # a still pixel
    got, want = pv.flow_to_color(flow, clip_flow), jv.flow_to_color(flow, clip_flow)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (33, 47, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pv._make_colorwheel(), jv._make_colorwheel())


def test_result_comp_bit_equal():
    from crfp_tpu.tools import video as jv

    from crfp_torch.tools import video as pv

    rng = np.random.default_rng(1)
    left, right = (rng.integers(0, 256, (20, 30, 3), dtype=np.uint8) for _ in range(2))
    for split in (0, 7, 29):
        np.testing.assert_array_equal(pv.result_comp(left, right, split),
                                      jv.result_comp(left, right, split))


def _gif_frames(seed, n, h, w):
    """``n`` frames drawn from 16 colours."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    return [palette[rng.integers(0, 16, (h, w))] for _ in range(n)]


@pytest.mark.parametrize("axis", [1, 0])
def test_combine_gifs_matches_jax(tmp_path, axis):
    from crfp_tpu.tools import video as jv

    from crfp_torch.tools import video as pv

    a, b = tmp_path / "a.gif", tmp_path / "b.gif"
    pv.frames_to_gif(_gif_frames(0, 4, 24, 32), str(a))
    pv.frames_to_gif(_gif_frames(1, 3, 20, 32 if axis == 0 else 16), str(b))
    assert len(pv.read_gif(str(a))) == 4
    pv.combine_gifs([str(a), str(b)], str(tmp_path / "port.gif"), axis=axis)
    jv.combine_gifs([str(a), str(b)], str(tmp_path / "jax.gif"), axis=axis)
    got, want = (pv.read_gif(str(tmp_path / f"{n}.gif")) for n in ("port", "jax"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((20, 48, 3) if axis == 1 else (40, 32, 3))
        np.testing.assert_array_equal(g, w)


def test_mp4_round_trip(tmp_path):
    import cv2

    from crfp_torch.tools import video as pv

    frames_dir = tmp_path / "png"
    frames_dir.mkdir()
    yy, xx = np.mgrid[0:64, 0:96]
    want = []
    for i in range(5):
        img = np.stack([(yy * 3 + i * 10) % 256, (xx * 2) % 256,
                        np.full_like(yy, 40 * i)], -1).astype(np.uint8)
        cv2.imwrite(str(frames_dir / f"{i:08d}.png"), img)
        want.append(img)
    assert pv.frames_to_mp4(str(frames_dir), str(tmp_path / "clip.mp4"), fps=20) == 5
    n = pv.video_to_frames(str(tmp_path / "clip.mp4"), str(tmp_path / "out"), (48, 64))
    assert n == 5
    got = [cv2.imread(str(tmp_path / "out" / f"{i:08d}.png")) for i in range(n)]
    for g, w in zip(got, want):
        assert g.shape == (48, 64, 3)
        d = np.abs(g.astype(np.int16) - w[8:56, 16:80].astype(np.int16)).mean()
        assert d <= 4.0, d
    with pytest.raises(FileNotFoundError):
        pv.frames_to_mp4(str(tmp_path / "out" / ".."), str(tmp_path / "none.mp4"))


def _root_args(path: Path) -> dict[str, dict]:
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            out[node.args[0].value] = {k.arg: ast.literal_eval(k.value) if not isinstance(
                k.value, ast.Name) else k.value.id for k in node.keywords}
    return out


@pytest.mark.parametrize("cmd,script", [("to_frames", "gen_video.py"), ("to_mp4", "png2mp4.py"),
                                        ("combine_gifs", "gif_combine.py")])
def test_cli_takes_the_root_scripts_arguments(cmd, script):
    from crfp_torch.tools.video import build_parser

    sub = next(a for a in build_parser()._actions if a.dest == "cmd").choices[cmd]
    got = {(a.option_strings[0] if a.option_strings else a.dest): a for a in sub._actions
           if a.dest != "help"}
    want = _root_args(_ROOT / script)
    assert set(got) == set(want), (set(got), set(want))
    for name, kw in want.items():
        a = got[name]
        assert a.default == kw.get("default"), name
        assert a.required == kw.get("required", not a.option_strings), name
        if "type" in kw:
            assert a.type.__name__ == kw["type"], name
        if "nargs" in kw:
            assert a.nargs == kw["nargs"], name
