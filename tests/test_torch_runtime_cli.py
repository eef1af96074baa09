"""The runtime bench's per-stage mode and the two latency CLIs of the port
(crfp_torch/bench/runtime.py, crfp_torch/tools/test_runtime.py,
crfp_torch/tools/bench.py) on the CPU.

- ``run_runtime_bench(fused=False)`` at a tiny size returns the three
  stage keys of the JAX harness (flow, enc, step), ``fused=True`` none;
  without a card both raise unless asked for the CPU.
- The CLIs take root ``test_runtime.py``'s flags with the same names,
  types and defaults, and root ``bench.py``'s three protocols, read from
  the root scripts' source (``_DEPLOY`` anchored, as the root one);
  ``--dcn_anchor`` runs anchored HR windows, the TPU layout flags are
  logged as having no effect, ``--model_path`` goes through
  ``load_params``.
- ``CRFPRuntimeV18.compute_flow`` equals the JAX model's on the same
  weights (the port's seeded init through ``to_jax``) to 1e-5.
"""

import ast
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)

_ROOT = Path(__file__).resolve().parents[1]
# a tiny slice: LR 64x64 (the 512 preset), warp 64^2, mid 8
TINY = dict(preset="512", warp_size=(64, 64), mid_channels=8, t=2, repeat_time=2,
            warm_up=1)
TINY_ARGV = ["--cpu", "--preset", "512", "--warp", "64", "--mid", "8", "--reps", "2",
             "--warmup", "1", "--t", "2"]


def _root_flags(path: Path) -> dict[str, dict]:
    """{flag: keyword arguments} of every ``add_argument`` in a root script,
    the keywords as literals (type as its name)."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {}
            for k in node.keywords:
                if k.arg == "help":
                    continue
                kw[k.arg] = (k.value.id if isinstance(k.value, ast.Name)
                             else ast.literal_eval(k.value))
            out[node.args[0].value] = kw
    return out


def test_per_stage_mode_returns_the_three_stages():
    from crfp_torch.bench.runtime import STAGES, run_runtime_bench

    res = run_runtime_bench(fused=False, device="cpu", **TINY)
    assert tuple(res.stage_seconds) == STAGES == ("flow", "enc", "step")
    assert all(v > 0 for v in res.stage_seconds.values()), res.stage_seconds
    assert res.device == "cpu" and res.peak_bytes is None
    assert res.sec_per_frame > 0 and res.frames_per_sec == pytest.approx(1 / res.sec_per_frame)
    fused = run_runtime_bench(device="cpu", **TINY)
    assert fused.stage_seconds == {}
    assert "flow" in str(res) and "flow" not in str(fused)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_stage"])
def test_bench_needs_a_card_unless_asked_for_the_cpu(fused):
    from crfp_torch.bench.runtime import run_runtime_bench

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_runtime_bench(fused=fused, **TINY)


def test_test_runtime_takes_the_root_flags_and_defaults():
    from crfp_torch.tools.test_runtime import build_parser

    want = _root_flags(_ROOT / "test_runtime.py")
    actions = {a.option_strings[0]: a for a in build_parser()._actions if a.option_strings
               and a.option_strings[0] != "-h"}
    assert set(actions) == set(want), set(actions) ^ set(want)
    for flag, kw in want.items():
        a = actions[flag]
        assert a.default == kw.get("default", False if kw.get("action") == "store_true"
                                   else None), flag
        if "type" in kw:
            assert a.type.__name__ == kw["type"], flag
        if "choices" in kw:
            assert list(a.choices) == kw["choices"], flag
    args = build_parser().parse_args([])
    assert (args.preset, args.warp, args.mid, args.reps, args.warmup, args.t) == (
        "1080p", 720, 32, 30, 10, 5)
    assert not args.fused and args.dcn_window is None and args.model_path is None


def test_bench_runs_the_root_protocols():
    from crfp_torch.tools import bench

    calls = []
    tree = ast.parse((_ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "run_runtime_bench":
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords if k.arg}
            calls.append((kw["preset"], tuple(kw["warp_size"]), kw["repeat_time"],
                          kw["warm_up"]))
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "_DEPLOY":
            deploy = {k.arg: ast.literal_eval(k.value) for k in node.value.keywords}
    # the JSON line's metric names, the headline first (a breadth-first walk)
    metrics = [v.value for d in ast.walk(tree) if isinstance(d, ast.Dict)
               for k, v in zip(d.keys, d.values)
               if isinstance(k, ast.Constant) and k.value == "metric"]
    assert [p[1:] for p in bench.PROTOCOLS] == calls
    assert [p[0] for p in bench.PROTOCOLS] == metrics
    # the JAX _DEPLOY, anchored, less its one TPU layout (hr_s2d selects the
    # anchored cell grid)
    tpu_only = {"emit_s2d"}
    assert bench._DEPLOY == {k: v for k, v in deploy.items() if k not in tpu_only}
    assert bench._DEPLOY["dcn_anchor"] and bench._DEPLOY["hr_s2d"]
    assert "dcn_anchor" in bench.CONFIG and "no emit_s2d" in bench.CONFIG
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main([])


def test_dcn_anchor_raises_and_layout_flags_are_logged(capsys, monkeypatch):
    """``--dcn_anchor`` runs the anchored HR windows (the model the bench
    builds carries it, and ``--hr_s2d`` is then logged as the cell grid's
    selector); the layout flags alone are logged as having no effect."""
    import crfp_torch.bench.runtime as br
    from crfp_torch.tools.test_runtime import main

    built = []
    build = br.build_model
    monkeypatch.setattr(br, "build_model", lambda *a, **k: built.append(build(*a, **k)) or
                        built[-1])
    res = main(TINY_ARGV + ["--dcn_anchor", "--hr_s2d", "--dcn_window_hr", "16", "--fused"])
    cfg = built[-1][0].cfg
    assert cfg.dcn_anchor and cfg.hr_s2d and cfg.dcn_window_hr == 16
    assert "--hr_s2d: the anchored HR ops take the cell grid" in capsys.readouterr().out
    assert res.device == "cpu" and res.frames_per_sec > 0
    res = main(TINY_ARGV + ["--hr_s2d", "--lv3_s2d", "--emit_s2d", "--fused"])
    out = capsys.readouterr().out
    for flag in ("--hr_s2d", "--lv3_s2d", "--emit_s2d"):
        assert f"{flag}: a TPU layout of the JAX package, the same math; no effect" in out
    assert res.stage_seconds == {} and res.device == "cpu"


def test_model_path_goes_through_load_params(tmp_path, capsys):
    """A seeded batch-trunk checkpoint at mid 8 as ``.npz``, adapted onto
    the runtime trunk."""
    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.crfp import CRFP
    from crfp_torch.params import save_npz
    from crfp_torch.tools.test_runtime import main

    path = tmp_path / "v18_mid8.npz"
    save_npz(CRFP(ModelConfig(mid_channels=8), device="cpu", seed=3).state_dict(), str(path))
    res = main(TINY_ARGV + ["--model_path", str(path)])
    out = capsys.readouterr().out
    assert f"loaded {path}" in out and "runtime-only leaves kept at init" in out
    assert tuple(res.stage_seconds) == ("flow", "enc", "step")


def test_compute_flow_matches_jax():
    from crfp_tpu.models.runtime import CRFPRuntimeV18 as JaxRuntime

    from crfp_torch.models.config import ModelConfig
    from crfp_torch.models.runtime import CRFPRuntimeV18
    from crfp_torch.params import to_jax

    warp = (64, 96)
    model = CRFPRuntimeV18(ModelConfig(mid_channels=8), warp_size=warp, device="cpu",
                           seed=5).eval()
    flat = to_jax(model.state_dict())
    rng = np.random.default_rng(0)
    cur, prev = (rng.uniform(0, 1, (1, 16, 24, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = model.compute_flow(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (cur, prev)))
    jm = tp.jax_model(warp=warp, mid_channels=8)
    want = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=JaxRuntime.compute_flow))(
        tp.unflatten(flat), cur, prev)
    assert got.shape == (1, 2, 8, 12)
    d = float(np.abs(got.permute(0, 2, 3, 1).numpy() - np.asarray(want)).max())
    assert d <= 1e-5, d
