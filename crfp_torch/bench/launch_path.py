"""What one call of a kernel dispatcher costs on the host, piece by piece.

    python -m crfp_torch.bench.launch_path

The warp kernels run for a few microseconds, so a call of their dispatcher
costs what the host spends on it. This script times, on the host's clock,
``--calls`` back-to-back calls of each piece of that path (the forward at
the serving shape of the lv warp, (1, 24, 180, 180) bf16 with f32 flow and
D 8; the backward at its training shape, (2, 24, 48, 48)) and prints the
median of ``--repeats`` such loops in microseconds per call: the pieces
(an empty Python call, ``torch.empty_like``, the operand check, the current
device, the current stream as an object and as a raw handle, the bare
foreign call), the launch helper, the
dispatcher outside and inside autograd, the backward's dispatcher, and
beside them one in-place PyTorch add. The device is synchronised after
each loop, not inside it: a piece that takes the device longer than the
host fills the launch queue and reads its device time. Ends with one
JSON line. Fails without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch



def _us_per_call(fn, calls: int, repeats: int) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    loops = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        loops.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(loops)


def run(calls: int = 2000, repeats: int = 5) -> dict:
    from crfp_torch.ops.cuda import _build, warp

    gen = torch.Generator().manual_seed(0)
    d = 8
    x = torch.randn(1, 24, 180, 180, generator=gen).cuda().to(torch.bfloat16)
    flow = (torch.randn(1, 2, 180, 180, generator=gen) * 3).cuda()
    # the backward's operands, at the training shape of the lv states
    xt = torch.randn(2, 24, 48, 48, generator=gen).cuda().to(torch.bfloat16)
    ft = (torch.randn(2, 2, 48, 48, generator=gen) * 3).cuda()
    gt = torch.randn(2, 24, 48, 48, generator=gen).cuda().to(torch.bfloat16)
    out = torch.empty_like(x)
    n, c, h, w = x.shape
    
    xg, fg = x.clone().requires_grad_(True), flow.clone().requires_grad_(True)

    fn = _build.function("flow_warp", "crfp_flow_warp", warp._ARGTYPES)
    args = (x.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c, h, w, float(d), 1)
    stream = torch.cuda.current_stream().cuda_stream
    bwd = _build.function("flow_warp_bwd", "crfp_flow_warp_bwd", warp._BWD_ARGTYPES)
    acc = torch.empty_like(xt, dtype=torch.float32)
    dx, d_flow = torch.empty_like(xt), torch.empty_like(ft)
    bwd_args = (xt.data_ptr(), ft.data_ptr(), gt.data_ptr(), acc.data_ptr(),
                dx.data_ptr(), d_flow.data_ptr(), *xt.shape, float(d), 1)
    index = x.device.index

    def through_autograd():
        with torch.enable_grad():
            warp.flow_warp_windowed(xg, fg, d)

    pieces = {
        "an empty Python call": lambda: None,
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "torch.empty_like(x, dtype=float32)":
            lambda: torch.empty_like(x, dtype=torch.float32),
        "the operand check": lambda: warp._check(x, flow),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "_build.stream_handle(index)": lambda: _build.stream_handle(index),
        "with torch.cuda.device(x.device): pass": lambda: _enter_device(x.device),
        "the bare foreign call (kernel B launched)": lambda: fn(*args, stream),
        "_build.launch (kernel B launched)":
            lambda: _build.launch("flow_warp", "crfp_flow_warp", warp._ARGTYPES,
                                  x.device, *args),
        "flow_warp_windowed, nothing requires grad": lambda: warp.flow_warp_windowed(x, flow, d),
        "flow_warp_windowed through the autograd.Function": through_autograd,
        "the bare foreign call of the backward (memset, kernel D, cast)":
            lambda: bwd(*bwd_args, stream),
        "flow_warp_backward (kernel D at k=1)":
            lambda: warp.flow_warp_backward(xt, ft, gt, d),
        
        "out.add_(1) (one PyTorch launch)": lambda: out.add_(1),
    }
    assert index == torch.cuda.current_device()
    with torch.no_grad():
        us = {name: _us_per_call(piece, calls, repeats) for name, piece in pieces.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "card": smi.stdout.strip(),
            "torch": torch.__version__, "shape": list(x.shape), "dtype": "bfloat16",
            "calls": calls, "repeats": repeats, "host_us_per_call": us}


def _enter_device(device) -> None:
    with torch.cuda.device(device):
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_path: no CUDA device", file=sys.stderr)
        return 1
    res = run(args.calls, args.repeats)
    print(f"[launch path] {res['card']}; torch {res['torch']}; x {tuple(res['shape'])} "
          f"{res['dtype']}; median of {res['repeats']} loops of {res['calls']} calls, host clock")
    for name, v in res["host_us_per_call"].items():
        print(f"[launch path] {v:8.2f} us  {name}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
