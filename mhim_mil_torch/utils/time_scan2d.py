"""K5's time on the card at the 2dmamba path's shapes.

``python -m mhim_mil_torch.utils.time_scan2d [--repeats 3]``

Times ``selective_scan_2d_fused`` at the BLCA grid ``[1, 275, 381, 256]``
and the serving raster grid ``[4, 101, 102, 256]``, N 16, fp32 and bf16
inputs, with the operands of :func:`operands` (which ``chip_smoke.py``
uses too). Per shape: the median of 20 CUDA-event timings of one call
after 3 warm-ups, and the profiler's kernel time per call (mean of 10),
``--repeats`` times in turn; the card's name and power limit first. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops.scan2d import selective_scan_2d_fused

SHAPES = {"BLCA": (1, 275, 381), "serving": (4, 101, 102)}
ED, N = 256, 16


def operands(bs, h, w, dtype, gen, n=N):
    """K5's operands as the 2D MambaBlock gives them, on the card: x and
    Δ = 0.1·softplus(normal) (as ``pallas_hw_check.py:148-155`` draws them)
    ``[Bs, H, W, 256]``, B and C slices of one ``[.., 8 + 2·n]`` projection,
    A_log = log(1..n) per channel, D."""
    x = torch.randn(bs, h, w, ED, device="cuda", generator=gen)
    delta = 0.1 * torch.nn.functional.softplus(torch.randn(bs, h, w, ED, device="cuda", generator=gen))
    dbc = torch.randn(bs, h, w, 8 + 2 * n, device="cuda", generator=gen)
    a_log = torch.log(torch.arange(1, n + 1, device="cuda", dtype=torch.float32)).expand(ED, n).contiguous()
    d = torch.randn(ED, device="cuda", generator=gen)
    x, delta, dbc = (t.to(dtype) for t in (x, delta, dbc))
    return x, delta, a_log, dbc[..., 8:8 + n], dbc[..., 8 + n:], d


def event_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def kernel_ms(fn, iters=10):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / iters / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(name, dtype, operands(*shape, dtype, gen)) for name, shape in SHAPES.items()
             for dtype in (torch.float32, torch.bfloat16)]
    for rep in range(args.repeats):
        for name, dtype, ops in cases:
            fn = lambda: selective_scan_2d_fused(*ops)
            print(f"K5 {name} {tuple(ops[0].shape)} {str(dtype).split('.')[-1]} repeat {rep}: "
                  f"{event_ms(fn):.4f} ms (kernel {kernel_ms(fn):.4f} ms)", flush=True)


if __name__ == "__main__":
    main()
