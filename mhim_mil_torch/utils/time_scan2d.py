"""K5's time on the card at the 2dmamba path's shapes.

``python -m mhim_mil_torch.utils.time_scan2d [--repeats 3]``

Times ``selective_scan_2d_fused`` at the BLCA grid ``[1, 275, 381, 256]``
and the serving raster grid ``[4, 101, 102, 256]``, N 16, fp32 and bf16
inputs; at the BLCA grid with N 32 (two launches of 16 states); on rows
of 500, 700, 1,000 and 1,100 columns (``[1, 64, W, 256]``, N 16, fp32 and
bf16: the cluster layouts of 4-channel blocks); and on rows of 1,500,
2,100 and 4,200 columns (``[1, 64, W, 256]``, N 16, fp32: the wide
kernel), with the operands of :func:`operands` (which ``chip_smoke.py``
uses too). Per shape: the median of 20 CUDA-event timings of one call
after 3 warm-ups, and the profiler's kernel time per call over 10 calls
(each kernel's mean record times its launches a call, since the profiler
now and then returns fewer records than there were launches; the records
it returned are printed beside it), ``--repeats`` times in turn; the
card's name and power limit first, and each shape's cluster layout
(``ops/scan2d.scan_plan``). Needs a CUDA card. The
script runs in a checkout of an earlier tree too (copied there), timing
that tree's kernel, so that two trees can be timed in turns in one call.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import scan2d
from ..ops.scan2d import selective_scan_2d_fused

SHAPES = {"BLCA": (1, 275, 381), "serving": (4, 101, 102)}
ROWS = (500, 700, 1000, 1100)  # columns of the cluster kernel's 4-channel rows, 64 of them
WIDE = (1500, 2100, 4200)  # columns of the wide kernel's rows, 64 of them
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


def per_call_us(events, calls):
    """Each device event's time a call, ``{key: us}``: its mean record times
    its launches a call, ``max(1, round(count / calls))``, since the
    profiler now and then returns fewer records than there were launches;
    and the records returned against the records that many launches make."""
    per = {e.key: e.self_device_time_total / max(1, e.count) * max(1, round(e.count / calls)) for e in events}
    seen = sum(e.count for e in events)
    return per, seen, calls * sum(max(1, round(e.count / calls)) for e in events)


def kernel_ms(fn, iters=10):
    """The device time of one call (:func:`per_call_us`), and the kernel
    records the profiler returned for the ``iters`` calls."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    per, seen, _ = per_call_us(events, iters)
    return sum(per.values()) / 1e3, seen


def layout(ops) -> str:
    """The shape's cluster layout, where this tree's K5 has a plan."""
    plan_fn = getattr(scan2d, "scan_plan", None)
    if plan_fn is None:
        return "layout: this tree has no cluster plan"
    x, a_log = ops[0], ops[2]
    plan = plan_fn(x.shape[2], min(a_log.shape[-1], 16), x.element_size())
    if plan is None:
        return "layout: the wide kernel"
    return (f"layout: G {plan.group}, S {plan.cluster}, P {plan.runs}, R {plan.run}: {plan.threads} threads, "
            f"{plan.blocks(x.shape[0], x.shape[-1])} blocks")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(name, n, operands(*shape, dtype, gen, n)) for name, shape in SHAPES.items()
             for dtype in (torch.float32, torch.bfloat16) for n in ((N, 32) if name == "BLCA" else (N,))
             if n == N or dtype == torch.float32]
    cases += [(f"row {w}", N, operands(1, 64, w, dtype, gen)) for w in ROWS
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [(f"wide {w}", N, operands(1, 64, w, torch.float32, gen)) for w in WIDE]
    for name, n, ops in cases:
        print(f"K5 {name} {tuple(ops[0].shape)} N {n} {str(ops[0].dtype).split('.')[-1]}: {layout(ops)}", flush=True)
    for rep in range(args.repeats):
        for name, n, ops in cases:
            fn = lambda: selective_scan_2d_fused(*ops)
            ev = event_ms(fn)
            dev, records = kernel_ms(fn)
            print(f"K5 {name} {tuple(ops[0].shape)} N {n} {str(ops[0].dtype).split('.')[-1]} repeat {rep}: "
                  f"{ev:.4f} ms (kernel {dev:.4f} ms, {records} kernel records for 10 calls)", flush=True)


if __name__ == "__main__":
    main()
