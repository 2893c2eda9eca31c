"""Where a flagship MHIM train step's time goes on the card.

``python -m mhim_mil_torch.utils.profile_train [--baseline selfattn] [--steps 5]``

Builds MHIM from ``config/mhim_c16.yaml`` at input_dim 1024 with random
weights (seed 0), takes 3 warm-up steps under the default bf16 policy on a
batch of 4 bags of 10,240 instances (two of them ragged, 8,000 and 6,000),
then profiles ``--steps`` steps with ``torch.profiler``. Prints the host-clock
time per step, the device time per step and its share of the wall time (the
device's busy share; each kernel's mean record times its launches a step,
since the profiler now and then drops a record, and a shortfall is
printed), the device time of each stage of the step (the
``record_function`` ranges of ``make_mhim_train_step``), the peak device
memory of a step, and the 20 kernels that take the most device time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..config import load_config
from ..engine.steps import make_mhim_train_step
from ..engine.train_state import create_mhim_state
from ..models import build_model
from .time_scan2d import by_kind, kernel_id, per_call_us

STAGES = ("mhim.teacher", "mhim.student", "mhim.backward", "mhim.update")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default="selfattn", choices=("selfattn", "attn"))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    b, n, steps, spe = 4, 10240, args.steps, 8

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(["-c", "config/mhim_c16.yaml"], input_dim=1024, baseline=args.baseline)
    model, _ = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    state = create_mhim_state(cfg, model, spe, seed=0, device="cuda")
    step = make_mhim_train_step(cfg, spe, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = torch.tensor([n, n, 8000, 6000], device="cuda")
    batch = {"feats": torch.randn(b, n, cfg.input_dim, device="cuda", generator=gen),
             "mask": torch.arange(n, device="cuda")[None] < lengths[:, None],
             "bag_valid": torch.ones(b, dtype=torch.bool, device="cuda"),
             "target": torch.randint(0, cfg.n_classes, (b,), device="cuda", generator=gen)}
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    events = prof.key_averages()
    # device activity only: kernels and copies, not the ranges annotated on the device timeline
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in STAGES and not getattr(e, "is_user_annotation", False)]
    per_step, seen, want = per_call_us(kernels, steps)
    device_us = sum(per_step.values())
    print(f"{torch.cuda.get_device_name(0)}; MHIM-{args.baseline} train step, batch {b} x {n}, "
          f"{cfg.compute_dtype} policy: {wall_ms:.2f} ms per step (host clock, under the profiler), "
          f"device busy {device_us / 1e3:.2f} ms per step = {100 * device_us / 1e3 / wall_ms:.1f}% of the "
          f"wall time; peak memory {peak_gib:.2f} GiB ({base / 2 ** 30:.2f} GiB held between steps)")
    if seen < want:
        print(f"the profiler returned {seen} of {want} kernel records; device time from each kernel's mean "
              f"record times its launches a step")
    print(f"{'stage':20s} {'device ms/step':>15s} {'host ms/step':>13s}")
    for name in STAGES:
        dev = sum(e.device_time_total for e in events if e.key == name
                  and e.device_type == torch.autograd.DeviceType.CUDA) / steps / 1e3
        host = sum(e.cpu_time_total for e in events if e.key == name
                   and e.device_type == torch.autograd.DeviceType.CPU) / steps / 1e3
        print(f"{name:20s} {dev:15.3f} {host:13.3f}")
    kinds = by_kind([(e.key, per_step[e.key] / 1e3, max(1, round(e.count / steps))) for e in kernels])
    print(f"by kind, device ms and launches a step: {kinds}")
    rows = sorted(kernels, key=lambda e: per_step[e.key], reverse=True)[:20]
    print(f"{'id':12s} {'kernel':60s} {'device ms/step':>15s} {'share':>7s} {'calls/step':>11s}")
    for e in rows:
        per = per_step[e.key] / 1e3
        print(f"{kernel_id(e.key):12s} {e.key[:60]:60s} {per:15.3f} {100 * per * 1e3 / max(device_us, 1):6.1f}% "
              f"{e.count / steps:11.1f}")


if __name__ == "__main__":
    main()
