"""Where a train step's time goes on the card.

``python -m mhim_mil_torch.utils.profile_train [--model mhim] [--baseline selfattn] [--mambamil_type BiMamba] [--steps 5]``

Builds MHIM (``--model mhim``, or ``mhim_pure`` for the teacher stage's
step) from ``config/mhim_c16.yaml``, or a zoo model (``--model abmil``,
``gabmil``, ``transmil``, ``dsmil``, ``clam_sb``, ``clam_mb``, ``dtfd``,
``ibmil`` (no confounder bank), ``rrtmil`` or ``mambamil`` (of
``--mambamil_type``), on the generic train step) from
``config/feat_cls.yaml``, at input_dim 1024 with random weights (seed 0),
takes 3 warm-up steps under the default bf16 policy on a
batch of 4 bags of 10,240 instances (two of them ragged, 8,000 and 6,000),
then profiles ``--steps`` steps with ``torch.profiler``. Prints the host-clock
time per step, the device time per step and its share of the wall time (the
device's busy share; each kernel's mean record times its launches a step,
since the profiler now and then drops a record, and a shortfall is
printed), the device time of the kernels each stage of the step launches
from its own thread (the ``record_function`` ranges of
``make_mhim_train_step`` or ``make_train_step``; the backward's kernels
come from autograd's thread and are not in its range), the peak device
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
from ..engine.steps import make_mhim_train_step, make_train_step
from ..engine.train_state import create_mhim_state, create_train_state
from ..models import build_model
from .time_scan2d import by_kind, kernel_id, per_call_us

MHIM_STAGES = ("mhim.teacher", "mhim.student", "mhim.backward", "mhim.update")
STAGES = ("train.forward", "train.backward", "train.update")  # make_train_step's ranges
ZOO = ("abmil", "gabmil", "transmil", "dsmil", "clam_sb", "clam_mb", "dtfd", "ibmil", "rrtmil", "mambamil")


def profile_steps(fn, steps: int, stages, device: torch.device) -> dict:
    """``steps`` calls of ``fn`` (a train step) under ``torch.profiler``:

    - ``wall_ms``: host ms a step under the profiler, synchronised at the end;
    - ``device_busy_ms``: the device's busy ms a step, each kernel's mean
      record times its launches a step (:func:`per_call_us`; the profiler
      now and then drops a record), None on the CPU;
    - ``records``: the kernel records returned and those the launches make;
    - ``stage_device_ms`` / ``stage_host_ms``: a step's device ms of the
      kernels launched inside each ``record_function`` range in ``stages``
      (None on the CPU), and its host ms. A range holds what its own thread
      launches: the backward's kernels, launched from autograd's device
      thread, are not in ``mhim.backward``'s;
    - ``kernels`` and ``per_step_us``: the device records and each one's µs a step.
    """
    on_cuda = device.type == "cuda"
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    if on_cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        if on_cuda:
            torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    # device activity only: kernels and copies, not the ranges annotated on the device timeline
    kernels = [e for e in events if e.device_type == cuda and e.key not in STAGES + MHIM_STAGES + tuple(stages)
               and not getattr(e, "is_user_annotation", False)]
    per_step, seen, want = per_call_us(kernels, steps)

    def stage_ms(stage, device_type, attr):
        return sum(getattr(e, attr) for e in events if e.key == stage and e.device_type == device_type) / steps / 1e3

    return {
        "wall_ms": wall_ms,
        "device_busy_ms": sum(per_step.values()) / 1e3 if on_cuda else None,
        "records": (seen, want),
        "stage_device_ms": {s: stage_ms(s, cpu, "device_time_total") if on_cuda else None for s in stages},
        "stage_host_ms": {s: stage_ms(s, cpu, "cpu_time_total") for s in stages},
        "kernels": kernels,
        "per_step_us": per_step,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="mhim", choices=("mhim", "mhim_pure") + ZOO)
    ap.add_argument("--baseline", default="selfattn", choices=("selfattn", "attn"))
    ap.add_argument("--mambamil_type", default=None, choices=(None, "SimpleMamba", "SRMamba", "BiMamba"))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    b, n, steps, spe = 4, 10240, args.steps, 8

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    zoo = args.model in ZOO
    preset = "config/feat_cls.yaml" if zoo else "config/mhim_c16.yaml"
    cfg = load_config(["-c", preset], input_dim=1024, model=args.model, baseline=args.baseline,
                      mambamil_type=args.mambamil_type)
    model, family = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    if zoo:
        state = create_train_state(cfg, model, spe, seed=0, device="cuda")
        step = make_train_step(cfg, family, spe, device="cuda")
    else:
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

    prof = profile_steps(lambda: step(state, batch), steps, STAGES if zoo else MHIM_STAGES, torch.device("cuda"))
    wall_ms, kernels, per_step = prof["wall_ms"], prof["kernels"], prof["per_step_us"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    device_us = sum(per_step.values())
    name = args.model if zoo else f"{args.model}-{args.baseline}"
    print(f"{torch.cuda.get_device_name(0)}; {name} train step, batch {b} x {n}, "
          f"{cfg.compute_dtype} policy: {wall_ms:.2f} ms per step (host clock, under the profiler), "
          f"device busy {device_us / 1e3:.2f} ms per step = {100 * device_us / 1e3 / wall_ms:.1f}% of the "
          f"wall time; peak memory {peak_gib:.2f} GiB ({base / 2 ** 30:.2f} GiB held between steps)")
    seen, want = prof["records"]
    if seen < want:
        print(f"the profiler returned {seen} of {want} kernel records; device time from each kernel's mean "
              f"record times its launches a step")
    print(f"{'stage':20s} {'device ms/step':>15s} {'host ms/step':>13s}")
    for stage in prof["stage_device_ms"]:
        print(f"{stage:20s} {prof['stage_device_ms'][stage]:15.3f} {prof['stage_host_ms'][stage]:13.3f}")
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
