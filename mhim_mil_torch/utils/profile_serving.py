"""Where a scorer request's time goes on the card.

``python -m mhim_mil_torch.utils.profile_serving [--model mhim|2dmamba] [--batch 4]``

Builds the model with random weights (seed 0): MHIM-selfattn from
``config/mhim_c16.yaml``, or the 2D-Mamba survival model from
``config/feat_surv.yaml`` with the ``surv_blca`` grid, both at input_dim
1024. Warms the scorer up, then profiles 5 requests of ``--batch`` bags of
10,240 instances with ``torch.profiler``. Prints the host-clock time per
request, the device time per request (each kernel's mean record times its
launches a request, since the profiler now and then drops a record; a
shortfall is printed) and its share of the wall time (the device's busy
share), and the 20 kernels that take the
most device time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..config import load_config
from ..models import build_model
from .serving import Scorer
from .time_scan2d import by_kind, kernel_id, per_call_us

CONFIGS = {
    "mhim": (["-c", "config/mhim_c16.yaml"], {}),
    "2dmamba": (["-c", "config/feat_surv.yaml"], {"model": "2dmamba", "datasets": "surv_blca"}),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(CONFIGS), default="mhim")
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    n, requests = 10240, 5

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    argv_cfg, kw = CONFIGS[args.model]
    cfg = load_config(argv_cfg, input_dim=1024, **kw)
    model, family = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    scorer = Scorer(cfg, model, device="cuda", family=family)
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(args.batch, n, cfg.input_dim, generator=gen).numpy()
    for _ in range(2):
        scorer.score(feats)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            scorer.score(feats)
        wall_ms = (time.perf_counter() - t0) * 1e3 / requests
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    per_request, seen, want = per_call_us(kernels, requests)
    device_us = sum(per_request.values())
    print(f"{torch.cuda.get_device_name(0)}; {args.model}, batch {args.batch} x {n}, "
          f"bf16 policy: {wall_ms:.2f} ms per request (host clock, under the profiler), "
          f"device busy {device_us / 1e3:.2f} ms per request = {100 * device_us / 1e3 / wall_ms:.1f}% "
          f"of the wall time")
    if seen < want:
        print(f"the profiler returned {seen} of {want} kernel records; device time from each kernel's mean "
              f"record times its launches a request")
    kinds = by_kind([(e.key, per_request[e.key] / 1e3, max(1, round(e.count / requests))) for e in kernels])
    print(f"by kind, device ms and launches a request: {kinds}")
    rows = sorted(kernels, key=lambda e: per_request[e.key], reverse=True)[:20]
    print(f"{'id':12s} {'kernel':60s} {'device ms/request':>18s} {'share':>7s} {'calls/request':>14s}")
    for e in rows:
        per = per_request[e.key] / 1e3
        print(f"{kernel_id(e.key):12s} {e.key[:60]:60s} {per:18.3f} {100 * per * 1e3 / max(device_us, 1):6.1f}% "
              f"{e.count / requests:14.1f}")


if __name__ == "__main__":
    main()
