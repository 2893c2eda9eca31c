"""Where the flagship MHIM train step sits against the card's measured
limits: ``python3 -m mhim_mil_torch.tools.roofline [--device cpu] [--json out.json]``
(the port's counterpart of ``tools/roofline.py``).

It reports:

- the card's measured streaming rates (:func:`measure_hbm_ceiling`): ``k``
  dependent sweeps of an in-place multiply ``y.mul_(c)`` over a 1 GiB fp32
  buffer, each sweep one read and one write of it (the ceiling the bytes
  floor is held to); beside it the read-only rate of ``x.sum()`` and a
  device-to-device ``copy_`` over the same buffer, and the data sheet's
  3.35 TB/s (``timing.PEAK_HBM_BYTES_S``). These are plain torch calls: the
  JAX tool's sweep is an XLA loop, not a Pallas kernel;
- the step's ms and bags/s over chained steps (``tools/bench.py``'s
  flagship, dense 4 × 10,240, bf16 policy, the kernel gate on auto);
- its FLOPs, counted on the plain path of the same weights
  (``bench.step_flops``), and the achieved TFLOP/s and ``mfu``;
- its bytes floor, the sum of ``step_breakdown.bytes_model``'s components
  (every input read once, each stage's activations written and read once,
  the parameter walks), the rate that floor implies at the step's time, and
  that rate's share of the measured ceiling.

XLA's ``bytes_accessed``, the compiler's count of the traffic of the whole
compiled step, has no PyTorch counterpart (the step is many launches, not
one program), so the bytes here are the model's floor, not a counter.

The tool's own flags are ``--device`` (``cuda``, the default, or ``cpu``),
``--bag_size``, ``--warmup``, ``--steps`` and ``--json``; every other flag
is the config's (``--input_dim 16 --inner_dim 32`` for a rehearsal on the
CPU, where the probes' buffer is 16 MiB). A measurement that reads no time
raises.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import timing

HBM_BYTES = 1 << 30  # the probes' fp32 buffer on the card
CPU_HBM_BYTES = 16 << 20  # and on the CPU
SWEEPS = 16  # calls a timed block
BLOCKS = 5  # timed blocks a probe, after one warm block; the median is kept


def default_hbm_bytes(device: torch.device) -> int:
    return HBM_BYTES if device.type == "cuda" else CPU_HBM_BYTES


def block_ms(fn: Callable[[], object], device: torch.device) -> float:
    """The ms of one call of ``fn``: CUDA events on the card, the host clock
    (after the call returns) on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def measure_hbm_ceiling(device: torch.device, nbytes: Optional[int] = None, sweeps: int = SWEEPS,
                        blocks: int = BLOCKS) -> Dict:
    """The streaming rates of ``device`` over an fp32 buffer of ``nbytes``
    (default :func:`default_hbm_bytes`), in GB/s: ``mul_inplace`` (``sweeps``
    dependent ``y.mul_(c)``, 2·nbytes each), ``sum`` (``x.sum()``, nbytes)
    and ``copy`` (``dst.copy_(x)``, 2·nbytes); each the median of ``blocks``
    timed blocks of ``sweeps`` calls after one warm block.
    ``ceiling_gb_s`` is ``mul_inplace``'s. Raises if a block reads no time."""
    nbytes = default_hbm_bytes(device) if nbytes is None else int(nbytes)
    n = nbytes // 4
    y = torch.ones(n, device=device)
    dst = torch.empty_like(y)
    probes = {"mul_inplace": (lambda: y.mul_(1.0000001), 2 * 4 * n),
              "sum": (lambda: y.sum(), 4 * n),
              "copy": (lambda: dst.copy_(y), 2 * 4 * n)}
    gb_s: Dict[str, float] = {}
    times: Dict[str, List[float]] = {}

    for name, (fn, moved) in probes.items():
        def block():
            for _ in range(sweeps):
                fn()

        block_ms(block, device)  # warm
        times[name] = [block_ms(block, device) for _ in range(blocks)]
        ms = float(np.median(times[name]))
        if not (math.isfinite(ms) and ms > 0):
            raise RuntimeError(f"the {name} probe read {ms} ms a block of {sweeps} over {nbytes} bytes")
        gb_s[name] = sweeps * moved / (ms / 1e3) / 1e9
    return {"gb_s": gb_s, "ceiling_gb_s": gb_s["mul_inplace"], "spec_gb_s": timing.PEAK_HBM_BYTES_S / 1e9,
            "nbytes": 4 * n, "sweeps": sweeps, "blocks": blocks, "block_ms": times}


def step_roofline(step_ms: float, flops: int, floor_bytes: int, hbm: Dict, dev: Dict) -> Dict:
    """The step against the card's limits: achieved TFLOP/s and ``mfu``
    against the dense bf16 peak (a card only), the bytes floor's rate at
    ``step_ms`` and its share of the measured ceiling, and the bytes the
    ceiling could move in ``step_ms`` (``physical_bytes_ceiling_per_step``)."""
    on_card = dev["platform"] == "gpu"
    tflops = flops / (step_ms / 1e3) / 1e12
    floor_gb_s = floor_bytes / (step_ms / 1e3) / 1e9
    return {"step_ms": step_ms, "step_flops": flops, "flops_counted_on": "plain path (FlopCounterMode)",
            "achieved_tflops": tflops if on_card else None,
            "mfu": tflops / timing.PEAK_BF16_TFLOPS if on_card else None,
            "peak_tflops": timing.PEAK_BF16_TFLOPS,
            "hbm_gb_s": hbm["gb_s"], "hbm_ceiling_gb_s": hbm["ceiling_gb_s"], "hbm_spec_gb_s": hbm["spec_gb_s"],
            "hbm_probe_bytes": hbm["nbytes"],
            "physical_bytes_ceiling_per_step": step_ms / 1e3 * hbm["ceiling_gb_s"] * 1e9,
            "bytes_floor_per_step": floor_bytes,
            "bytes_floor_gb_s": floor_gb_s,
            "bandwidth_utilization": floor_gb_s / hbm["ceiling_gb_s"],
            "card": dev["nvidia_smi"]}


def run(cfg, device: torch.device, dev: Dict, bag_size: int, warmup: int, steps: int) -> Dict:
    """The flagship step's ms and bags/s over ``steps`` chained steps after
    ``warmup``, its FLOPs and bytes floor, and :func:`step_roofline` at the
    measured ceiling."""
    from .bench import dense_batch, make_state_and_step, step_flops
    from .step_breakdown import bytes_model

    b, d = cfg.batch_size, cfg.input_dim
    model, state, step = make_state_and_step(cfg, device)
    batch = dense_batch(b, bag_size, d, device)
    timing.window_s(lambda: step(state, batch), warmup, device)
    step_ms = timing.window_s(lambda: step(state, batch), steps, device) / steps * 1e3
    flops = step_flops(cfg, model, batch, device)
    hbm = measure_hbm_ceiling(device)
    n_params = sum(p.numel() for p in model.parameters())
    floors = bytes_model(cfg, n_params, (b, bag_size, d), {}, hbm["ceiling_gb_s"] * 1e9)
    out = step_roofline(step_ms, flops, floors["_total"]["floor_bytes"], hbm, dev)
    out.update(bags_per_sec=b / (step_ms / 1e3), steps_timed=steps, bag_size=bag_size, batch=b, hbm=hbm,
               device=dev)
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--bag_size", type=int, default=10240)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--json", default=None, help="also write the result here")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    device, dev = timing.open_device(args.device)
    from ..utils.kernel_gate import resolve_kernel_gate
    from .bench import flagship_config

    cfg, _ = resolve_kernel_gate(flagship_config(rest), device)
    res = run(cfg, device, dev, args.bag_size, args.warmup, args.steps)
    print(json.dumps(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
