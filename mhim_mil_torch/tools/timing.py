"""What the port's timing tools (``bench``, ``stress_30k``, ``latency``) share.

- :func:`open_device`: the device a tool runs on (CUDA unless ``--device
  cpu``; no card raises) and its description: the card's name, count, and
  its name and power limit as ``nvidia-smi`` reads them, which every
  figure a tool prints carries;
- :func:`sync`, :func:`window_s` and :func:`call_ms`: a synchronised
  window of chained calls, and per-call times synchronised each call;
- :func:`percentiles` and :func:`spread`;
- :func:`config_from`: a tool's config, its defaults overridden by any
  flag of the config;
- :func:`plain_twin` and :func:`plain_flops`: the FLOPs of a call,
  counted by ``torch.utils.flop_counter.FlopCounterMode`` on the plain
  path of the same model and weights. The counter sees torch's operators
  only, not the kernels' ``ctypes`` launches, so a count on the kernel
  path would leave out K1–K3 and K3p;
- :func:`kernel_launches`: the kernels' launch counters.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.platform import resolve_device

PEAK_BF16_TFLOPS = 989.0  # NVIDIA H100 SXM data sheet, dense bf16 on the tensor cores
PEAK_HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet, HBM3


def nvidia_smi() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def open_device(device: Optional[str] = None) -> Tuple[torch.device, Dict]:
    """``(device, description)``: CUDA unless ``device`` names the CPU (no card
    raises, as every entry point of the port). The description holds
    ``platform`` (``gpu`` or ``cpu``), ``kind`` (the card's name, or
    ``cpu``), ``count`` and ``nvidia_smi`` (the card's name and power limit;
    None on the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return dev, {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                     "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi()}
    return dev, {"platform": "cpu", "kind": "cpu", "count": 1, "nvidia_smi": None}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window_s(fn: Callable[[], object], n: int, device: torch.device) -> float:
    """Seconds of ``n`` chained calls of ``fn``: the device drained before
    the clock starts, one synchronisation at the end."""
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return time.perf_counter() - t0


def call_ms(fn: Callable[[], object], n: int, device: torch.device) -> List[float]:
    """The host ms of each of ``n`` calls of ``fn``, each synchronised."""
    sync(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def percentiles(xs: Sequence[float]) -> Dict[str, float]:
    return {"p50": float(np.percentile(xs, 50)), "p90": float(np.percentile(xs, 90)),
            "mean": float(np.mean(xs)), "n": len(xs)}


def spread(rates: Sequence[float]) -> float:
    """(max − min) / median."""
    return float((np.max(rates) - np.min(rates)) / np.median(rates))


def link_floor_ms(device: torch.device, reps: int = 20) -> float:
    """The per-call time of ``x + 1`` on a 4 × 4, synchronised each call:
    the floor under any synchronised call's time."""
    x = torch.ones((4, 4), device=device)
    call_ms(lambda: x + 1, 1, device)
    return float(np.mean(call_ms(lambda: x + 1, reps, device)))


def config_from(defaults: Dict, argv: Sequence[str] = ()):
    """``load_config`` of ``defaults`` (field → value), then of ``argv``:
    any flag of the config in ``argv`` overrides its default."""
    from ..config import load_config

    return load_config([f"--{k}={v}" for k, v in defaults.items()] + list(argv))


def plain_twin(cfg, model: torch.nn.Module, device: torch.device):
    """``(cfg, model)`` on the plain path (``use_flash_attn=False``) with
    ``model``'s weights, every Nystrom attention materialised (no streamed
    windows, which recompute products): each product counted once."""
    from ..models import build_model
    from ..models.transformer import NystromMSA

    cfg = cfg.replace(use_flash_attn=False)
    twin, _ = build_model(cfg, device=device)
    twin.load_state_dict(model.state_dict())
    for mod in twin.modules():
        if isinstance(mod, NystromMSA):
            mod.stream_min_len = sys.maxsize
    return cfg, twin


def plain_flops(fn: Callable[[], object]) -> int:
    """The FLOPs of one call of ``fn`` (products, convolutions and attention
    by torch's counter; elementwise work is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def kernel_launches() -> Dict[str, int]:
    """Each kernel's launch counter: K1, K2, K3 and K3b (K3's forward and
    backward calls), K3p (products), K1b, K2b, K4, K5, K6."""
    from ..ops import abmil_pool, nystrom_pinv, probe, scan2d
    from ..ops import flash_nystrom as fn

    return {"K1": fn.pass_a.launches, "K2": fn.pass_b.launches, "K3": fn.flash_nystrom.forward_calls,
            "K3b": fn.flash_nystrom.backward_calls, "K3p": nystrom_pinv.pinv_product.launches,
            "K1b": fn.pass_a_backward.launches, "K2b": fn.pass_b_backward.launches,
            "K4": abmil_pool.fused_abmil_pool.launches, "K5": scan2d.selective_scan_2d_fused.launches,
            "K6": probe.probe.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches since ``before`` (a :func:`kernel_launches` reading), nonzero ones only."""
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}
