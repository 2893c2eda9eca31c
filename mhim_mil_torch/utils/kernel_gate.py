"""Startup gate for the port's kernels (the counterpart of
``mhim_mil_tpu/utils/pallas_gate.py:47-134``).

``Config.use_flash_attn`` selects the CUDA kernels (True) or the plain
PyTorch versions (False); None asks this gate. :func:`resolve_kernel_gate`:

- an explicit True or False always wins (outcome ``explicit``);
- None on the CPU gives ``skipped`` and False: the caller asked for the
  CPU, which runs the plain versions;
- None on CUDA enables the kernels after three steps: (a) the card has
  compute capability 9.0; (b) a subprocess builds ``csrc/probe.cu`` and
  launches K6 on ``ones(8, 128)`` under a timeout, so that a hung ``nvcc``
  or a launch that faults cannot take the driver's CUDA context with it;
  (c) a subprocess runs ``kernel_check``, every kernel against its plain
  version.

Where JAX's gate turns the flag off after a failed probe or check, this
one raises with the detail: a broken kernel must not hide behind the plain
path on the card. A user who wants the plain path passes
``--use_flash_attn false``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROBE_TIMEOUT_S = 120.0  # as probe_mosaic's
CHECK_TIMEOUT_S = 1800.0

_PROBE_SRC = """
import torch
from mhim_mil_torch.ops import probe
x = torch.ones((8, 128), device="cuda")
out = probe.probe(x)
assert float(out[0, 0]) == 2.0 and bool((out == 2.0).all())
print(f"PROBE_OK launches={probe.probe.launches}")
"""


class KernelGateError(RuntimeError):
    """The card cannot run the port's kernels; ``result`` says why."""

    def __init__(self, result: dict):
        super().__init__(f"kernel gate {result['outcome']}: {result['detail']}")
        self.result = result


def _run(cmd, timeout_s: float):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, cwd=REPO)


def probe_kernels() -> dict:
    """Steps (b) and (c) on the current card. Returns ``{"outcome",
    "detail", "probe_launches"}`` with outcome ``enabled``, ``probe_timeout``,
    ``probe_failed`` or ``check_failed``."""
    res = {"probe_launches": 0}
    try:
        r = _run([sys.executable, "-c", _PROBE_SRC], PROBE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {**res, "outcome": "probe_timeout",
                "detail": f"building and launching K6 did not finish in {PROBE_TIMEOUT_S:.0f} s"}
    ok = [line for line in r.stdout.splitlines() if line.startswith("PROBE_OK")]
    if r.returncode != 0 or not ok:
        return {**res, "outcome": "probe_failed", "detail": (r.stderr or r.stdout)[-400:]}
    res["probe_launches"] = int(ok[-1].split("launches=")[1])
    try:
        r = _run([sys.executable, "-m", "mhim_mil_torch.utils.kernel_check"], CHECK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {**res, "outcome": "check_failed", "detail": f"kernel_check timed out after {CHECK_TIMEOUT_S:.0f} s"}
    if r.returncode != 0:
        return {**res, "outcome": "check_failed", "detail": (r.stderr or r.stdout)[-400:]}
    return {**res, "outcome": "enabled", "detail": "K6 probe + kernel_check green"}


def resolve_kernel_gate(cfg, device: torch.device, log: Callable[[str], None] = print) -> Tuple[object, dict]:
    """Resolve ``cfg.use_flash_attn is None`` into a bool for ``device``.
    Returns ``(cfg, result)``; ``result`` carries ``outcome``, ``detail``,
    ``probe_launches`` and the gate's ``seconds``. Logs one line; raises
    :class:`KernelGateError` when the card fails a step."""
    t0 = time.perf_counter()
    device = torch.device(device)
    if cfg.use_flash_attn is not None:
        res = {"outcome": "explicit", "detail": f"use_flash_attn={cfg.use_flash_attn}", "probe_launches": 0}
        enabled = cfg.use_flash_attn
    elif device.type != "cuda":
        res = {"outcome": "skipped", "detail": f"device {device}: the plain versions run there",
               "probe_launches": 0}
        enabled = False
    else:
        cap = torch.cuda.get_device_capability(device)
        if cap != (9, 0):
            res = {"outcome": "unsupported", "probe_launches": 0,
                   "detail": f"compute capability {cap}; the kernels are built for sm_90a"}
        else:
            res = probe_kernels()
        enabled = res["outcome"] == "enabled"
    res["seconds"] = time.perf_counter() - t0
    log(f"[kernel-gate] {res['outcome']}: {res['detail']} -> use_flash_attn={enabled}")
    if cfg.use_flash_attn is None and device.type == "cuda" and not enabled:
        raise KernelGateError(res)
    return cfg.replace(use_flash_attn=enabled), res
