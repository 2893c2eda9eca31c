"""What the metric readers in ``metrics/`` share. A reader takes the
:class:`~benchmark.cell.Run` and returns a number, or None where the run
holds nothing to read (then the metric is left out of the line; a share of
a roofline or of a peak is never reported as 0 for want of a reading)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import workcounts

NYSTROM_OPS = ("mhim_mil_torch::pass_a", "mhim_mil_torch::pass_b", "mhim_mil_torch::newton_schulz")
RESCONV_TAPS = [33, 1]  # the (33, 1) kernel of the Nystrom value convolution


def bags_per_s(run) -> Optional[float]:
    """Valid bags trained over the whole window's time."""
    if run.mode != "train" or run.window_s <= 0:
        return None
    return run.bags / run.window_s


def p95_ms(run) -> Optional[float]:
    """The 95th percentile of every request's latency in the window."""
    if run.mode != "serve" or not run.latencies_ms:
        return None
    return float(np.percentile(np.asarray(run.latencies_ms), 95))


def _scalar(op, i, default):
    try:
        v = op.scalars[i]
    except IndexError:
        return default
    return default if v in ("", None, []) else v


def _as_bool(v) -> bool:
    return v if isinstance(v, bool) else str(v).strip().lower() in ("1", "true")


def _roofline(pairs) -> Optional[float]:
    """Σ bound / Σ device seconds, in %, over ``(work, device_s)`` pairs."""
    bound = sum(workcounts.bound_s(w) for w, _ in pairs)
    spent = sum(s for _, s in pairs)
    return None if spent <= 0 else 100.0 * bound / spent


def nystrom_roofline(run) -> Optional[float]:
    """K1, K2 and the K3p sweep: the launches of the ops ``pass_a``,
    ``pass_b`` and ``newton_schulz`` in the traced window."""
    if run.trace is None:
        return None
    pairs = []
    for name in NYSTROM_OPS:
        for op in run.trace.ops.get(name, []):
            s = op.shapes
            if name.endswith("pass_a"):
                work = workcounts.pass_a(s[0], s[1])
            elif name.endswith("pass_b"):
                work = workcounts.pass_b(s[0], s[3])
            else:  # iters and keep are scalars; without them: 6 iterations, no iterates kept (the lower bound)
                work = workcounts.newton_schulz(s[0], int(_scalar(op, 2, 6)), _as_bool(_scalar(op, 3, False)))
            pairs.append((work, op.device_s))
    return _roofline(pairs) if pairs else None


def resconv_roofline(run) -> Optional[float]:
    """The (33, 1) value convolution, forward (``aten::convolution``) and
    backward (``aten::convolution_backward``), told apart from PPEG's
    convolutions by its kernel's shape."""
    if run.trace is None:
        return None
    pairs = []
    for op in run.trace.ops.get("aten::convolution", []):
        if len(op.shapes) > 1 and list(op.shapes[1][2:]) == RESCONV_TAPS:
            pairs.append((workcounts.depthwise_conv(op.shapes[0], op.shapes[1]), op.device_s))
    for op in run.trace.ops.get("aten::convolution_backward", []):
        if len(op.shapes) > 2 and list(op.shapes[2][2:]) == RESCONV_TAPS:
            mask = _scalar(op, 10, [True, True, False])
            if isinstance(mask, str):
                mask = [m.strip().lower() == "true" for m in mask.strip("[]").split(",")]
            pairs.append((workcounts.depthwise_conv_backward(op.shapes[1], op.shapes[2], bool(mask[0]),
                                                             bool(mask[1])), op.device_s))
    return _roofline(pairs) if pairs else None


def mfu(run) -> Optional[float]:
    """The reference's FLOPs of the traced window's work over its time at the bf16 peak, in %."""
    if run.trace is None or run.flops_of is None or not run.traced_buckets:
        return None
    flops = sum(n * run.flops_of(b) for b, n in run.traced_buckets.items())
    return 100.0 * flops / (run.trace.window_s * workcounts.PEAK_FLOPS)


def idle_share(run) -> Optional[float]:
    """The share of the traced window in which nothing ran on the device, in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def range_device_ms(run, name: str) -> Optional[float]:
    """Device ms a step of the kernels launched inside the host range ``name``."""
    spent = sum(op.device_s for op in run.trace.ops.get(name, [])) if run.trace is not None else 0.0
    return 1e3 * spent / max(run.steps, 1) if spent > 0 else None


def htod_copy_ms(run) -> Optional[float]:
    """Device ms a request of host-to-device copies."""
    if run.trace is None or run.mode != "serve" or run.trace.memcpy_htod_s <= 0:
        return None
    return 1e3 * run.trace.memcpy_htod_s / max(sum(run.traced_buckets.values()), 1)
