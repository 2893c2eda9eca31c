"""The reading of a ``torch.profiler`` trace, kept in memory.

A traced run profiles one pass of its work twice, after timing it once
unprofiled (``cell.traced_pass``), since a profile slows a host-paced pass.
One profile records the device's activity alone: its kernels and copies
give ``busy_s``, ``device_ops`` and the copies' time (:func:`read_device`);
the unprofiled pass's time on the host clock replaces its ``window_s``.
The other records the host's ops too, with the shapes of their inputs,
inside the benchmark's own range ``bench.window``; recording every op
slows a host-paced step several-fold, so this profile gives only what
does not depend on the host's pace: each op's device time and shapes,
and the idle gaps by host range (:func:`read`). :func:`read` turns the
profiler's events into a :class:`Trace`:

- ``window_s``: the length of ``bench.window``, which ends with a
  synchronisation, so that every device event of its work lies inside;
- ``busy``: the union of the intervals in which a kernel, a copy or a
  set ran on the device, clipped to the window (``busy_s``);
- ``ops``: the host-side ops by name, each with its input shapes, its
  scalars where the profiler keeps them, and the device seconds of the
  kernels launched under it and under its children;
- ``device_ops`` and ``idle_gaps``: the device operations that took most
  time, and the idle stretches of the device by the innermost range or op
  open on the host's main thread at the middle of each.

Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"


@dataclasses.dataclass
class Op:
    name: str
    shapes: list
    scalars: list
    device_s: float


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: Dict[str, List[Op]]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    memcpy_htod_s: float


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Tuple[float, float]], t0: float, t1: float) -> List[Tuple[float, float]]:
    """The stretches of ``[t0, t1]`` outside the disjoint sorted ``busy``."""
    out, t = [], t0
    for s, e in busy:
        if s > t:
            out.append((t, min(s, t1)))
        t = max(t, e)
    if t < t1:
        out.append((t, t1))
    return [(s, e) for s, e in out if e > s]


def _innermost(cpu: List[Tuple[float, float, str]], starts: List[float], t: float) -> Optional[str]:
    """The name of the innermost host interval that holds ``t``: on one
    thread the intervals nest, so it is the latest-starting one that has
    not ended (``cpu`` sorted by start, ``starts`` its starts)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s, e, name = cpu[i]
        if e >= t:
            return name
        i -= 1
    return None


def range_names(events) -> set:
    """The names of the host's ranges (``record_function``) in ``events``."""
    from torch.autograd import DeviceType

    names = {e.name for e in events if e.device_type != DeviceType.CUDA and getattr(e, "is_user_annotation", False)}
    return names | {WINDOW}


def _annotation(e, ranges) -> bool:
    return (getattr(e, "is_user_annotation", False) or "annotation" in str(getattr(e, "activity_type", ""))
            or e.name in ranges)


def read_device(prof, window_s: float, ranges=frozenset(), top: int = 10) -> Optional[Trace]:
    """The device's side of a profile of the device's activity alone, over
    a window of ``window_s`` seconds on the host clock; None when it holds
    no device event."""
    from torch.autograd import DeviceType

    dev, kernel_time, htod = [], {}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or _annotation(e, ranges):
            continue
        s, en = e.time_range.start, e.time_range.end
        dev.append((s, en))
        kernel_time[e.name] = kernel_time.get(e.name, 0.0) + (en - s) * 1e-6
        if "HtoD" in e.name:
            htod += (en - s) * 1e-6
    if not dev:
        return None
    busy = union(dev)
    return Trace(window_s=window_s, busy_s=sum(e - s for s, e in busy) * 1e-6, ops={},
                 device_ops=sorted(kernel_time.items(), key=lambda kv: -kv[1])[:top], idle_gaps=[],
                 memcpy_htod_s=htod)


def merge(full: Trace, light: Optional[Trace]) -> Trace:
    """The device's side from ``light`` where there is one, the host's from ``full``."""
    if light is None:
        return full
    return dataclasses.replace(light, ops=full.ops, idle_gaps=full.idle_gaps)


def read(prof, top: int = 10) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.events()
    windows = [e for e in events if e.name == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    t0, t1 = windows[0].time_range.start, windows[0].time_range.end
    main = windows[0].thread
    dev, cpu, ops = [], [], {}
    kernel_time: Dict[str, float] = {}
    htod = 0.0
    ranges = range_names(events)
    for e in events:
        s, en = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if _annotation(e, ranges):  # a range's mirror on the device timeline, not work
                continue
            if en <= t0 or s >= t1:
                continue
            dev.append((max(s, t0), min(en, t1)))
            kernel_time[e.name] = kernel_time.get(e.name, 0.0) + (en - s) * 1e-6
            if "HtoD" in e.name:
                htod += (en - s) * 1e-6
            continue
        if s < t0 or s > t1:
            continue
        if e.thread == main and e.name != WINDOW:
            cpu.append((s, en, e.name))
        ops.setdefault(e.name, []).append(Op(e.name, list(e.input_shapes or []),
                                             list(getattr(e, "concrete_inputs", None) or []),
                                             e.device_time_total * 1e-6))
    busy = union(dev)
    cpu.sort()
    starts = [c[0] for c in cpu]
    by_host: Dict[str, float] = {}
    for s, e in gaps(busy, t0, t1):
        name = _innermost(cpu, starts, 0.5 * (s + e)) or "host outside any op"
        by_host[name] = by_host.get(name, 0.0) + (e - s) * 1e-6
    return Trace(
        window_s=(t1 - t0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        ops=ops,
        device_ops=sorted(kernel_time.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(by_host.items(), key=lambda kv: -kv[1])[:top],
        memcpy_htod_s=htod,
    )
