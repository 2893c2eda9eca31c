"""In-step decomposition of the flagship MHIM train step, and its bytes floor:
``python3 -m mhim_mil_torch.tools.step_breakdown`` (the port's counterpart
of ``tools/step_breakdown.py``).

Each diagnostic variant is the whole train step with one part taken out
(``engine/steps.make_mhim_train_step(..., ablate=...)``, so a variant cannot
drift from the real step). The variants and a null step, the same
``(state, batch)`` call that only copies one element of the features, are
timed in one process in interleaved windows of chained steps (``--warm`` 30
steps each first, then ``--rounds`` 3 rounds of one untimed step and a
window of ``--window`` 15, one synchronisation a window; the median of each
variant's windows). The port's steps update their state in place, so each
variant runs on its own ``TrainState``, built by ``state_factory`` from the
same weights and seed. Derived components (ms), JAX's formulas:

  dispatch_floor = null
  teacher_fwd    = full − no_teacher
  ema_walk       = full − no_ema
  optimizer      = no_ema − no_opt_ema   (≥ truth by no_opt_ema's gradient norm)
  backward       = no_opt_ema − fwd_only (≤ truth, the same norm)
  student_fwd    = fwd_only − teacher_fwd − dispatch_floor
  sum_check_ms   = the sum of the components, beside full_step_ms (the
                   differences telescope: the sum is the full step's time
                   whatever the readings, so it checks only the arithmetic)

These are differences of host-clock times. On a host-bound step (the
flagship's: the host, not the card, sets its pace) a difference measures
the Python and launch time a variant saves, not device work, and a
component can read ≤ 0 where its work hides under the host's. The reading
to trust is the profiler's: for each variant, 3 more
steps under ``torch.profiler`` (``utils/profile_train.profile_steps``) give
the device's busy ms a step (``variant_device_busy_ms``), the host ms of the
same steps (``variant_profiled_host_ms``), the components by the same
formulas on the device-busy ms (``device_components_ms``), and the device ms
of the kernels each ``record_function`` range of the step launches from its
own thread, and its host ms (``mhim.teacher``, ``mhim.student``,
``mhim.backward``, ``mhim.update``: ``range_device_ms``, ``range_host_ms``;
the backward's kernels come from autograd's device thread, so
``mhim.backward``'s device ms is near 0 and the backward's device time is
``device_components_ms["backward"]``). Device readings are None on the CPU.

:func:`bytes_model` is JAX's first-principles floor of the HBM traffic of
each component (:94-166): inputs read once, each full-sequence stage
writing and reading one bf16 ``[tokens, inner_dim]`` activation, the
parameter walks; ``P`` counts the student's fp32 parameters. Each floor is
given in ms at the measured streaming rate (``tools/roofline.py``) and at
the H100's 3.35 TB/s data sheet, beside the measured component.

The tool's own flags are ``--device`` (``cuda``, the default, or ``cpu``),
``--bag_size``, ``--warm``, ``--window``, ``--rounds`` and ``--json``; every
other flag is the config's (``tools/bench.py``'s flagship by default;
``--input_dim 16 --inner_dim 32`` and small counts for a rehearsal on the
CPU). It prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import timing

WARM, WINDOW, ROUNDS = 30, 15, 3
PROFILE_STEPS = 3
VARIANTS = ("no_teacher", "fwd_only", "no_opt_ema", "no_ema")
STEPS_PER_EPOCH = 10  # the schedule's, as the JAX tool builds its variants


def null_step(state, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The step's call with the work taken out: one element of the features
    copied (one launch)."""
    return {"loss": batch["feats"][0, 0, 0].to(torch.float32, copy=True)}


def steps_taken(warm: int = WARM, window: int = WINDOW, rounds: int = ROUNDS,
                profile_steps: int = PROFILE_STEPS) -> int:
    """The steps :func:`breakdown` runs on each variant's state."""
    return warm + rounds * (window + 1) + profile_steps


def time_variants(steps: Dict[str, Callable], states: Dict, batch, device: torch.device, warm: int,
                  window: int, rounds: int):
    """Median host ms a step of each variant over ``rounds`` interleaved
    windows of ``window`` chained steps (each after one untimed step), after
    ``warm`` steps each; and every window's ms."""
    for k, fn in steps.items():
        timing.window_s(lambda: fn(states[k], batch), warm, device)
    windows: Dict[str, List[float]] = {k: [] for k in steps}
    for _ in range(rounds):
        for k, fn in steps.items():
            fn(states[k], batch)
            windows[k].append(timing.window_s(lambda: fn(states[k], batch), window, device) / window * 1e3)
    return {k: float(np.median(v)) for k, v in windows.items()}, windows


def components(ms: Dict[str, float]) -> Dict[str, float]:
    """The components from each variant's ms a step (JAX's formulas)."""
    teacher = ms["full"] - ms["no_teacher"]
    return {
        "dispatch_floor": ms["null"],
        "teacher_fwd": teacher,
        "student_fwd": ms["fwd_only"] - teacher - ms["null"],
        "backward": ms["no_opt_ema"] - ms["fwd_only"],
        "optimizer": ms["no_ema"] - ms["no_opt_ema"],
        "ema_walk": ms["full"] - ms["no_ema"],
    }


def breakdown(cfg, state_factory: Callable[[], object], batch: Dict[str, torch.Tensor], device: torch.device,
              warm: int = WARM, window: int = WINDOW, rounds: int = ROUNDS,
              profile_steps: int = PROFILE_STEPS) -> Dict:
    """The in-step decomposition of ``cfg``'s MHIM train step on ``batch``
    (see the module's docstring). ``state_factory()`` makes a fresh
    ``TrainState``; it is called once a variant, ``full`` first."""
    from ..engine.steps import make_mhim_train_step
    from ..utils.profile_train import MHIM_STAGES, profile_steps as profile

    steps: Dict[str, Callable] = {"full": make_mhim_train_step(cfg, STEPS_PER_EPOCH, device=device),
                                  "null": null_step}
    for v in VARIANTS:
        steps[v] = make_mhim_train_step(cfg, STEPS_PER_EPOCH, device=device, ablate=v)
    states = {k: state_factory() for k in steps if k != "null"}
    states["null"] = states["full"]  # the null step reads nothing of it
    med, windows = time_variants(steps, states, batch, device, warm, window, rounds)
    prof = {k: profile(lambda: fn(states[k], batch), profile_steps, MHIM_STAGES, device) for k, fn in steps.items()}

    comps = components(med)
    busy = {k: p["device_busy_ms"] for k, p in prof.items()}
    return {
        "full_step_ms": med["full"],
        "components_ms": comps,
        "sum_check_ms": sum(comps.values()),
        "device_components_ms": None if busy["full"] is None else components(busy),
        "variant_ms": med,
        "variant_windows_ms": windows,
        "variant_device_busy_ms": busy,
        "variant_profiled_host_ms": {k: p["wall_ms"] for k, p in prof.items()},
        "range_device_ms": {k: p["stage_device_ms"] for k, p in prof.items() if k != "null"},
        "range_host_ms": {k: p["stage_host_ms"] for k, p in prof.items() if k != "null"},
        "profiler_records": {k: list(p["records"]) for k, p in prof.items()},
        "protocol": {"warm": warm, "window": window, "rounds": rounds, "profile_steps": profile_steps},
        "method": "in-step variant A/Bs (make_mhim_train_step ablate=...), one process, interleaved windows of "
                  "chained steps on the host clock; each variant on its own state from the same weights and "
                  "seed. Components are differences of host times: on a host-bound step they measure Python "
                  "and launch time saved and can read <= 0; variant_device_busy_ms and device_components_ms "
                  "(torch.profiler) are the device's own readings.",
    }


def bytes_model(cfg, n_params: int, geometry: Sequence[int], measured_ms: Dict[str, float],
                hbm_bytes_s: float) -> Dict:
    """The minimum HBM traffic of each component of one step (JAX's
    ``bytes_model``, ``tools/step_breakdown.py:94-166``, the same unit
    passes): ``geometry`` is the batch's ``(B, N, D)``, ``n_params`` the
    student's fp32 parameters. Each component's ``floor_bytes``, its ms at
    ``hbm_bytes_s`` (the measured rate) and at the data sheet's 3.35 TB/s,
    and ``measured_over_floor`` where ``measured_ms`` has the component;
    ``_total`` sums the floors."""
    B, N, D = (int(x) for x in geometry)
    E = cfg.inner_dim
    bf, f32 = 2, 4
    P = int(n_params) * f32
    # the student's sequence geometry (the model's static bounds)
    v = N - max(int(N * cfg.mask_ratio) - 1, 0) if cfg.mask_ratio > 0 else N
    s = min(int(v * cfg.merge_ratio) + 1, v) + cfg.merge_k
    unit_N = B * N * E * bf  # one full-sequence activation pass
    unit_v = B * v * E * bf  # a pass over the mined survivors
    unit_s = B * s * E * bf  # a pass over the merged sequence
    # one Nystrom TransLayer: write q, k, v (3), read them in each of two
    # streaming phases (6), write and read the attention output (2), read
    # the residual input (1), the value residual's read and write (2)
    layer = 14
    teacher = (B * N * D * f32  # the features
               + 2 * unit_N  # embedding out, written and read
               + 2 * layer * unit_N  # two TransLayers
               + 2 * unit_N  # PPEG between them
               + unit_N  # the CAM score's read of the scored activations
               + 2 * P)  # the teacher's weights: fp32 read, bf16 written
    student_fwd = (B * v * D * f32  # the surviving rows of the features
                   + 2 * unit_v  # embedding out
                   + 4 * unit_v  # Merge's kv over the visible set
                   + (layer + 4) * unit_s  # the encoder on the merged sequence
                   + 2 * P)  # the student's weights cast
    backward = 2 * (student_fwd - B * v * D * f32) + B * v * D * f32 + 2 * P
    floors = {
        "teacher_fwd": teacher,
        "student_fwd": student_fwd,
        "backward": backward,
        "optimizer": 7 * P + 2 * (2 * P),  # read g, p, m, v; write p, m, v
        "ema_walk": 3 * P,  # read the teacher and the new weights, write the teacher
    }

    def row(fb: int, ms: Optional[float]) -> Dict:
        floor_ms = fb / hbm_bytes_s * 1e3
        return {"floor_bytes": fb, "floor_mb": fb / 1e6, "floor_ms_at_measured_hbm": floor_ms,
                "floor_ms_at_spec": fb / timing.PEAK_HBM_BYTES_S * 1e3, "measured_ms": ms,
                "measured_over_floor": None if ms is None or floor_ms <= 0 else ms / floor_ms}

    out = {k: row(fb, measured_ms.get(k)) for k, fb in floors.items()}
    out["_total"] = row(sum(floors.values()), None)
    out["_params_bytes"] = P
    out["_geometry"] = {"B": B, "N": N, "D": D, "E": E, "v_static": v, "s_len": s}
    out["_hbm_bytes_s"] = hbm_bytes_s
    out["_spec_bytes_s"] = timing.PEAK_HBM_BYTES_S
    return out


def run(cfg, device: torch.device, bag_size: int, warm: int = WARM, window: int = WINDOW, rounds: int = ROUNDS,
        profile_steps: int = PROFILE_STEPS, hbm: Optional[Dict] = None) -> Dict:
    """:func:`breakdown` of ``tools/bench.py``'s flagship state on its dense
    batch, with :func:`bytes_model` at the measured streaming rate (``hbm``,
    a ``roofline.measure_hbm_ceiling`` reading, measured here if None)."""
    from .bench import dense_batch, make_state
    from .roofline import measure_hbm_ceiling

    b, d = cfg.batch_size, cfg.input_dim
    batch = dense_batch(b, bag_size, d, device)
    made = []

    def factory():
        made.append(make_state(cfg, device)[1])
        return made[-1]

    res = breakdown(cfg, factory, batch, device, warm, window, rounds, profile_steps)
    hbm = measure_hbm_ceiling(device) if hbm is None else hbm
    n_params = sum(p.numel() for p in made[0].model.parameters())
    res["bytes_model"] = bytes_model(cfg, n_params, (b, bag_size, d), res["components_ms"],
                                     hbm["ceiling_gb_s"] * 1e9)
    res["hbm_gb_s"] = hbm["gb_s"]
    return res


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--bag_size", type=int, default=10240)
    ap.add_argument("--warm", type=int, default=WARM)
    ap.add_argument("--window", type=int, default=WINDOW)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--json", default=None, help="also write the result here")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    device, dev = timing.open_device(args.device)
    from ..utils.kernel_gate import resolve_kernel_gate
    from .bench import flagship_config

    cfg, gate = resolve_kernel_gate(flagship_config(rest), device)
    res = run(cfg, device, args.bag_size, args.warm, args.window, args.rounds)
    res.update(device=dev, kernel_gate={"outcome": gate["outcome"], "use_flash_attn": cfg.use_flash_attn},
               compute_dtype=cfg.compute_dtype)
    print(json.dumps(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
