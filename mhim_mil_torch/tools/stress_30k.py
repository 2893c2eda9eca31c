"""The 32,768-instance stress run: ``python3 -m mhim_mil_torch.tools.stress_30k``
(the port's counterpart of ``tools/stress_30k.py``).

CAMELYON16 slides reach 30,000-50,000 patches at 20x. This runs the
flagship MHIM train step (``bench.py``'s config, batch 2) and the batch-1
``forward_test`` at the 32,768 bucket on the card, on bags drawn as
``tools/stress_30k.py`` draws them: features from ``default_rng(0)``, then
ragged lengths ``integers(16384, 32769)`` from the same generator. It
prints one JSON line: the first step's seconds, the step ms over 10 chained
steps after 3, bags/s, the peak memory of a step
(``torch.cuda.max_memory_allocated`` above what the state and batch hold,
and in all), the first eval call's seconds, the batch-1 eval ms a slide
(each call synchronised), each kernel's launches in a step and an eval
call, and the device with its name and power limit.

The tool's own flags are ``--device`` (``cuda``, the default, or ``cpu``),
``--bag_size`` and ``--steps``; every other flag is the config's
(``--input_dim 16 --inner_dim 32`` for a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from . import timing
from .bench import flagship_config, make_state_and_step, to_device

BAG = 32768
BATCH = 2
STEPS, WARM_STEPS, EVAL_REPS = 10, 3, 10


def stress_inputs(b: int, n: int, d: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """``tools/stress_30k.py:56-64``'s batch: features, then lengths in
    ``[n // 2, n]``, then targets, from one ``default_rng(seed)`` (the
    features drawn a bag at a time, which gives the same numbers)."""
    rng = np.random.default_rng(seed)
    feats = np.stack([rng.normal(size=(n, d)).astype(np.float32) for _ in range(b)])
    lens = rng.integers(n // 2, n + 1, (b, 1))
    return {"feats": feats, "mask": np.arange(n)[None] < lens, "bag_valid": np.ones((b,), bool),
            "target": rng.integers(0, 2, size=(b,)).astype(np.int32)}


def peak_gib(device: torch.device, base: int) -> Optional[Dict[str, float]]:
    if device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device)
    return {"above_state_gib": (peak - base) / 2 ** 30, "total_gib": peak / 2 ** 30}


def main(argv: Optional[List[str]] = None) -> Dict:
    from ..engine.steps import make_mhim_eval_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--bag_size", type=int, default=BAG)
    ap.add_argument("--steps", type=int, default=STEPS, help="chained steps timed")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    device, dev = timing.open_device(args.device)
    cfg = flagship_config([f"--batch_size={BATCH}"] + rest)
    b, n = cfg.batch_size, args.bag_size
    model, state, step = make_state_and_step(cfg, device)
    batch = to_device(stress_inputs(b, n, cfg.input_dim), device)

    before = timing.kernel_launches()
    first_s = timing.window_s(lambda: step(state, batch), 1, device)
    step_launches = timing.launches_since(before)
    timing.window_s(lambda: step(state, batch), WARM_STEPS, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    step_ms = timing.window_s(lambda: step(state, batch), args.steps, device) / args.steps * 1e3
    peak = peak_gib(device, base)

    eval_step = make_mhim_eval_step(cfg, model)
    one = {"feats": batch["feats"][:1], "mask": batch["mask"][:1]}
    before = timing.kernel_launches()
    infer_first_s = timing.window_s(lambda: eval_step(one), 1, device)
    eval_launches = timing.launches_since(before)
    infer = timing.percentiles(timing.call_ms(lambda: eval_step(one), EVAL_REPS, device))
    res = {
        "metric": "mhim_stress_32k",
        "bag_size": n,
        "batch": b,
        "input_dim": cfg.input_dim,
        "lengths": batch["mask"].sum(dim=1).tolist(),
        "compute_dtype": cfg.compute_dtype,
        "use_flash_attn": cfg.use_flash_attn,
        "train_first_step_s": first_s,
        "train_step_ms": step_ms,
        "train_steps_timed": args.steps,
        "train_bags_per_sec": b / step_ms * 1e3,
        "train_peak_memory": peak,
        "train_launches_a_step": step_launches,
        "infer_first_s": infer_first_s,
        "infer_ms_per_slide": infer["mean"],
        "infer_p50_ms": infer["p50"],
        "infer_reps": EVAL_REPS,
        "infer_launches_a_call": eval_launches,
        "device": dev,
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
