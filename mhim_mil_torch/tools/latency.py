"""Per-model single-bag inference latency and FLOPs: ``python3 -m mhim_mil_torch.tools.latency``
(the port's counterpart of ``tools/latency.py``).

For each model of ``--models`` (default ``abmil,gabmil,transmil,dsmil,
clam_sb,dtfd,mhim``; random weights from seed 0), the fp32 eval forward on
one bag of ``--bag_size`` (default 9,000) full instances: ``forward_test``
through ``make_mhim_eval_step`` for MHIM, the model's ``forward`` through
``make_eval_step`` otherwise, the kernels on the card (K4 for abmil and
gabmil, K1, K2 and K3p for transmil and mhim). It prints the host ms of
``--repeats`` calls, each synchronised (p50, p90, mean), after
``--warmup`` calls, the forward's GFLOPs, counted by ``FlopCounterMode`` on
each model's plain path with the same weights (the counter does not see the
kernels' ``ctypes`` launches), and each kernel's launches in a call: a
table, then one JSON line with every row and the device.

``--p50_protocol`` runs ``tools/latency.py``'s four steps for the first
model instead and prints one JSON line: (1) the forward then 60 chained
calls, so that no ramp is timed; (2) the link floor, ``x + 1`` on a 4 × 4,
synchronised each call, 20 calls; (3) the host ms of ``--repeats`` calls,
each synchronised (p50, p90); (4) the ms a call of ``--repeats`` chained
calls with one synchronisation, after as many to ramp again
(``chained_ms``; ``tools/latency.py``'s ``device_only_ms``, the device's
time only where the host keeps ahead of the card). The capture counts
(``host_healthy``) when the link floor is under 2 ms.

The tool's own flags are ``--device`` (``cuda``, the default, or ``cpu``),
``--models``, ``--bag_size``, ``--repeats``, ``--warmup`` and
``--p50_protocol``; every other flag is the config's (``--input_dim 16
--inner_dim 32`` for a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import timing

MODELS = "abmil,gabmil,transmil,dsmil,clam_sb,dtfd,mhim"
MHIM_FAMILIES = ("mhim", "mhim_pure")
HEALTHY_LINK_MS = 2.0


def model_config(key: str, argv: Sequence[str] = ()):
    """``tools/latency.py``'s config of ``key``: input 1024, the selfattn
    baseline for MHIM (attn otherwise), mask_ratio_h 0.03, merge on at
    0.2, fp32; flags of the config in ``argv`` override it."""
    return timing.config_from(dict(model=key, input_dim=1024, baseline="selfattn" if key.startswith("mhim")
                                   else "attn", mask_ratio_h=0.03, merge_enable=True, merge_ratio=0.2,
                                   compute_dtype="float32"), argv)


def forward_fn(cfg, model, family: str):
    """The eval step of ``model``: ``batch -> logits``."""
    from ..engine.steps import make_eval_step, make_mhim_eval_step

    step = make_mhim_eval_step(cfg, model) if family in MHIM_FAMILIES else make_eval_step(cfg, model, family)
    return lambda batch: step(batch)["logits"]


def setup(key: str, bag_size: int, device: torch.device, argv: Sequence[str] = ()):
    """``(cfg, family, model, fwd, batch)``: the model of ``key`` with random
    weights (seed 0) and one full bag drawn from ``default_rng(0)``."""
    from ..models import build_model

    cfg = model_config(key, argv)
    model, family = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    feats = np.random.default_rng(0).normal(size=(1, bag_size, cfg.input_dim)).astype(np.float32)
    batch = {"feats": torch.from_numpy(feats).to(device),
             "mask": torch.ones((1, bag_size), dtype=torch.bool, device=device)}
    return cfg, family, model, forward_fn(cfg, model, family), batch


def forward_flops(cfg, family: str, model, batch, device) -> int:
    """The FLOPs of one forward on the plain path of ``model``'s weights."""
    cfg_p, twin = timing.plain_twin(cfg, model, device)
    fwd = forward_fn(cfg_p, twin, family)
    return timing.plain_flops(lambda: fwd(batch))


def measure(key: str, bag_size: int, repeats: int, warmup: int, device: torch.device,
            argv: Sequence[str] = ()) -> Dict:
    cfg, family, model, fwd, batch = setup(key, bag_size, device, argv)
    flops = forward_flops(cfg, family, model, batch, device)
    before = timing.kernel_launches()
    fwd(batch)
    launches = timing.launches_since(before)
    timing.window_s(lambda: fwd(batch), warmup, device)
    t = timing.percentiles(timing.call_ms(lambda: fwd(batch), repeats, device))
    return {"model": key, "p50_ms": t["p50"], "p90_ms": t["p90"], "mean_ms": t["mean"], "repeats": repeats,
            "gflops_fwd": flops / 1e9, "launches_a_call": launches, "compute_dtype": cfg.compute_dtype}


def p50_protocol(key: str, bag_size: int, repeats: int, device: torch.device, argv: Sequence[str] = ()) -> Dict:
    cfg, _, _, fwd, batch = setup(key, bag_size, device, argv)
    timing.window_s(lambda: fwd(batch), 61, device)  # 1. the first call and the ramp
    link = timing.link_floor_ms(device)  # 2.
    t = timing.percentiles(timing.call_ms(lambda: fwd(batch), repeats, device))  # 3.
    timing.window_s(lambda: fwd(batch), repeats, device)  # 4. ramp again, then chained calls
    chained_ms = timing.window_s(lambda: fwd(batch), repeats, device) / repeats * 1e3
    healthy = link < HEALTHY_LINK_MS
    return {"model": key, "bag_size": bag_size, "compute_dtype": cfg.compute_dtype, "p50_ms": t["p50"],
            "p90_ms": t["p90"], "repeats": repeats,
            "chained_ms": chained_ms, "link_floor_ms": link, "host_healthy": healthy,
            "north_star_p50_ms": t["p50"] if healthy else None,
            "note": "healthy host: p50 is the per-slide latency a synchronous scorer sees" if healthy else
                    f"link floor >= {HEALTHY_LINK_MS} ms: the per-call p50 reads the link, chained_ms the model"}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--models", default=MODELS)
    ap.add_argument("--bag_size", type=int, default=9000)
    ap.add_argument("--repeats", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--p50_protocol", action="store_true",
                    help="the four-step p50 capture for the first model of --models")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    device, dev = timing.open_device(args.device)
    keys = args.models.split(",")
    if args.p50_protocol:
        res = {**p50_protocol(keys[0], args.bag_size, args.repeats, device, rest), "device": dev}
        print(json.dumps(res))
        return res
    rows = []
    print(f"{'model':<10} {'p50 ms':>8} {'p90 ms':>8} {'mean ms':>8} {'GFLOP':>8}  launches a call")
    for key in keys:
        r = measure(key, args.bag_size, args.repeats, args.warmup, device, rest)
        rows.append(r)
        print(f"{r['model']:<10} {r['p50_ms']:>8.2f} {r['p90_ms']:>8.2f} {r['mean_ms']:>8.2f} "
              f"{r['gflops_fwd']:>8.2f}  {r['launches_a_call']}")
    res = {"metric": "latency", "bag_size": args.bag_size, "rows": rows, "device": dev}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
