"""Time the flagship MHIM train step on the card: ``python3 -m mhim_mil_torch.tools.bench``
(the port's counterpart of the root ``bench.py``).

The step is the one ``bench.py:63-79`` builds: ``--model mhim --baseline
selfattn``, input 1024, batch 4, lr 2e-4 constant, mask ratios 0.5 / 0.03
/ 0.5, merge on (ratio 0.2, k 1), ``aux_alpha`` 0.5, ``attn2score``,
under the default bf16 policy, with ``use_flash_attn`` on auto: the kernel
gate (``utils/kernel_gate.py``) launches K6 in its probe and runs the
kernel check, and raises if the card fails either. The weights are random
(seed 0); the features are drawn as ``bench.py`` draws them and staged in
fp32 on the device. It prints:

1. dense and ragged bags/s at 4 × 10,240: 30 warm-up steps, then windows
   of 15 chained steps with one ``torch.cuda.synchronize()`` each, 5 a
   variant, dense and ragged interleaved; if a variant's windows spread by
   more than 5% ((max − min) / median), 5 more each; the medians. The
   ragged lengths are ``bench.py``'s draw,
   ``default_rng(1).integers(5120, 10241, size=4)``;
2. an epoch simulation: 32 slides of lognormal lengths (median 8,000,
   clipped to [1,500, 32,768], seed 5) batched by ``data/bucketing.batch_bags``
   into the buckets 2,048 … 32,768 in each epoch's shuffled order; the
   first step of each bucket's shape (``first_step_s_per_bucket``: cuDNN's
   and cuBLAS's first calls and the caching allocator's growth, where JAX
   compiles), a warm epoch, 3 timed epochs of chained steps with one
   synchronisation each, each epoch's batches staged on the device before
   its clock starts (so the driver's host batch making is not in it), and
   per-bucket windows of 8 steps;
3. eval latency: the batch-1 ``forward_test`` through ``make_mhim_eval_step``,
   the host ms of each of 40 calls synchronised each call (p50 / p90), the
   ms a slide of 40 chained calls with one synchronisation
   (``infer_chained_ms``; ``bench.py``'s ``infer_device_ms``, which is the
   device's time only where the host keeps ahead of the card), the
   per-call floor of the link (``x + 1`` on a 4 × 4), and eval slides/s at
   batch 4;
4. the measured roofline (``roofline``, ``tools/roofline.py``): the
   step's FLOPs, counted by ``FlopCounterMode`` on the plain path of the
   same model and weights (the counter does not see the kernels' ``ctypes``
   launches), the achieved TFLOP/s and ``mfu`` against the H100's dense
   bf16 peak of 989 TFLOP/s; the card's streaming rates in GB/s
   (``hbm_gb_s``: an in-place multiply, ``x.sum()`` and a copy over 1 GiB)
   beside the data sheet's 3,350 (the probes' buffer is 16 MiB on the
   CPU), the bytes the measured ceiling moves in a step
   (``physical_bytes_ceiling_per_step``) and the step's bytes floor; beside
   the card's name and power limit;
5. the in-step decomposition (``decomposition``, ``tools/step_breakdown.py``):
   the full step, a null step and the four ``ablate`` variants in
   interleaved windows (``--warmup`` steps each, then 3 rounds of
   ``--steps``), the host-clock components, each variant's device-busy ms
   and each ``record_function`` range's device ms (profiler), and
   ``bytes_model`` at the measured rate. ``--breakdown off`` leaves it out.

Left out, against ``bench.py``: the ``steps_per_call=15`` row: the port's
``steps_per_call`` runs single steps (``engine/driver.py``), so its rate is
the dense rate; and ``vs_baseline``, whose A100 denominator is a
derivation, not a measurement.

The line before the last is the whole detail as JSON (also written to
``--detail``, by default ``build/torch_bench_detail.json``); the last line
is one JSON object: ``metric``, ``value`` (the dense rate), ``unit``, the
ragged rate, the eval p50, ``mfu`` and the device. The tool's own flags are
``--device`` (``cuda``, the default, or ``cpu``), ``--bag_size``,
``--warmup``, ``--steps``, ``--reps``, ``--detail`` and ``--breakdown
on|off``; every other flag is
the config's and overrides the flagship's (``--input_dim 16 --inner_dim 32``
for a rehearsal on the CPU; the epoch simulation's lengths and buckets scale
with ``--bag_size``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import roofline, step_breakdown, timing

BAG_SIZE = 10240  # the 10k-instance bucket
WARMUP_STEPS = 30
WINDOW_STEPS = 15  # steps a measurement window
N_WINDOWS = 5  # windows a variant (dense, ragged), interleaved
STEADY_SPREAD = 0.05  # steadiness gate: (max − min) / median across windows
LATENCY_REPS = 40
MEASURE_STEPS = 30  # batch-4 eval calls a window
EPOCH_BUCKETS = (2048, 4096, 8192, 16384, 32768)
EPOCH_SLIDES, EPOCHS, EPOCH_SEED, BUCKET_WINDOW = 32, 3, 5, 8
STEPS_PER_EPOCH = 10  # the schedule's, as bench.py builds it
FLAGSHIP = dict(model="mhim", baseline="selfattn", input_dim=1024, batch_size=4, num_epoch=100, lr=2e-4,
                lr_sche="const", mask_ratio=0.5, mask_ratio_h=0.03, mask_ratio_hr=0.5, merge_enable=True,
                merge_ratio=0.2, merge_k=1, aux_alpha=0.5, attn2score=True)
DETAIL = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build",
                      "torch_bench_detail.json")


def flagship_config(argv: Sequence[str] = ()):
    """The config of ``bench.py:63-79``; flags of the config in ``argv`` override it."""
    return timing.config_from(FLAGSHIP, argv)


def make_state(cfg, device: torch.device):
    """The model (random weights, seed 0) and its MHIM train state (generator seed 0)."""
    from ..engine.train_state import create_mhim_state
    from ..models import build_model

    model, _ = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    return model, create_mhim_state(cfg, model, STEPS_PER_EPOCH, seed=0, device=device)


def make_state_and_step(cfg, device: torch.device):
    """:func:`make_state` and the train step."""
    from ..engine.steps import make_mhim_train_step

    return (*make_state(cfg, device), make_mhim_train_step(cfg, STEPS_PER_EPOCH, device=device))


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "pos"}


def dense_batch(b: int, n: int, d: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """``bench.py:88-97``'s batch: features from ``default_rng(0)``, every bag full."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(b, n, d)).astype(np.float32)
    return to_device({"feats": feats, "mask": np.ones((b, n), bool), "bag_valid": np.ones((b,), bool),
                      "target": rng.integers(0, 2, size=(b,)).astype(np.int32)}, device)


def ragged_lengths(b: int, n: int) -> np.ndarray:
    """``bench.py:261-265``'s ragged lengths."""
    return np.random.default_rng(1).integers(n // 2, n + 1, size=(b,))


def one_window(state, step, batch, steps: int, device) -> float:
    """Bags/s over ``steps`` chained steps, after one step that is not timed."""
    step(state, batch)
    dt = timing.window_s(lambda: step(state, batch), steps, device)
    return steps * batch["feats"].shape[0] / dt


def interleaved_throughput(state, step, dense, ragged, device, warmup: int, steps: int):
    """``warmup`` steps, then dense and ragged windows in turns, N_WINDOWS
    each; N_WINDOWS more each if either variant spreads beyond STEADY_SPREAD."""
    timing.window_s(lambda: step(state, dense), warmup, device)
    dense_rates: List[float] = []
    ragged_rates: List[float] = []

    def one_round():
        for _ in range(N_WINDOWS):
            dense_rates.append(one_window(state, step, dense, steps, device))
            ragged_rates.append(one_window(state, step, ragged, steps, device))

    one_round()
    if timing.spread(dense_rates) > STEADY_SPREAD or timing.spread(ragged_rates) > STEADY_SPREAD:
        one_round()
    return dense_rates, ragged_rates


def epoch_slides(n_slides: int, feat_dim: int, seed: int = EPOCH_SEED, bag_size: int = BAG_SIZE):
    """``(lengths, buckets, slides)`` of the epoch simulation, drawn as
    ``bench.py:166-176`` draws them; below ``BAG_SIZE`` the lengths and
    buckets scale by ``bag_size / BAG_SIZE`` (rounded up) for a rehearsal."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(mean=np.log(8000), sigma=0.7, size=n_slides), 1500, 32768).astype(int)
    buckets = EPOCH_BUCKETS
    if bag_size != BAG_SIZE:
        lens = -(-lens * bag_size // BAG_SIZE)
        buckets = tuple(-(-b * bag_size // BAG_SIZE) for b in EPOCH_BUCKETS)
    slides = [{"feats": rng.normal(size=(n, feat_dim)).astype(np.float32), "target": int(rng.integers(0, 2))}
              for n in lens]
    return lens, buckets, slides


def len_histogram(lens: np.ndarray, buckets: Sequence[int]) -> Dict[str, int]:
    return {str(b): int(np.sum((lens > (b // 2)) & (lens <= b))) for b in buckets}


def epoch_sim(state, step, device, batch_size: int, feat_dim: int, bag_size: int = BAG_SIZE,
              n_slides: int = EPOCH_SLIDES, n_epochs: int = EPOCHS, seed: int = EPOCH_SEED) -> Dict:
    """Epoch-level bags/s over the lognormal length histogram (``bench.py:155-240``)."""
    from ..data.bucketing import batch_bags

    lens, buckets, slides = epoch_slides(n_slides, feat_dim, seed, bag_size)

    def epoch_batches(ep_seed: int):
        return [to_device(b, device) for b in batch_bags(slides, batch_size, buckets, shuffle=True, seed=ep_seed)]

    first = epoch_batches(0)
    first_step_s = {}
    for b in first:  # the first step of each shape
        n = int(b["mask"].shape[1])
        if str(n) not in first_step_s:
            first_step_s[str(n)] = timing.window_s(lambda: step(state, b), 1, device)
    timing.window_s(lambda: [step(state, b) for b in first], 1, device)  # a warm epoch
    del first
    rates = []
    for ep in range(1, n_epochs + 1):
        batches = epoch_batches(ep)  # staged on the device before the clock starts
        bags = sum(int(b["bag_valid"].sum()) for b in batches)
        rates.append(bags / timing.window_s(lambda: [step(state, b) for b in batches], 1, device))
        del batches
    per_bucket = {}
    by_n: Dict[int, Dict] = {}
    for b in epoch_batches(0):
        by_n.setdefault(int(b["mask"].shape[1]), b)
    for n, b in sorted(by_n.items()):
        step(state, b)  # re-warm this shape
        per_bucket[str(n)] = BUCKET_WINDOW * batch_size / timing.window_s(lambda: step(state, b), BUCKET_WINDOW,
                                                                          device)
    return {
        "epoch_bags_per_sec": float(np.median(rates)),
        "epoch_rates": rates,
        "n_slides": n_slides,
        "buckets": list(buckets),
        "len_histogram": len_histogram(lens, buckets),
        "per_bucket_bags_per_sec": per_bucket,
        "first_step_s_per_bucket": first_step_s,
        "note": "steady-state epochs of chained steps, one synchronisation an epoch; each epoch's batches staged "
                "on the device before its clock starts, so the driver's host batch making (numpy padding and the "
                "pinned copy, engine/driver.py) is not in this rate; first_step_s_per_bucket is the first step of "
                "each shape (library heuristics, allocator growth), reported apart",
    }


def eval_latency(cfg, model, dense, device, reps: int, warmup: int) -> Dict:
    """Batch-1 ``forward_test`` latency (p50 / p90 synchronised each call,
    the ms a call of chained calls), the link floor and batch-4 slides/s."""
    from ..engine.steps import make_mhim_eval_step

    eval_step = make_mhim_eval_step(cfg, model)
    one = {"feats": dense["feats"][:1], "mask": dense["mask"][:1]}
    floor = timing.link_floor_ms(device)
    timing.window_s(lambda: eval_step(one), 2 * warmup + 1, device)
    per_call = timing.percentiles(timing.call_ms(lambda: eval_step(one), reps, device))
    timing.window_s(lambda: eval_step(one), reps, device)  # re-ramp after the synchronised loop
    chained_ms = timing.window_s(lambda: eval_step(one), reps, device) / reps * 1e3
    eb = {"feats": dense["feats"], "mask": dense["mask"]}
    timing.window_s(lambda: eval_step(eb), MEASURE_STEPS + 1, device)
    b = dense["feats"].shape[0]
    eval_bps = MEASURE_STEPS * b / timing.window_s(lambda: eval_step(eb), MEASURE_STEPS, device)
    return {"infer_p50_ms": per_call["p50"], "infer_p90_ms": per_call["p90"], "infer_reps": reps,
            "infer_chained_ms": chained_ms, "host_roundtrip_floor_ms": floor,
            "infer_p50_minus_link_ms": max(per_call["p50"] - floor, 0.0), "eval_slides_per_sec": eval_bps}


def step_flops(cfg, model, batch, device) -> int:
    """The FLOPs of one train step on the plain path of ``model``'s weights."""
    from ..engine.steps import make_mhim_train_step
    from ..engine.train_state import create_mhim_state

    cfg_p, twin = timing.plain_twin(cfg, model, device)
    state = create_mhim_state(cfg_p, twin, STEPS_PER_EPOCH, seed=0, device=device)
    step = make_mhim_train_step(cfg_p, STEPS_PER_EPOCH, device=device)
    return timing.plain_flops(lambda: step(state, batch))


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--bag_size", type=int, default=BAG_SIZE)
    ap.add_argument("--warmup", type=int, default=WARMUP_STEPS)
    ap.add_argument("--steps", type=int, default=WINDOW_STEPS, help="steps a window")
    ap.add_argument("--reps", type=int, default=LATENCY_REPS, help="eval calls timed")
    ap.add_argument("--detail", default=DETAIL)
    ap.add_argument("--breakdown", default="on", choices=("on", "off"), help="the in-step decomposition")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    device, dev = timing.open_device(args.device)
    from ..utils.kernel_gate import resolve_kernel_gate

    cfg, gate = resolve_kernel_gate(flagship_config(rest), device)
    b, n, d = cfg.batch_size, args.bag_size, cfg.input_dim
    model, state, step = make_state_and_step(cfg, device)
    dense = dense_batch(b, n, d, device)
    lens = ragged_lengths(b, n)
    ragged = dict(dense, mask=torch.as_tensor(np.arange(n)[None, :] < lens[:, None]).to(device))

    t0 = time.perf_counter()
    before = timing.kernel_launches()
    dense_rates, ragged_rates = interleaved_throughput(state, step, dense, ragged, device, args.warmup, args.steps)
    launches = timing.launches_since(before)
    dense_bps, ragged_bps = float(np.median(dense_rates)), float(np.median(ragged_rates))
    sim = epoch_sim(state, step, device, b, d, n)
    lat = eval_latency(cfg, model, dense, device, args.reps, args.warmup)
    flops = step_flops(cfg, model, dense, device)
    hbm = roofline.measure_hbm_ceiling(device)
    decomposition = None
    if args.breakdown == "on":
        decomposition = step_breakdown.run(cfg, device, n, warm=args.warmup, window=args.steps, hbm=hbm)
    n_params = sum(p.numel() for p in model.parameters())
    floors = step_breakdown.bytes_model(cfg, n_params, (b, n, d), {}, hbm["ceiling_gb_s"] * 1e9)
    detail = {
        "dense_bags_per_sec": dense_bps,
        "ragged_bags_per_sec": ragged_bps,
        "dense_windows": dense_rates,
        "ragged_windows": ragged_rates,
        "dense_spread": timing.spread(dense_rates),
        "ragged_spread": timing.spread(ragged_rates),
        "window_steps": args.steps,
        "warmup_steps": args.warmup,
        "launches_in_windows": launches,
        "ragged_lengths": lens.tolist(),
        "epoch_sim": sim,
        **lat,
        "batch": b,
        "bag_size": n,
        "input_dim": d,
        "compute_dtype": cfg.compute_dtype,
        "kernel_gate": {"outcome": gate["outcome"], "seconds": gate["seconds"],
                        "use_flash_attn": cfg.use_flash_attn},
        "roofline": roofline.step_roofline(b / dense_bps * 1e3, flops, floors["_total"]["floor_bytes"], hbm, dev),
        "decomposition": decomposition,
        "seconds": time.perf_counter() - t0,
        "device": dev,
    }
    if args.detail:
        os.makedirs(os.path.dirname(os.path.abspath(args.detail)), exist_ok=True)
        with open(args.detail, "w") as f:
            json.dump(detail, f, indent=1)
    print(json.dumps(detail))
    print(json.dumps({
        "metric": "mhim_train_bags_per_sec_10k",
        "value": dense_bps,
        "unit": f"bags/s ({b} x {n} x {d} bags, MHIM selfattn train step, {cfg.compute_dtype} policy, one "
                f"{dev['kind']})",
        "ragged_bags_per_sec": ragged_bps,
        "infer_p50_ms": lat["infer_p50_ms"],
        "mfu": detail["roofline"]["mfu"],
        "device": dev,
    }))
    return detail


if __name__ == "__main__":
    main()
