"""The readings that the limits of ``limits/<workload>.json`` are set from,
at the cell's own size on the card, in one process:

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 [--control-seeds 4,5,6]

For each of ``--seeds`` it sets the cell up as a run does and prints the
numbers of ``compare.py`` for the program against the reference (a sound
run). For each of ``--control-seeds`` it prints them for the control (the
reference computed with fp8 operands, put in the program's place) and,
for a train cell, for the fault of half the batch left out (the
reference's loss a mean over the first half of the bags). With
``--witness``, beside each program reading that of the reference computed
with bf16 operands against the fp32 one. One JSON object a line.

``--rates 20,25,...`` sweeps a serve cell's open loop over those offered
rates instead, one window of ``--seconds`` each, on each of ``--seeds``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import cell, compare, traffic, weights
from .reference import common


def train_readings(conf, mix, seed, device, program: bool, witness: bool = False):
    out = {}
    if program:
        t = time.time()
        w, batches, prog, state, step, got = cell.train_setup(conf, mix, seed, device)
        out["setup_s"] = time.time() - t
        spe = len(batches)
        del prog, state, step
    else:
        ref = cell.reference_module(conf)
        fields = conf["program"]
        w = weights.make(ref.param_spec(fields), traffic.sub_seed(seed, cell.SEED_WEIGHTS), device)
        lens = traffic.slide_lengths(mix)
        plan = traffic.batch_plan(lens, mix["buckets"], int(mix["batch_size"]),
                                  traffic.sub_seed(seed, cell.SEED_PLAN))
        batches = cell.stage_batches(mix, lens, plan[:cell.COMPARED_STEPS], fields["input_dim"],
                                     fields["n_classes"], traffic.sub_seed(seed, cell.SEED_DATA), device)
        spe = len(plan)
    compared = batches[:cell.COMPARED_STEPS]
    del batches
    cell._free(device)
    t = time.time()
    want = cell.train_reference(conf, w, compared, seed, spe, common.FP32)
    out["reference_s"] = time.time() - t
    rows = []
    if program:
        rows.append(("program", compare.train_numbers(got, want, w)))
        if witness:
            bf = cell.train_reference(conf, w, compared, seed, spe, common.Precision("bf16"))
            rows.append(("bf16", compare.train_numbers(bf, want, w)))
    else:
        ctl = cell.train_reference(conf, w, compared, seed, spe, common.Precision("fp8"))
        rows.append(("control", compare.train_numbers(ctl, want, w)))
        half = cell.train_reference(conf, w, compared, seed, spe, common.FP32, fault="half")
        rows.append(("half", compare.train_numbers(half, want, w)))
    return rows, out


def serve_readings(conf, mix, seed, device, program: bool, seconds: float):
    run = cell.Run("calibrate", "serve", conf, mix)
    w, pool, prog, scorer = cell.serve_setup(conf, mix, seed, device)
    served = cell.serve_window(run, scorer, pool, seed, seconds, False, device)
    del scorer, prog
    cell._free(device)
    picks = cell.serve_sample(served, pool, int(mix["sample"]), seed)
    t = time.time()
    want = [cell.serve_reference(conf, w, pool[served[j][0]], device, common.FP32) for j in picks]
    out = {"reference_s": time.time() - t, "requests": len(served)}
    if program:
        return [("program", compare.serve_numbers([served[j][1] for j in picks], want))], out
    ctl = [cell.serve_reference(conf, w, pool[served[j][0]], device, common.Precision("fp8")) for j in picks]
    return [("control", compare.serve_numbers(ctl, want))], out


def sweep(conf, mix, seed, device, rates, seconds: float):
    """An open-loop window at each of ``rates`` on one set-up: the offered
    and the completed rate, the p95, and how late the last tenth of the
    requests went out against the first tenth (a backlog that grows)."""
    w, pool, prog, scorer = cell.serve_setup(conf, mix, seed, device)
    for rate in rates:
        run = cell.Run("sweep", "serve", conf, mix)
        served = cell.serve_window(run, scorer, pool, seed, seconds, False, device, rate)
        tenth = max(len(run.late_ms) // 10, 1)
        yield {"rate_per_s": rate, "completed_per_s": len(served) / run.window_s, "requests": len(served),
               "p50_ms": float(np.percentile(run.latencies_ms, 50)), "p95_ms": float(np.percentile(run.latencies_ms, 95)),
               "late_first_tenth_ms": float(np.mean(run.late_ms[:tenth])),
               "late_last_tenth_ms": float(np.mean(run.late_ms[-tenth:]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0, help="a serve cell's window before its sample")
    ap.add_argument("--rates", default="", help="a serve cell: sweep these offered rates (requests/s) instead")
    ap.add_argument("--witness", action="store_true",
                    help="beside each program reading, the reference computed with bf16 operands (train cells)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    man = cell.manifest()
    wl = next(c for c in man["workloads"] if c["name"] == args.workload)
    conf = cell.load_json(cell.ROOT / next(c for c in man["configs"] if c["name"] == wl["config"])["file"])
    mix = traffic.load(wl["traffic"])
    if args.rates:
        for seed in [int(s) for s in args.seeds.split(",") if s]:
            for row in sweep(conf, mix, seed, device, [float(r) for r in args.rates.split(",")], args.seconds):
                print(json.dumps({"workload": args.workload, "seed": seed, **row}), flush=True)
        return 0
    jobs = [(int(s), True) for s in args.seeds.split(",") if s] + \
           [(int(s), False) for s in args.control_seeds.split(",") if s]
    for seed, is_prog in jobs:
        if mix["mode"] == "train":
            rows, extra = train_readings(conf, mix, seed, device, is_prog, args.witness)
        else:
            rows, extra = serve_readings(conf, mix, seed, device, is_prog, args.seconds)
        for kind, numbers in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **numbers, **extra}), flush=True)
        cell._free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
