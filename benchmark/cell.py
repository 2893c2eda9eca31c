"""One run of one cell: set-up, the measured window, the check of what the
timed path produced against the plain reference, and the result.

Everything that belongs to one configuration, one traffic mix or one
metric is found by name: ``configs/<config>.json`` (the program's fields
and the name of its reference module in ``reference/``),
``traffic/<traffic>.json`` (read by ``traffic.py``), ``metrics/<metric>.py``
(a reader ``read(run)``) and ``limits/<workload>.json`` (the limit of each
number the check compares). The traffic's ``mode`` picks the driver here:

- ``train``: the mix's batches staged on the card; set-up builds the train
  state and drives it through its first three steps (the ones the
  reference follows) and one step of every other bucket shape; the window
  runs the step over the batches in seeded passes until ``--seconds``
  have gone, then synchronises;
- ``serve``: a pool of slides in pageable host memory; set-up scores one
  slide of every bucket shape; the window is an open loop at the mix's
  fixed rate, each request timed from when it was due until its logits
  are on the host.

A traced run (``--trace 1``) runs one whole pass of the batches or of the
pool three times instead, once unprofiled for its time and twice
profiled (``trace.py``), and reports the per-layer metrics.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import itertools
import json
import os
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import compare, program, trace, traffic, weights, workcounts
from .reference import common

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
COMPARED_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "mhim_mil_tpu")
# the purposes of the run's seed (traffic.sub_seed)
SEED_WEIGHTS, SEED_PLAN, SEED_DATA, SEED_STEP, SEED_ORDER, SEED_SAMPLE = range(1, 7)


def manifest(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def reference_module(conf: Dict):
    return importlib.import_module(f"benchmark.reference.{conf['reference']}")


def load_reader(name: str, root: Path = HERE) -> Callable:
    """The ``read`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: Dict, workload: str, traced: bool) -> List[Dict]:
    """The cell's metrics: with ``traced`` its per-layer ones, else its end-to-end ones."""
    e2e = [m for m in man["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    if not traced:
        return e2e
    return [m for m in man["per_layer"] if workload in m["workloads"]]


def process_start() -> float:
    """The wall-clock time this process started, from ``/proc``."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    workload: str
    mode: str
    conf: Dict
    mix: Dict
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    bags: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    late_ms: List[float] = dataclasses.field(default_factory=list)  # how late each request went out
    trace: Optional[trace.Trace] = None
    traced_buckets: Counter = dataclasses.field(default_factory=Counter)  # bucket → steps or requests traced
    flops_of: Optional[Callable[[int], float]] = None  # reference FLOPs of one step or request at a bucket


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiler():
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    return profile(activities=acts, record_shapes=True)


def traced_pass(run: Run, order, one: Callable[[int], None], device: torch.device,
                begin: Callable[[], None] = lambda: None) -> None:
    """``one(i)`` for each ``i`` of ``order``, three times, ``begin()``
    before each: unprofiled, timed on the host clock (the window that
    ``idle_share`` and ``mfu`` divide by, since a profile slows a
    host-paced pass); profiled with the host's ops and shapes inside
    ``bench.window``; then profiled with the device's activity alone, for
    the device's busy time (``trace.py``)."""
    sync(device)
    begin()
    t0 = time.perf_counter()
    for i in order:
        one(i)
    sync(device)
    plain_s = time.perf_counter() - t0
    with profiler() as prof:
        with record_function(trace.WINDOW):
            begin()
            for i in order:
                one(i)
            sync(device)
    full = trace.read(prof)
    light = None
    if device.type == "cuda":
        sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            begin()
            t0 = time.perf_counter()
            for i in order:
                one(i)
            sync(device)
            window_s = time.perf_counter() - t0
        light = trace.read_device(prof, window_s, trace.range_names(prof.events()) | set(full.ops))
    run.trace = dataclasses.replace(trace.merge(full, light), window_s=plain_s)


# ---- train ----------------------------------------------------------------------------

def stage_batches(mix: Dict, lens: np.ndarray, plan: List[Dict], d: int, n_classes: int, seed: int,
                  device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """The planned batches on the device in fp32: features N(0, 1) from
    ``seed`` on a generator of the device, zero past each bag's length and
    in the padding bags; labels uniform over the classes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = int(mix["batch_size"])
    out = []
    for chunk in plan:
        n = chunk["bucket"]
        lengths = torch.zeros(b, dtype=torch.long)
        lengths[:len(chunk["slides"])] = torch.as_tensor([int(lens[i]) for i in chunk["slides"]])
        mask = (torch.arange(n)[None, :] < lengths[:, None]).to(device)
        feats = torch.randn((b, n, d), generator=gen, device=device) * mask[..., None]
        target = torch.randint(0, n_classes, (b,), generator=gen, device=device).to(torch.int32)
        out.append({"feats": feats, "mask": mask, "bag_valid": (lengths > 0).to(device), "target": target})
    return out


class Marks(dict):
    """Seconds of each stage of set-up, the device drained at each mark."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device, self.t = device, time.time()

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.time()
        self[name], self.t = now - self.t, now


def train_setup(conf: Dict, mix: Dict, seed: int, device: torch.device, marks: Optional[Marks] = None):
    """Weights, batches, the program's state and step; the state driven
    through the compared steps, whose readings it returns, and through one
    step of every other bucket shape."""
    marks = marks if marks is not None else Marks(device)
    fields = conf["program"]
    ref = reference_module(conf)
    w = weights.make(ref.param_spec(fields), traffic.sub_seed(seed, SEED_WEIGHTS), device)
    lens = traffic.slide_lengths(mix)
    plan = traffic.batch_plan(lens, mix["buckets"], int(mix["batch_size"]), traffic.sub_seed(seed, SEED_PLAN))
    batches = stage_batches(mix, lens, plan, fields["input_dim"], fields["n_classes"],
                            traffic.sub_seed(seed, SEED_DATA), device)
    marks("inputs")
    prog = program.Program(fields, w, device)
    state, step = prog.train(len(plan), traffic.sub_seed(seed, SEED_STEP))
    marks("program")
    seen = {}
    for i in range(COMPARED_STEPS):
        out = step(state, batches[i])
        seen[i] = {k: (out[k].detach().float().clone() if k in out else None)
                   for k in ("loss", "keep_num", "main_loss", "aux_loss")}
        if i == 0:
            b1 = program.adam_betas(state)[0]
            grads = {k: v / (1.0 - b1) for k, v in program.adam_first_moments(state).items()}
    after = program.snapshot(state)
    marks("compared_steps")
    shapes = {batches[i]["mask"].shape[1] for i in range(COMPARED_STEPS)}
    for b in batches:
        if b["mask"].shape[1] not in shapes:
            step(state, b)
            shapes.add(b["mask"].shape[1])
    marks("warm_steps")
    readings = {"losses": [seen[i]["loss"] for i in range(COMPARED_STEPS)],
                "keep": [seen[i]["keep_num"] for i in range(COMPARED_STEPS)],
                "parts": [(seen[i]["main_loss"], seen[i]["aux_loss"]) for i in range(COMPARED_STEPS)],
                "grads": grads, "after": after}
    return w, batches, prog, state, step, readings


def train_reference(conf: Dict, w: Dict, batches: List[Dict], seed: int, steps_per_epoch: int,
                    prec: common.Precision, fault: Optional[str] = None) -> Dict:
    """The reference through the compared steps from the same weights,
    batches and draws."""
    ref = reference_module(conf)
    gen = torch.Generator(device=batches[0]["feats"].device).manual_seed(traffic.sub_seed(seed, SEED_STEP))
    tr = ref.Trainer(conf["program"], w, gen, prec, steps_per_epoch)
    with common.no_tf32():
        outs = [tr.step(batches[i], fault) for i in range(COMPARED_STEPS)]
    after = {"student": {**tr.params, **tr.buffers}}
    if getattr(tr, "teacher", None) is not None:
        after["teacher"] = tr.teacher
    return {"losses": [o["loss"] for o in outs], "keep": [o.get("keep_num") for o in outs],
            "parts": [(o.get("main_loss"), o.get("aux_loss")) for o in outs],
            "grads": outs[0]["grads"], "after": after}


def train_window(run: Run, state, step, batches: List[Dict], seed: int, seconds: float, traced: bool,
                 device: torch.device) -> List[torch.Tensor]:
    valid = [int(b["bag_valid"].sum()) for b in batches]
    rng_seed = traffic.sub_seed(seed, SEED_ORDER)
    losses = []
    if traced:
        order = traffic.pass_orders(len(batches), rng_seed, 1)[0]

        def one(i):
            with record_function("bench.step"):
                losses.append(step(state, batches[i])["loss"])

        traced_pass(run, order, one, device)
        run.traced_buckets.update(int(batches[i]["mask"].shape[1]) for i in order)
        run.steps = len(order)
        run.bags = sum(valid[i] for i in order)
        return losses
    t0 = time.perf_counter()
    p = 0
    done = False
    while not done:
        for i in traffic.pass_orders(len(batches), rng_seed + p, 1)[0]:
            losses.append(step(state, batches[i])["loss"])
            run.steps += 1
            run.bags += valid[i]
            if time.perf_counter() - t0 >= seconds:
                done = True
                break
        p += 1
    sync(device)
    run.window_s = time.perf_counter() - t0
    return losses


# ---- serve -------------------------------------------------------------------------------

def serve_pool(mix: Dict, d: int, seed: int, device: torch.device) -> List[np.ndarray]:
    """The cohort's fp32 features in pageable host memory: one draw on the
    device, copied to the host once, cut into slides."""
    lens = traffic.slide_lengths(mix)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn((int(lens.sum()), d), generator=gen, device=device).cpu().numpy()
    cuts = np.cumsum(lens)[:-1]
    return np.split(flat, cuts)


def serve_setup(conf: Dict, mix: Dict, seed: int, device: torch.device, marks: Optional[Marks] = None):
    marks = marks if marks is not None else Marks(device)
    fields = conf["program"]
    ref = reference_module(conf)
    w = weights.make(ref.param_spec(fields), traffic.sub_seed(seed, SEED_WEIGHTS), device)
    pool = serve_pool(mix, fields["input_dim"], traffic.sub_seed(seed, SEED_DATA), device)
    marks("inputs")
    prog = program.Program(fields, w, device)
    scorer = prog.scorer()
    marks("program")
    warmed = set()
    for x in pool:
        n = scorer.bucket_for(len(x))
        if n not in warmed:
            scorer.score(x)
            warmed.add(n)
    marks("warm_requests")
    return w, pool, prog, scorer


def serve_window(run: Run, scorer, pool: List[np.ndarray], seed: int, seconds: float, traced: bool,
                 device: torch.device, rate: Optional[float] = None) -> List[tuple]:
    """An open loop at the mix's ``rate_per_s`` (or ``rate``): each request
    is due a gap (``traffic.pass_gaps``) after the one before, counted from
    the window's start, and goes out when it is due, or at once when the
    one before ends late; its latency runs from when it was due until its
    logits are on the host. Slides come pass after pass, each pass in a
    seeded order. Returns ``(slide, logits)`` of every request, in order;
    ``run.late_ms`` holds how late each went out."""
    mix = run.mix if rate is None else {**run.mix, "rate_per_s": rate}
    served = []
    rng_seed = traffic.sub_seed(seed, SEED_ORDER)
    clock = {"t0": 0.0, "due": 0.0}

    def begin():
        clock["t0"], clock["due"] = time.perf_counter(), 0.0

    def one(i, gap):
        clock["due"] += gap
        due = clock["t0"] + clock["due"]
        while (wait := due - time.perf_counter()) > 0:
            time.sleep(wait - 5e-4 if wait > 1e-3 else 0)
        run.late_ms.append((time.perf_counter() - due) * 1e3)
        with record_function("bench.request"):
            logits = scorer.score(pool[i])["logits"]
        run.latencies_ms.append((time.perf_counter() - due) * 1e3)
        served.append((int(i), logits))

    if traced:
        order = traffic.pass_orders(len(pool), rng_seed, 1)[0]
        gaps = traffic.pass_gaps(mix, len(pool), rng_seed)
        traced_pass(run, list(zip(order, gaps)), lambda ig: one(*ig), device, begin)
        run.traced_buckets.update(scorer.bucket_for(len(pool[i])) for i in order)
        return served
    schedule = ((i, gap) for p in itertools.count()
                for i, gap in zip(traffic.pass_orders(len(pool), rng_seed + p, 1)[0],
                                  traffic.pass_gaps(mix, len(pool), rng_seed + p)))
    begin()
    for i, gap in schedule:
        if clock["due"] + gap >= seconds:
            break
        one(i, gap)
    run.window_s = time.perf_counter() - clock["t0"]
    return served


def serve_sample(served: List[tuple], pool: List[np.ndarray], k: int, seed: int) -> List[int]:
    """The requests held to the reference: ``k`` drawn from the seed, and the
    first request of the longest slide."""
    rng = np.random.default_rng(traffic.sub_seed(seed, SEED_SAMPLE))
    picks = set(rng.choice(len(served), size=min(k, len(served)), replace=False).tolist())
    longest = int(np.argmax([len(x) for x in pool]))
    first = next((j for j, (i, _) in enumerate(served) if i == longest), None)
    if first is not None:
        picks.add(first)
    return sorted(picks)


def serve_reference(conf: Dict, w: Dict, x: np.ndarray, device: torch.device, prec: common.Precision) -> np.ndarray:
    """The reference's logits of one slide, padded to its bucket as a request is."""
    fields = conf["program"]
    n = traffic.pick_bucket(len(x), fields["bucket_sizes"])
    feats = torch.zeros((1, n, x.shape[1]), device=device)
    feats[0, :len(x)] = torch.as_tensor(x, device=device)
    mask = torch.arange(n, device=device)[None, :] < len(x)
    with common.no_tf32():
        return reference_module(conf).infer(fields, w, feats, mask, prec)[0].cpu().numpy()


# ---- the run -------------------------------------------------------------------------------

def reference_flops(conf: Dict, mode: str, w: Dict, example: Dict[int, object], device) -> Callable[[int], float]:
    """The FLOPs of one step (``train``: a batch) or one request (``serve``:
    a slide) of the reference at a bucket, counted by ``FlopCounterMode``
    (``workcounts.flop_counter``), each bucket once."""
    cache: Dict[int, float] = {}
    ref = reference_module(conf)

    def flops(bucket: int) -> float:
        if bucket not in cache:
            with workcounts.flop_counter() as counter, common.no_tf32():
                if mode == "train":
                    gen = torch.Generator(device=device).manual_seed(0)
                    ref.Trainer(conf["program"], w, gen, common.FP32, 1).step(example[bucket])
                else:
                    serve_reference(conf, w, example[bucket], device, common.FP32)
            cache[bucket] = float(counter.get_total_flops())
        return cache[bucket]

    return flops


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device: torch.device,
             root: Path = ROOT, t_start: Optional[float] = None) -> Dict:
    """One run of ``workload``; returns the result line's object."""
    t_start = time.time() if t_start is None else t_start
    man = manifest(root)
    wl = next((c for c in man["workloads"] if c["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in man["configs"] if c["name"] == wl["config"])
    conf = load_json(root / cfg_entry["file"])
    bench = root / "benchmark"
    mix = traffic.load(wl["traffic"], bench / "traffic")
    limits = load_json(bench / "limits" / f"{workload}.json")
    run = Run(workload, mix["mode"], conf, mix)
    marks = Marks(device)
    marks["before_harness"] = marks.t - t_start

    if run.mode == "train":
        w, batches, prog, state, step, got = train_setup(conf, mix, seed, device, marks)
        sync(device)
        t0 = time.time()
        run.setup_s = t0 - t_start
        losses = train_window(run, state, step, batches, seed, seconds, traced, device)
        attempted = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        by_bucket = {}
        for b in batches:
            by_bucket.setdefault(int(b["mask"].shape[1]), b)
        compared = batches[:COMPARED_STEPS]
        spe = len(batches)
        del state, step, prog, batches, losses
        _free(device)
        want = train_reference(conf, w, compared, seed, spe, common.FP32)
        numbers = compare.train_numbers(got, want, w)
        run.flops_of = reference_flops(conf, "train", w, by_bucket, device)
    else:
        w, pool, prog, scorer = serve_setup(conf, mix, seed, device, marks)
        sync(device)
        t0 = time.time()
        run.setup_s = t0 - t_start
        served = serve_window(run, scorer, pool, seed, seconds, traced, device)
        attempted = len(served)
        failed = sum(int(not np.all(np.isfinite(lg))) for _, lg in served)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        del scorer, prog
        _free(device)
        picks = serve_sample(served, pool, int(mix["sample"]), seed)
        got = [served[j][1] for j in picks]
        want = [serve_reference(conf, w, pool[served[j][0]], device, common.FP32) for j in picks]
        numbers = compare.serve_numbers(got, want)
        example = {}
        for x in pool:
            example.setdefault(traffic.pick_bucket(len(x), conf["program"]["bucket_sizes"]), x)
        run.flops_of = reference_flops(conf, "serve", w, example, device)

    checks = compare.judge(numbers, limits)
    correct = failed == 0 and all(c["ok"] for c in checks.values())
    metrics = {}
    for m in cell_metrics(man, workload, traced):
        value = load_reader(m["name"], bench)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power"] = nvidia_smi()
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
              "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in run.trace.device_ops],
                               "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    result["setup_parts"] = dict(marks)
    if run.late_ms:
        result["load"] = {"rate_per_s": float(mix["rate_per_s"]), "requests": len(run.late_ms),
                          "late_p95_ms": float(np.percentile(run.late_ms, 95)), "late_max_ms": max(run.late_ms)}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def _free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def nvidia_smi() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread: {e}"
    return out.strip().splitlines()[0] if out.strip() else "unread"
