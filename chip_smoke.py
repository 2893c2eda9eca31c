"""Smoke run of the PyTorch port on one Hopper card: ``python3 chip_smoke.py``.

Drives the port's paths at the flagship width (``config/mhim_c16.yaml``,
input_dim 1024, inner_dim 512, 8 heads, 256 landmarks, 2 TransLayers) on
bags of 10,240 instances at batch 4, with random weights from a seeded
``torch.Generator``: the MHIM-selfattn serving path (``forward_test``
through the ``Scorer``, the eval-mode ``forward_teacher``), the MHIM train
step, and the MHIM-attn serving path; then the 2D-Mamba survival model of
the README (``config/feat_surv.yaml``, ``--model 2dmamba``, ``surv_blca``:
input 1024, width 128, one layer, 16 states, the 275 × 381 BLCA grid) on
its eval step and its scorer. Phases, each of which fails the run:

1. device: a CUDA card of capability 9.0, its name and power limit;
2. build: ``nvcc`` builds every kernel from ``mhim_mil_torch/csrc``, all at once;
3. kernels: K1, K2 and K4 against their plain versions in fp32 at the
   flagship shapes (full and ragged masks; K1 and K2 at batch 4 and at
   batch 1, timed at both beside their ``scaled_dot_product_attention``
   yardsticks, with bounds that count their products on the tensor cores
   as three TF32 products each) and a small odd shape; K3's outputs and
   q/k/v gradients at the student's shape against autograd through the
   plain attention in fp32, and its gradients against the plain attention
   in fp64 by the kernel gate's VJP criterion, and its pseudo-inverse as K3p
   launches alone (the profiler's record); K3p, the Newton–Schulz
   pseudo-inverse on the tensor cores, against ``moore_penrose_pinv`` and
   its autograd in fp32 and against fp64 on the attn2 of the student's and
   the flagship's shapes, timed beside ``torch.bmm``; K2b and K1b, the
   backwards of K2's and K1's passes that K3's backward launches, against their plain
   versions at the student's shape and at head dims 128 and 256, timed with
   their bounds beside the backward of ``scaled_dot_product_attention``;
   K5 against its plain
   version at the BLCA grid and the serving raster grid in fp32 and bf16, a
   ragged 5 × 11 grid, a segment edge of the cluster layout and a row of
   1,000 columns (and rows of 1,500, 2,100 and 4,200 columns), and K6 against
   ``x + 1`` (beside an empty launch), with times, bounds and library
   yardsticks, K4 as one CUDA launch a call; the shapes the
   kernels are not built for: K1/K2 at head dims 96, 128, 192 and 256
   (timed at 128 and 256), K4 at 1,536 columns, K5 at 32
   states on the BLCA grid;
4. serving: the selfattn kernel path against the plain path on the whole
   model in fp32, then the scorer's requests under the default bf16 policy;
5. train: one flagship train step on the kernel path against the plain path
   in fp32 from the same weights and draws, then steps under bf16;
6. attn: MHIM-attn ``forward_test`` on the kernel path against the plain
   path in fp32, then the scorer's requests under bf16;
7. 2dmamba: the eval step on one 20,000-instance bag on the BLCA grid, the
   kernel path (K5) against the plain path in fp32 and bf16 against fp32,
   then the scorer's requests on the raster grid under bf16;
8. driver: ``mhim_mil_torch.main.main`` with ``use_flash_attn`` on auto, so
   the kernel gate builds and launches K6 in its probe and runs the kernel
   check: two folds of the flagship on synthetic bags of 5,120-10,240
   instances in the 10,240 bucket, two epochs each, with the student and
   EMA bests final-tested; the ``script_mode test`` reload of those bests;
   then one fold of the 2dmamba survival model, training on the plain scan
   and evaluating through K5.

Phase 3 also holds K6, the gate's probe, against its plain version, and K5
on rows wider than a cluster of blocks holds (1,500, 2,100 and 4,200
columns). Phases 4-8 each reset the launch counts before their main-path
runs and read them after; the kernels' launches are the sums of those
readings, plus the K6 launches of the gate's probe.

The line before the last lists the kernels as JSON; the last line is the
run's JSON verdict. Any failure exits nonzero before it.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

PEAK_FP32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM data sheet, TF32 on the tensor cores, dense
TF32_PRODUCTS = 3  # K1 and K2 take each fp32 product as hi·hi + hi·lo + lo·hi in TF32
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# exponentials per second on the special-function units: 16 per SM and
# clock (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0), 132 SMs, 1.98 GHz boost clock (H100 SXM)
PEAK_EXP = 132 * 16 * 1.98e9
F32 = 4
SERVING_REPEATS = 20  # requests of each kind timed; the median has 10 samples beyond it


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, iters: int = 10):
    """Device time of one call of ``fn``: the summed durations of the kernels
    and copies it puts on the card (``torch.profiler``), over ``iters``
    calls after a warm-up. Unlike :func:`time_ms` it leaves out the gaps in
    which the card waits for the host to launch the next kernel. The
    profiler now and then returns fewer records than there were launches
    (a count short of a multiple of ``iters``), so each kernel counts its
    mean record times its launches a call, ``round(count / iters)``; a
    shortfall is logged. None when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.count and e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    per_call = [max(1, round(e.count / iters)) for e in kernels]
    us = sum(e.self_device_time_total / e.count * k for e, k in zip(kernels, per_call))
    seen, want = sum(e.count for e in kernels), iters * sum(per_call)
    if seen < want:
        log(f"  (the profiler returned {seen} of {want} kernel records; device time from each kernel's mean record)")
    return us / 1e3 if us > 0 else None


def timed(r: dict, kern, plain, lib=None, plain_iters: int = 20):
    """Fill ``r`` with the CUDA-event medians ``ms``, ``plain_ms``,
    ``library_ms`` and the device times ``device_ms``, ``plain_device_ms``,
    ``library_device_ms`` of the kernel path, the plain version and the
    library call (None where there is no library call). A slow plain
    version gets ``plain_iters`` event timings (and half as many profiled)."""
    for key, fn, iters in (("", kern, 20), ("plain_", plain, plain_iters), ("library_", lib, 20)):
        r[f"{key}ms"] = time_ms(fn, iters) if fn is not None else None
        r[f"{key}device_ms"] = device_ms(fn, max(1, iters // 2)) if fn is not None else None


def fmt_ms(r: dict, key: str) -> str:
    dev = r[f"{key}device_ms"]
    return f"{r[f'{key}ms']:.4f} ms (device {'not measured' if dev is None else f'{dev:.4f} ms'})"


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        fail(f"{name}: {int(bad.sum())} entries off, max |d| {err.max().item():.3e} (rtol {rtol}, atol {atol})")
    return err.max().item()


def check_rel(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not torch.isfinite(got).all() or err > tol * scale:
        fail(f"{name}: max |d| {err:.3e} > {tol} * max |ref| {scale:.3e}")
    return err


# ---- phase 1: device ---------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an H100")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ---- phase 2: build ----------------------------------------------------------


def phase_build():
    from mhim_mil_torch.kernels import build_all

    t0 = time.perf_counter()
    paths = build_all()
    log(f"build: {sorted(paths)} in {time.perf_counter() - t0:.2f} s")


# ---- phase 3: kernels against their plain versions ----------------------------


def tensor_core_bounds(flops: float, nbytes: float, exps: float) -> dict:
    """The least times of a fp32 function whose products run on the tensor
    cores as three TF32 products each (hi·hi + hi·lo + lo·hi, the split that
    keeps fp32's accuracy), beside its bytes and its exponentials on the
    special-function units; ``fp32`` is the time of the same products as fp32
    FMAs outside the tensor cores. The bound is the largest of the first
    three."""
    t = {"tensor": TF32_PRODUCTS * flops / PEAK_TF32_FLOPS * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3,
         "exp": exps / PEAK_EXP * 1e3, "fp32": flops / PEAK_FP32_FLOPS * 1e3}
    bound = max(t["tensor"], t["bytes"], t["exp"])
    return {"bound_ms": bound, "bound_by": "bytes" if t["bytes"] >= bound else "operations",
            "bound_parts_ms": t}


def bounds(name, o, h, m, dh) -> dict:
    """Least time for the work this run's data needs: the valid tokens' rows
    read once, outputs written once; sim and the product with V (K1) or
    sim1, the product with mid and sim3 (K2) over the valid tokens, and one
    exponential per (landmark, valid token) and product."""
    b, _, n, _ = o["q"].shape
    n_valid = int(o["mask"].sum())  # summed over bags
    small = b * h * m * dh * F32  # one [B,H,m,dh] operand
    if name == "K1":
        flops, exps = 4 * h * m * dh * n_valid, h * m * n_valid
        nbytes = small + 2 * h * n_valid * dh * F32 + b * n + small + 2 * b * h * m * F32
    else:
        flops, exps = 6 * h * m * dh * n_valid, 2 * h * m * n_valid
        nbytes = (2 * h * n_valid * dh * F32 + b * n + 3 * small + b * m + 2 * b * h * m * F32
                  + b * h * n * dh * F32 + b * h * n * F32)
    return tensor_core_bounds(flops, nbytes, exps)


def fmt_bound(r: dict) -> str:
    t = r["bound_parts_ms"]
    return (f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: tensor cores 3xTF32 {t['tensor']:.4f}, bytes "
            f"{t['bytes']:.4f}, exponentials {t['exp']:.4f}; fp32 FMAs {t['fp32']:.4f} ms)")


def phase_nystrom_kernels(gen) -> dict:
    """K1 and K2 against their plain versions at the flagship's shapes (batch
    4 full and ragged, batch 1) and a small odd shape; timed at batch 4 and
    batch 1 (every token valid) beside ``scaled_dot_product_attention`` on
    the same operands: (q_l, k, v, key mask) for K1, (q, k_l, mid, landmark
    mask) for K2, which gives ``out`` alone."""
    import torch.nn.functional as F

    from mhim_mil_torch.ops import flash_nystrom as fn
    from mhim_mil_torch.utils.time_nystrom import operands, pass_args

    shapes = [
        ("flagship full", 4, 8, 10241, 64, 256, None),
        ("flagship ragged", 4, 8, 10241, 64, 256, (5121, 10241)),
        ("flagship batch 1", 1, 8, 10241, 64, 256, None),
        ("small odd", 1, 2, 100, 32, 8, None),
        # head dims that --inner_dim / --n_heads give: 768 / 8 (padded to 128) and 512 / 4
        ("dh 96", 2, 8, 10241, 96, 256, (5121, 10241)),
        ("dh 128", 4, 4, 10241, 128, 256, None),
        # head dims above 128 (--inner_dim 512 --n_heads 2, or 768 / 4 padded): two column halves
        ("dh 192", 2, 4, 10241, 192, 256, (5121, 10241)),
        ("dh 256", 4, 2, 10241, 256, 256, None),
    ]
    report = {"K1": {"max_abs_err": 0.0}, "K2": {"max_abs_err": 0.0}}
    for label, b, h, n, dh, m, ragged in shapes:
        if ragged:
            lengths = torch.randint(ragged[0], ragged[1] + 1, (b,), device="cuda", generator=gen)
        else:
            lengths = torch.full((b,), n, device="cuda")
        o = operands(b, h, n, dh, m, lengths, gen)
        a_args, b_args = pass_args(o)

        got_a, want_a = fn.pass_a(*a_args), fn.pass_a_plain(*a_args)
        torch.cuda.synchronize()
        e_a = check_close(f"K1 attn3v [{label}]", got_a[0], want_a[0], 1e-4, 1e-5)
        check_close(f"K1 m3 [{label}]", got_a[1], want_a[1], 1e-4, 1e-5)
        check_close(f"K1 s3 [{label}]", got_a[2], want_a[2], 1e-4, 1e-5)
        got_b, want_b = fn.pass_b(*b_args), fn.pass_b_plain(*b_args)
        torch.cuda.synchronize()
        e_b = check_close(f"K2 out [{label}]", got_b[0], want_b[0], 1e-4, 1e-5)
        e_c = check_rel(f"K2 cls [{label}]", got_b[1], want_b[1], 1e-4)
        log(f"kernels [{label}] B={b} H={h} N={n} dh={dh} m={m} valid={lengths.tolist()}: "
            f"K1 attn3v max|d| {e_a:.3e}; K2 out max|d| {e_b:.3e}, cls max|d| {e_c:.3e} "
            f"(max|cls| {want_b[1].abs().max().item():.3e}); tolerances: rtol 1e-4 atol 1e-5, "
            f"cls max|d| <= 1e-4 max|ref|")
        report["K1"]["max_abs_err"] = max(report["K1"]["max_abs_err"], e_a)
        report["K2"]["max_abs_err"] = max(report["K2"]["max_abs_err"], e_b)

        if label not in ("flagship full", "flagship batch 1", "dh 128", "dh 256"):
            continue
        key_mask = o["mask"][:, None, None, :]
        lm_mask = o["lm_mask"][:, None, None, :]
        timings = {
            "K1": (lambda: fn.pass_a(*a_args), lambda: fn.pass_a_plain(*a_args),
                   lambda: F.scaled_dot_product_attention(o["q_l"], o["k"], o["v"], key_mask, scale=1.0)),
            "K2": (lambda: fn.pass_b(*b_args), lambda: fn.pass_b_plain(*b_args),
                   lambda: F.scaled_dot_product_attention(o["q"], o["k_l"], o["mid"], lm_mask, scale=1.0)),
        }
        for kid, (kern, plain, lib) in timings.items():
            # the flagship at batch 4 fills the kernel's row of the kernels line;
            # batch 1 and head dims 128 and 256 sit inside it
            r = (report[kid] if label == "flagship full"
                 else report[kid].setdefault("batch1" if b == 1 else label.replace(" ", ""), {}))
            timed(r, kern, plain, lib)
            r.update(bounds(kid, o, h, m, dh))
            log(f"{kid} [{label}]: kernel {fmt_ms(r, '')}, plain {fmt_ms(r, 'plain_')}, "
                f"library {fmt_ms(r, 'library_')}, {fmt_bound(r)}")
        del o
        torch.cuda.empty_cache()
    for kid in ("K1", "K2"):
        r = report[kid]
        for name, row in (("batch 4", r), ("batch 1", r["batch1"]), ("dh 128", r["dh128"]),
                          ("dh 256", r["dh256"])):
            if not row["ms"] < row["library_ms"]:
                log(f"{kid} [{name}]: kernel {row['ms']:.4f} ms is not below its library yardstick "
                    f"{row['library_ms']:.4f} ms")
    return report


def k4_bounds(x, mask):
    """K4's least time: the valid rows of x read once (masked rows are
    skipped), logits and mask read, pooled and attn written; 2 FLOPs per
    valid element of x."""
    b, n, d = x.shape
    n_valid = int(mask.sum())
    nbytes = n_valid * d * x.element_size() + b * n * (F32 + 1) + b * d * F32 + b * n * F32
    t_ops, t_bytes = 2 * n_valid * d / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_k4(gen) -> dict:
    """K4 against its plain version: the flagship's (4, 10,240, 512) with a
    full mask, ragged with a fake bag (fp32 and bf16 x), and a small odd
    shape; garbage (NaN) at masked instances. Timed at the full mask."""
    import torch.nn.functional as F

    from mhim_mil_torch.ops import abmil_pool

    r = {"max_abs_err": 0.0}
    for label, b, n, d, ragged, dtype in (
        ("flagship full", 4, 10240, 512, False, torch.float32),
        ("flagship ragged", 4, 10240, 512, True, torch.float32),
        ("flagship ragged bf16", 4, 10240, 512, True, torch.bfloat16),
        ("small odd", 3, 100, 100, True, torch.float32),
        ("D 1536", 4, 10240, 1536, True, torch.float32),  # two column groups, one call
    ):
        x = torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
        logits = 3 * torch.randn(b, n, device="cuda", generator=gen)
        lengths = torch.full((b,), n, device="cuda")
        if ragged:
            lengths = torch.randint(n // 2, n + 1, (b,), device="cuda", generator=gen)
            lengths[2] = 0  # a fake bag
        mask = torch.arange(n, device="cuda")[None] < lengths[:, None]
        x = torch.where(mask[..., None], x, torch.tensor(float("nan"), dtype=dtype, device="cuda"))
        pooled, attn = abmil_pool.fused_abmil_pool(x, logits, mask)
        torch.cuda.synchronize()
        want_pooled, want_attn = abmil_pool.abmil_pool_plain(x, logits, mask)
        e_p = check_close(f"K4 pooled [{label}]", pooled, want_pooled, 1e-5, 1e-5)
        e_a = check_close(f"K4 attn [{label}]", attn, want_attn, 1e-5, 1e-6)
        if ragged and not (torch.all(pooled[2] == 0) and torch.all(attn[2] == 0)):
            fail(f"K4 [{label}]: the fake bag does not pool to zero")
        r["max_abs_err"] = max(r["max_abs_err"], e_p, e_a)
        log(f"K4 [{label}] B={b} N={n} D={d} {dtype} valid={lengths.tolist()}: pooled max|d| {e_p:.3e}, "
            f"attn max|d| {e_a:.3e}; tolerances rtol 1e-5, atol 1e-5 (pooled) / 1e-6 (attn)")
        if label in ("flagship ragged bf16", "D 1536"):
            log(f"K4 [{label}]: kernel {time_ms(lambda: abmil_pool.fused_abmil_pool(x, logits, mask)):.4f} ms, "
                f"bound {k4_bounds(x, mask)[0]:.4f} ms")
        if label != "flagship full":
            continue
        q = torch.ones(b, 1, 1, 1, device="cuda")
        k, v, am = logits[:, None, :, None], x[:, None], mask[:, None, None, :]
        try:
            lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=1.0)
            got_lib = lib()[:, 0, 0]
            r["library"] = "scaled_dot_product_attention(ones[B,1,1,1], logits[B,1,N,1], x[B,1,N,D], mask)"
        except RuntimeError as e:  # no backend takes these shapes: softmax + bmm instead
            log(f"K4 library yardstick: scaled_dot_product_attention refused ({e}); softmax + bmm instead")
            lib = lambda: torch.bmm(torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)[:, None], x)
            got_lib = lib()[:, 0]
            r["library"] = "softmax + bmm"
        check_close("K4 library yardstick", got_lib, want_pooled, 1e-4, 1e-5)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                abmil_pool.fused_abmil_pool(x, logits, mask)
            torch.cuda.synchronize()
        # every device record of 5 calls is K4's one kernel (the profiler drops a record now and then)
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        if not (1 <= len(names) <= 5 and all("abmil_pool_kernel" in name for name in names)):
            fail(f"K4 [{label}]: 5 calls put {len(names)} records on the card, want one launch of abmil_pool_kernel "
                 f"a call: {sorted(set(names))}")
        r["cuda_records_in_5_calls"] = len(names)
        bound_ms, bound_by = k4_bounds(x, mask)
        timed(r, lambda: abmil_pool.fused_abmil_pool(x, logits, mask),
              lambda: abmil_pool.abmil_pool_plain(x, logits, mask), lib)
        r.update(bound_ms=bound_ms, bound_by=bound_by)
        log(f"K4 [{label}]: kernel {fmt_ms(r, '')}, plain {fmt_ms(r, 'plain_')}, library "
            f"{fmt_ms(r, 'library_')} ({r['library']}), bound {bound_ms:.4f} ms ({bound_by}); "
            f"{len(names)} device records in 5 calls, each abmil_pool_kernel (profiler)")
    return {"K4": r}


def k3_bounds(lengths, h, n, m, dh, iters=6) -> dict:
    """K3's least time for forward + backward: the products of the masked
    Nystrom attention per (bag, head) over its valid tokens nv — sim1, sim3,
    attn3@V, attn1@mid (4·nv·m·dh FMAs), sim2 and pinv@attn3V (2·m²·dh),
    the pseudo-inverse's 4 m×m products per iteration (4·iters·m³), the cls
    row (m·nv + m²) — once forward and twice more backward (the two products
    of each gradient), as :func:`tensor_core_bounds` counts them; the
    forward's exponentials (sim1, sim3: 2·m·nv; attn2: m²). Bytes: q, k, v
    and both cotangents read, out, attn and the three gradients written."""
    fmas = sum(4 * nv * m * dh + 2 * m * m * dh + 4 * iters * m ** 3 + m * nv + m * m
               for nv in lengths) * h
    exps = sum(2 * m * nv + m * m for nv in lengths) * h
    b = len(lengths)
    nbytes = (3 + 1 + 1 + 3) * b * h * n * dh * F32 + 2 * b * h * n * F32
    return tensor_core_bounds(2 * 3 * fmas, nbytes, exps)


def phase_k3(gen) -> dict:
    """K3 at the student's shape (B=4, H=8, N=1,027 tokens, ragged): out,
    attn and the q/k/v gradients under random cotangents against autograd
    through the plain nystrom_attention in fp32 (out rtol 1e-4 atol 1e-5,
    the rest max|d| <= 1e-4·max|ref|), the gradients also against the plain
    path in fp64 by kernel_check's VJP criterion; K1b and K2b launched once
    each; the times of forward + backward, with and without attn's
    cotangent (the student never reads attn)."""
    from mhim_mil_torch.ops import flash_nystrom as fn
    from mhim_mil_torch.ops.nystrom import nystrom_attention
    from mhim_mil_torch.utils.kernel_check import vjp_close

    b, h, n, dh, m = 4, 8, 1027, 64, 256
    q, k, v, co = (torch.randn(b, h, n, dh, device="cuda", generator=gen) for _ in range(4))
    q = q * dh ** -0.5
    ca = torch.randn(b, h, n, device="cuda", generator=gen)
    lengths = torch.randint(600, n + 1, (b,), device="cuda", generator=gen)
    lengths[0] = n
    mask = torch.arange(n, device="cuda")[None] < lengths[:, None]

    def run(f, dtype=torch.float32, use_attn=True):
        qq, kk, vv = (t.to(dtype, copy=True).requires_grad_() for t in (q, k, v))
        out, attn = f(qq, kk, vv)
        outs, cots = ((out, attn), (co.to(dtype), ca.to(dtype))) if use_attn else ((out,), (co,))
        return (out.detach(), attn.detach(), *torch.autograd.grad(outs, (qq, kk, vv), cots))

    kern = lambda use_attn=True: run(lambda *t: fn.flash_nystrom(*t, mask, m), use_attn=use_attn)
    plain = lambda use_attn=True: run(lambda *t: nystrom_attention(*t, mask, m, return_attn=True),
                                      use_attn=use_attn)
    before = (fn.pass_a_backward.launches, fn.pass_b_backward.launches)
    got = kern()
    torch.cuda.synchronize()
    if (fn.pass_a_backward.launches, fn.pass_b_backward.launches) != (before[0] + 1, before[1] + 1):
        fail("K3's backward did not launch K1b and K2b once each")
    want = plain()
    errs = [check_close("K3 out", got[0], want[0], 1e-4, 1e-5)]
    for name, g, w in zip(("attn", "dq", "dk", "dv"), got[1:], want[1:]):
        errs.append(check_rel(f"K3 {name}", g, w, 1e-4))
    want64 = run(lambda *t: nystrom_attention(*t, mask, m, return_attn=True), torch.float64)
    crit = []
    for name, g, w32, w64 in zip(("dq", "dk", "dv"), got[2:], want[2:], want64[2:]):
        r, r32 = vjp_close(g, w64), vjp_close(w32, w64)
        crit.append(f"{name} {r['max_abs_err']:.3e} ({r['of_allowance']:.3f} of the allowance; fp32 plain "
                    f"{r32['max_abs_err']:.3e}, {r32['of_allowance']:.3f})")
        if not r["ok"]:
            fail(f"K3 {name}: {r['n_bad']} entries miss the VJP criterion against fp64, max|d| "
                 f"{r['max_abs_err']:.3e}")
    del want64
    from mhim_mil_torch.ops import nystrom_pinv as npv

    for use_attn in (True, False):
        before = npv.pinv_product.launches
        ids = k3p_records(lambda: kern(use_attn))
        runs = [len(run) for run in "".join("p" if i == "K3p" else "." for i in ids).split(".") if run]
        if npv.pinv_product.launches - before != 4 * 72 or len(runs) != 6 or max(runs[0::2]) > 24 \
                or max(runs[1::2]) > 48:
            fail(f"K3 (attn {'used' if use_attn else 'unused'}): in 3 calls its pseudo-inverse ran as K3p runs {runs} "
                 f"in the profiler's record ({npv.pinv_product.launches - before} launches in 4 calls); want a run of "
                 f"at most 24 forward and one of at most 48 backward a call, nothing else between their launches")
        crit.append(f"attn {'used' if use_attn else 'unused'}: its pseudo-inverse K3p alone, runs of {runs} launches "
                    f"in 3 calls; {ids.count('cuBLAS GEMM')} cuBLAS GEMMs in all (the glue's products outside it)")
    r = {"max_abs_err": max(errs), **k3_bounds(lengths.tolist(), h, n, m, dh)}
    timed(r, kern, plain)
    r_na = r.setdefault("no_attn", {})
    timed(r_na, lambda: kern(False), lambda: plain(False))
    log(f"K3 [student] B={b} H={h} N={n} dh={dh} m={m} valid={lengths.tolist()}: out max|d| {errs[0]:.3e}, "
        f"attn/dq/dk/dv max|d| {', '.join(f'{e:.3e}' for e in errs[1:])} against the fp32 plain path "
        f"(tolerances: out rtol 1e-4 atol 1e-5, the rest max|d| <= 1e-4 max|ref|); against the fp64 plain "
        f"path by the VJP criterion: {'; '.join(crit)}; forward+backward {fmt_ms(r, '')}, plain "
        f"{fmt_ms(r, 'plain_')}, {fmt_bound(r)}; without attn's cotangent {fmt_ms(r_na, '')}, plain "
        f"{fmt_ms(r_na, 'plain_')}; no library call computes it")
    return {"K3": r}


def pinv_bounds(g, m, products, matrices) -> dict:
    """K3p's least time for ``products`` products of ``g`` m × m matrices
    (2·g·m³ FLOPs each, on the tensor cores at 3×TF32), and the bytes of the
    function: ``matrices`` [g, m, m] fp32 tensors read or written once."""
    return tensor_core_bounds(products * 2 * g * m ** 3, matrices * g * m * m * F32, 0)


def k3p_records(call, calls: int = 3) -> list:
    """The profiler's device records of ``calls`` calls of ``call`` after a
    warm-up, by id (``time_scan2d.kernel_id``), in the order the card ran
    them: K3p's runs among them show what ran between its launches."""
    from torch.profiler import ProfilerActivity, profile

    from mhim_mil_torch.utils.time_scan2d import kernel_id

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)), key=lambda e: e.time_range.start)
    return [kernel_id(e.name) for e in events]


def phase_k3p(gen) -> dict:
    """K3p, the Newton–Schulz pseudo-inverse on the tensor cores
    (``ops/nystrom_pinv.pseudo_inverse``), on the attn2 of the student's
    ragged shape (B 4, H 8, N 1,027: G 32, m 256) and of the flagship's (B 4,
    H 8, N 10,241, the cls token and bags of 10,240 / 10,240 / 8,000 /
    6,000): the pseudo-inverse and its VJP under a random cotangent against
    ``moore_penrose_pinv`` and its autograd in fp32 (max|d| <= 1e-4·max|ref|),
    and against fp64 by the VJP criterion (``pinv_reference64``: the scale's
    maxes over fp32's ties), the fp32 reference held to it too; 24 launches
    forward and 48 backward. Timed at the student's: forward (beside 24
    ``torch.bmm`` calls in fp32), forward + backward (beside 72), and one
    product beside one ``torch.bmm``."""
    from mhim_mil_torch.ops import nystrom_pinv as npv
    from mhim_mil_torch.ops.nystrom import moore_penrose_pinv
    from mhim_mil_torch.utils.kernel_check import pinv_reference64, vjp_close
    from mhim_mil_torch.utils.time_nystrom import attn2_operand

    r = {"max_abs_err": 0.0, "vjp_max_abs_err": 0.0}
    for label, n, lengths in (("student", 1027, [1027, 943, 717, 846]),
                              ("flagship", 10241, [10241, 10241, 8001, 6001])):
        x = attn2_operand(gen, 4, n, lengths)
        g, m = x.shape[0] * x.shape[1], x.shape[-1]
        cot = torch.randn(x.shape, device="cuda", generator=gen)

        def run(f, dtype=torch.float32):
            xx = x.to(dtype).requires_grad_()
            z = f(xx)
            return z.detach(), torch.autograd.grad(z, xx, cot.to(dtype))[0]

        before = npv.pinv_product.launches
        z, dx = run(npv.pseudo_inverse)
        torch.cuda.synchronize()
        if npv.pinv_product.launches - before != 24 + 48:
            fail(f"K3p [{label}]: {npv.pinv_product.launches - before} launches for a forward and a backward, want 72")
        z32, dx32 = run(moore_penrose_pinv)
        z64, dx64 = run(lambda xx: pinv_reference64(xx, x), torch.float64)
        e_z = check_rel(f"K3p pinv [{label}]", z, z32, 1e-4)
        e_g = check_rel(f"K3p VJP [{label}]", dx, dx32, 1e-4)
        v, v32 = vjp_close(dx, dx64), vjp_close(dx32, dx64)
        if not v32["ok"]:
            fail(f"K3p VJP [{label}]: the fp32 reference misses the VJP criterion against fp64 in {v32['n_bad']} entries")
        if not v["ok"]:
            fail(f"K3p VJP [{label}]: {v['n_bad']} entries miss the VJP criterion against fp64, max|d| "
                 f"{v['max_abs_err']:.3e}")
        r["max_abs_err"] = max(r["max_abs_err"], e_z)
        r["vjp_max_abs_err"] = max(r["vjp_max_abs_err"], e_g)
        log(f"K3p [{label}] G={g} m={m} valid={lengths}: pinv max|d| {e_z:.3e} (max|ref| {z32.abs().max().item():.3e}; "
            f"fp64: kernel {(z - z64).abs().max().item():.3e}, fp32 plain {(z32 - z64).abs().max().item():.3e}), "
            f"VJP max|d| {e_g:.3e} (max|ref| {dx32.abs().max().item():.3e}), tolerance max|d| <= 1e-4 max|ref|; "
            f"VJP against fp64 by the criterion: kernel {v['max_abs_err']:.3e} ({v['of_allowance']:.3f} of the "
            f"allowance), fp32 plain {v32['max_abs_err']:.3e} ({v32['of_allowance']:.3f}); 24 + 48 launches")
        del z64, dx64
        if label != "student":
            continue
        zr = torch.randn_like(x)

        def bmms(count):
            for _ in range(count):
                torch.bmm(x.view(g, m, m), zr.view(g, m, m))

        def fwd_bwd(f):
            xx = x.detach().requires_grad_()
            return torch.autograd.grad(f(xx), xx, cot)

        timed(r, lambda: npv.pseudo_inverse(x), lambda: moore_penrose_pinv(x), lambda: bmms(24))
        r.update(pinv_bounds(g, m, 24, 2), library="24 torch.bmm calls in fp32 on [32, 256, 256]")
        rb = r.setdefault("backward", {"library": "72 torch.bmm calls in fp32"})
        timed(rb, lambda: fwd_bwd(npv.pseudo_inverse), lambda: fwd_bwd(moore_penrose_pinv), lambda: bmms(72))
        rb.update(pinv_bounds(g, m, 72, 4))
        rp = r.setdefault("product", {"library": "one torch.bmm in fp32"})
        timed(rp, lambda: npv.pinv_product(x, zr), lambda: npv.pinv_product_plain(x, zr), lambda: bmms(1))
        rp.update(pinv_bounds(g, m, 1, 3))
        for name, row in (("forward, 24 products", r), ("forward + backward, 72 products", rb),
                          ("one product", rp)):
            log(f"K3p [student, {name}]: kernel {fmt_ms(row, '')}, plain {fmt_ms(row, 'plain_')}, library "
                f"({row['library']}) {fmt_ms(row, 'library_')}, {fmt_bound(row)}")
    return {"K3p": r}


def k2b_bounds(mask, h, m, dh, cls: bool) -> dict:
    """K2b's least time: its function's products over the valid tokens nv of
    each (bag, head) — s1 = q·k_lᵀ, dP1 = d_out·midᵀ, d_q, d_kl, d_mid
    (5·nv·m·dh FMAs), with the cls term also s3 = q_l·kᵀ, d_k and d_ql
    (3·nv·m·dh) — on the tensor cores at 3×TF32, the exponentials of P1 (and
    E) on the special-function units, and its bytes: the valid rows of q,
    d_out, K2's out (and k, d_cls) read once, the landmark operands read,
    every gradient written once."""
    b, n = mask.shape
    nv = int(mask.sum())  # summed over bags
    per = 8 if cls else 5
    small = b * h * m * dh * F32
    nbytes = (h * nv * dh * F32 * (4 if cls else 3) + (h * nv * F32 if cls else 0) + b * n + b * m
              + small * (3 if cls else 2) + (2 * b * h * m * F32 if cls else 0)
              + b * h * n * dh * F32 * (2 if cls else 1) + small * (3 if cls else 2)
              + (2 * b * h * m * F32 if cls else 0))
    return tensor_core_bounds(2 * per * h * nv * m * dh, nbytes, (2 if cls else 1) * h * nv * m)


def k1b_bounds(mask, h, m, dh, with_s3: bool) -> dict:
    """K1b's least time: its function's products over the valid keys nv of
    each (bag, head) — S = q_l·kᵀ, dP = d_attn3v·vᵀ, d_ql, d_k, d_v
    (5·nv·m·dh FMAs) — on the tensor cores at 3×TF32, the exponentials of P
    on the special-function units, and its bytes: the valid rows of k and v
    read once, q_l, attn3v, d_attn3v, m3, s3 (and d_s3) read, d_ql, d_k and
    d_v written once."""
    b, n = mask.shape
    nv = int(mask.sum())  # summed over bags
    small = b * h * m * dh * F32
    nbytes = (2 * h * nv * dh * F32 + b * n + 3 * small + (3 if with_s3 else 2) * b * h * m * F32
              + small + 2 * b * h * n * dh * F32)
    return tensor_core_bounds(2 * 5 * h * nv * m * dh, nbytes, h * nv * m)


BACKWARD_CASES = (("student", 4, 8, 64), ("dh 128", 4, 4, 128), ("dh 256", 4, 2, 256))


def phase_k2b(gen) -> dict:
    """K2b against pass_b_backward_plain on time_nystrom's backward operands
    (the glue's, with K2's out handed over as PassB hands it) at the
    student's shape (B=4, H=8, N=1,027 ragged, dh 64, m 256), NaN at masked
    q/k/d_out/d_cls: each gradient at max|d| <= 1e-4·max|ref|, with and
    without the cls term, and two launches equal to the bit; timed without
    the cls term (the student's case: it never reads attn) beside the
    backward of ``scaled_dot_product_attention(q, k_l, mid, landmark
    mask)`` (d_q, d_kl, d_mid: K2b's function without the cls term), and
    with it; then at dh 128 (B 4, H 4) and dh 256 (B 4, H 2), the same
    products, held and timed beside SDPA's backward."""
    from mhim_mil_torch.ops import flash_nystrom as fn
    from mhim_mil_torch.utils.time_nystrom import backward_operands, k2b_call, sdpa_backward

    r = {"max_abs_err": 0.0}
    for label, b, h, dh in BACKWARD_CASES:
        o = backward_operands(gen, b, h, dh)
        lengths = o["lengths"]
        n, m = o["q"].shape[2], o["k_l"].shape[2]
        tok = o["mask"][:, None, :, None]
        q, k, d_out = (torch.where(tok, o[x], float("nan")) for x in ("q", "k", "d_out"))
        d_cls = torch.where(o["mask"][:, None], o["d_cls"], float("nan"))
        for cls in ((None, d_cls) if label == "student" else (None,)):
            args, kw = k2b_call(o, q, k, d_out, cls)
            got, again = fn.pass_b_backward(*args, **kw), fn.pass_b_backward(*args, **kw)
            torch.cuda.synchronize()
            want = fn.pass_b_backward_plain(*args)
            errs = []
            for name, g, w, g2 in zip(("d_q", "d_k", "d_kl", "d_mid", "d_ql", "d_rp", "d_m3"), got, want, again):
                if w is None:
                    continue
                errs.append(check_rel(f"K2b {name} [{label}, cls {cls is not None}]", g, w, 1e-4))
                if not torch.equal(g, g2):
                    fail(f"K2b {name} [{label}]: two launches on the same inputs differ")
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            row = r if (label, cls) == ("student", None) else r.setdefault(
                "cls" if cls is not None else label.replace(" ", ""), {})
            lib = lib_name = None
            if cls is None:
                lib, lib_grads, lib_name = sdpa_backward(o["q"], o["k_l"], o["mid"],
                                                         o["lm_mask"][:, None, None, :], o["d_out"])
                lib_err = max((lg - w).abs().max().item() / w.abs().max().item()
                              for lg, w in zip(lib_grads, (want[0], want[2], want[3])))
                row["library"] = f"scaled_dot_product_attention backward, {lib_name} backend"
            timed(row, lambda: fn.pass_b_backward(*args, **kw), lambda: fn.pass_b_backward_plain(*args), lib)
            row.update(k2b_bounds(o["mask"], h, m, dh, cls is not None))
            what = ("with the cls term" if cls is not None
                    else f"without the cls term; library: SDPA backward on the {lib_name} backend, d_q/d_kl/d_mid "
                         f"within {lib_err:.2e} of max|ref|")
            log(f"K2b [{label}, {what}] B={b} H={h} N={n} dh={dh} m={m} valid={lengths.tolist()}: gradients "
                f"max|d| {', '.join(f'{e:.3e}' for e in errs)} (tolerance max|d| <= 1e-4 max|ref|; two launches "
                f"equal to the bit); kernel {fmt_ms(row, '')}, plain {fmt_ms(row, 'plain_')}"
                + (f", library {fmt_ms(row, 'library_')}" if lib else "") + f", {fmt_bound(row)}")
        del o, q, k, d_out, d_cls, args
        torch.cuda.empty_cache()
    return {"K2b": r}


def phase_k1b(gen) -> dict:
    """K1b against pass_a_backward_plain on time_nystrom's backward operands
    at the student's shape (B=4, H=8, N=1,027 ragged, dh 64, m 256), NaN at
    masked k and v: each gradient at max|d| <= 1e-4·max|ref|, without s3's
    cotangent (the student's case: attn unused, so s3 gets none) and with
    it, two launches equal to the bit; timed beside the backward of
    ``scaled_dot_product_attention(q_l, k, v, key mask)`` (K1b's function
    without s3's term); then at dh 128 (B 4, H 4) and dh 256 (B 4, H 2),
    held and timed beside SDPA's backward."""
    from mhim_mil_torch.ops import flash_nystrom as fn
    from mhim_mil_torch.utils.time_nystrom import backward_operands, sdpa_backward

    r = {"max_abs_err": 0.0}
    for label, b, h, dh in BACKWARD_CASES:
        o = backward_operands(gen, b, h, dh)
        lengths = o["lengths"]
        n, m = o["k"].shape[2], o["q_l"].shape[2]
        tok = o["mask"][:, None, :, None]
        k, v = (torch.where(tok, o[x], float("nan")) for x in ("k", "v"))
        args = (o["q_l"], k, v, o["mask"], o["attn3v"], o["m3"], o["s3"], o["d_attn3v"])
        for s3_cot in ((None, o["d_s3"]) if label == "student" else (None,)):
            got, again = fn.pass_a_backward(*args, s3_cot), fn.pass_a_backward(*args, s3_cot)
            torch.cuda.synchronize()
            want = fn.pass_a_backward_plain(*args, s3_cot)
            errs = []
            for name, g, w, g2 in zip(("d_ql", "d_k", "d_v"), got, want, again):
                errs.append(check_rel(f"K1b {name} [{label}, d_s3 {s3_cot is not None}]", g, w, 1e-4))
                if not torch.equal(g, g2):
                    fail(f"K1b {name} [{label}]: two launches on the same inputs differ")
            r["max_abs_err"] = max(r["max_abs_err"], *errs)
            row = r if (label, s3_cot) == ("student", None) else r.setdefault(
                "s3" if s3_cot is not None else label.replace(" ", ""), {})
            lib = lib_name = None
            if s3_cot is None:
                lib, lib_grads, lib_name = sdpa_backward(o["q_l"], o["k"], o["v"], o["mask"][:, None, None, :],
                                                         o["d_attn3v"])
                lib_err = max((lg - w).abs().max().item() / w.abs().max().item() for lg, w in zip(lib_grads, want))
                row["library"] = f"scaled_dot_product_attention backward, {lib_name} backend"
            timed(row, lambda: fn.pass_a_backward(*args, s3_cot), lambda: fn.pass_a_backward_plain(*args, s3_cot),
                  lib)
            row.update(k1b_bounds(o["mask"], h, m, dh, s3_cot is not None))
            what = ("with s3's cotangent" if s3_cot is not None
                    else f"without s3's cotangent; library: SDPA backward on the {lib_name} backend, "
                         f"d_ql/d_k/d_v within {lib_err:.2e} of max|ref|")
            log(f"K1b [{label}, {what}] B={b} H={h} N={n} dh={dh} m={m} valid={lengths.tolist()}: gradients "
                f"max|d| {', '.join(f'{e:.3e}' for e in errs)} (tolerance max|d| <= 1e-4 max|ref|; two launches "
                f"equal to the bit); kernel {fmt_ms(row, '')}, plain {fmt_ms(row, 'plain_')}"
                + (f", library {fmt_ms(row, 'library_')}" if lib else "") + f", {fmt_bound(row)}")
        del o, k, v, args
        torch.cuda.empty_cache()
    return {"K1b": r}


def k5_bounds(x, a_log):
    """K5's least time: x and Δ read and y written (fp32) once per
    (cell, channel), B and C once per cell; the exponentials ā, one per
    (cell, channel, state), on the special-function units; 8 FLOPs per
    (cell, channel, state) on the fp32 pipes (Δ·a, b̄x, the two recurrences'
    FMAs, the contraction with C). Returns the bound, what sets it and the
    three times."""
    bs, h, w, ed = x.shape
    n = a_log.shape[-1]
    cells = bs * h * w
    nbytes = 2 * cells * ed * x.element_size() + cells * ed * F32 + 2 * cells * n * x.element_size()
    lanes = cells * ed * n
    t = {"bytes": nbytes / PEAK_BYTES * 1e3, "exp": lanes / PEAK_EXP * 1e3,
         "fma": 8 * lanes / PEAK_FP32_FLOPS * 1e3}
    return max(t.values()), ("bytes" if t["bytes"] >= max(t["exp"], t["fma"]) else "operations"), t


def phase_k5(gen) -> dict:
    """K5 against scan2d_plain at rtol 1e-4 atol 1e-5 (the JAX package's
    ``pallas_hw_check.py:159``) on the BLCA grid at batch 1 in fp32 and bf16,
    the serving raster grid at batch 4 in fp32 and bf16, a ragged 5 × 11 grid
    a row one column short of the BLCA layout's 8 × 48 columns (the last
    block's last run one column short) and a row of 1,000 columns in bf16
    (4-channel blocks of 192 threads); timed at the BLCA and serving grids,
    the plain version at BLCA fp32 only."""
    from mhim_mil_torch.ops import scan2d
    from mhim_mil_torch.utils.time_scan2d import operands

    r = {"max_abs_err": 0.0}
    grids = (("BLCA", 1, 275, 381, torch.float32), ("BLCA bf16", 1, 275, 381, torch.bfloat16),
             ("serving", 4, 101, 102, torch.float32), ("serving bf16", 4, 101, 102, torch.bfloat16),
             ("ragged", 1, 5, 11, torch.float32), ("segment edge", 1, 16, 383, torch.float32),
             ("1,000 columns", 1, 16, 1000, torch.bfloat16))
    for label, bs, h, w, dtype in grids:
        ops = operands(bs, h, w, dtype, gen)
        got = scan2d.selective_scan_2d_fused(*ops)
        torch.cuda.synchronize()
        want = scan2d.scan2d_plain(*ops)
        err = check_close(f"K5 [{label}]", got, want, 1e-4, 1e-5)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        bound_ms, bound_by, parts = k5_bounds(ops[0], ops[2])
        plan = scan2d.scan_plan(w, 16, ops[0].element_size())
        log(f"K5 [{label}] Bs={bs} H={h} W={w} ED=256 N=16 {str(dtype).split('.')[-1]}: max|d| {err:.3e} "
            f"(rtol 1e-4, atol 1e-5); layout G {plan.group}, S {plan.cluster}, P {plan.runs}, R {plan.run}; "
            f"bound {bound_ms:.4f} ms ({bound_by}: bytes {parts['bytes']:.4f}, exponentials "
            f"{parts['exp']:.4f}, fp32 FLOPs {parts['fma']:.4f} ms)")
        kern = lambda: scan2d.selective_scan_2d_fused(*ops)
        if label == "BLCA":
            timed(r, kern, lambda: scan2d.scan2d_plain(*ops), plain_iters=4)
            r.update(bound_ms=bound_ms, bound_by=bound_by)
            log(f"K5 [{label}]: kernel {fmt_ms(r, '')}, plain {fmt_ms(r, 'plain_')}, bound {bound_ms:.4f} ms "
                f"({bound_by}); no library call computes a 2D selective scan")
        elif label in ("BLCA bf16", "serving", "serving bf16"):
            r_s = {}
            timed(r_s, kern, None)
            key = label.replace("BLCA ", "").replace(" ", "_")
            r[key] = {"ms": r_s["ms"], "device_ms": r_s["device_ms"], "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"K5 [{label}]: kernel {fmt_ms(r_s, '')}, bound {bound_ms:.4f} ms ({bound_by})")
        del ops, got, want
        torch.cuda.empty_cache()
    # 32 states on the BLCA grid: two launches of 16 states each, one call
    ops = operands(1, 275, 381, torch.float32, gen, n=32)
    launched = scan2d.selective_scan_2d_fused.launches
    got = scan2d.selective_scan_2d_fused(*ops)
    torch.cuda.synchronize()
    if scan2d.selective_scan_2d_fused.launches != launched + 1:
        fail("K5 [BLCA N 32]: not counted as one call")
    err = check_close("K5 [BLCA N 32]", got, scan2d.scan2d_plain(*ops), 1e-4, 1e-5)
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r_32 = {}
    timed(r_32, lambda: scan2d.selective_scan_2d_fused(*ops), None)
    bound_ms, bound_by, _ = k5_bounds(ops[0], ops[2])
    log(f"K5 [BLCA N 32] Bs=1 H=275 W=381 ED=256 N=32 fp32: max|d| {err:.3e} (rtol 1e-4, atol 1e-5); "
        f"kernel {fmt_ms(r_32, '')}, bound {bound_ms:.4f} ms ({bound_by})")
    del ops, got
    torch.cuda.empty_cache()
    # rows wider than a cluster holds, on the wide kernel: h beyond the
    # register chunks in shared memory (1,500, 2,100) or in the wrapper's
    # global scratch (4,200)
    for w in (1500, 2100, 4200):
        ops = operands(1, 64, w, torch.float32, gen)
        got = scan2d.selective_scan_2d_fused(*ops)
        torch.cuda.synchronize()
        err = check_close(f"K5 [wide {w}]", got, scan2d.scan2d_plain(*ops), 1e-4, 1e-5)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r_w = {}
        timed(r_w, lambda: scan2d.selective_scan_2d_fused(*ops), None)
        bound_ms, bound_by, _ = k5_bounds(ops[0], ops[2])
        log(f"K5 [wide {w}] Bs=1 H=64 W={w} ED=256 N=16 fp32: max|d| {err:.3e} (rtol 1e-4, atol 1e-5); "
            f"kernel {fmt_ms(r_w, '')}, bound {bound_ms:.4f} ms ({bound_by})")
        del ops, got
        torch.cuda.empty_cache()
    return {"K5": r}


def phase_k6(gen) -> dict:
    """K6, the gate's probe, against probe_plain, exactly (max|d| 0), on the
    gate's ones(8, 128) and on random values; timed on ones(8, 128) beside
    ``torch.add(x, 1.0)``. Bound: the 4 KiB read and the 4 KiB written."""
    from mhim_mil_torch.ops import probe

    r = {"max_abs_err": 0.0}
    x = torch.ones(8, 128, device="cuda")
    for label, t in (("ones", x), ("random", torch.randn(8, 128, device="cuda", generator=gen))):
        got = probe.probe(t)
        torch.cuda.synchronize()
        err = (got - probe.probe_plain(t)).abs().max().item()
        if err != 0.0 or not torch.isfinite(got).all():
            fail(f"K6 [{label}]: max|d| {err} against x + 1 (tolerance 0)")
        log(f"K6 [{label}] [8, 128] fp32: max|d| {err} against probe_plain (tolerance 0)")
    nbytes, ops = 2 * x.numel() * F32, x.numel()
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    r.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    timed(r, lambda: probe.probe(x), lambda: probe.probe_plain(x), lambda: torch.add(x, 1.0))
    from mhim_mil_torch.kernels import load_library

    lib = load_library("probe")
    r["empty_launch_device_ms"] = device_ms(lambda: lib.probe_empty(torch.cuda.current_stream().cuda_stream), 20)
    log(f"K6 [ones]: kernel {fmt_ms(r, '')}, plain {fmt_ms(r, 'plain_')}, library (torch.add) "
        f"{fmt_ms(r, 'library_')}, bound {r['bound_ms']:.3e} ms ({r['bound_by']}: {nbytes} bytes); an empty "
        f"launch (csrc/probe.cu empty_kernel) takes {r['empty_launch_device_ms']} device ms")
    return {"K6": r}


# ---- phases 4-7: the main paths ---------------------------------------------------


KERNELS = ("K1", "K2", "K3", "K3b", "K3p", "K1b", "K2b", "K4", "K5", "K6")  # K3b: K3's backward


def launches() -> dict:
    from mhim_mil_torch.ops import abmil_pool, nystrom_pinv, probe, scan2d
    from mhim_mil_torch.ops import flash_nystrom as fn

    return {"K1": fn.pass_a.launches, "K2": fn.pass_b.launches, "K3": fn.flash_nystrom.forward_calls,
            "K3b": fn.flash_nystrom.backward_calls, "K3p": nystrom_pinv.pinv_product.launches,
            "K1b": fn.pass_a_backward.launches,
            "K2b": fn.pass_b_backward.launches, "K4": abmil_pool.fused_abmil_pool.launches,
            "K5": scan2d.selective_scan_2d_fused.launches, "K6": probe.probe.launches}


def reset_launches():
    from mhim_mil_torch.ops import abmil_pool, nystrom_pinv, probe, scan2d
    from mhim_mil_torch.ops import flash_nystrom as fn

    nystrom_pinv.pinv_product.launches = 0
    fn.pass_a.launches = fn.pass_b.launches = fn.pass_a_backward.launches = fn.pass_b_backward.launches = 0
    fn.flash_nystrom.forward_calls = fn.flash_nystrom.backward_calls = 0
    abmil_pool.fused_abmil_pool.launches = 0
    scan2d.selective_scan_2d_fused.launches = 0
    probe.probe.launches = 0


def expect_launches(label: str, **want) -> dict:
    """The launches since the last reset; fails unless they are ``want`` (0 elsewhere)."""
    seen = launches()
    want = {kid: want.get(kid, 0) for kid in KERNELS}
    if seen != want:
        fail(f"{label} launched {seen}, want {want}")
    return seen


def compare_models(label: str, pairs, tol: float):
    for name, got, want in pairs:
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        log(f"{label} fp32 {name} {tuple(got.shape)}: kernel vs plain max|d| {err:.3e} "
            f"(tolerance {tol} * max(1, max|ref|) = {tol * scale:.3e})")
        if not torch.isfinite(got).all() or err > tol * scale:
            fail(f"{label} fp32 {name} disagrees")


def flagship_models(gen_seed: int, **kw):
    """The kernel-path and plain-path models of ``config/mhim_c16.yaml`` at
    input_dim 1024 on the same random weights."""
    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.models import build_model

    cfg = load_config(["-c", "config/mhim_c16.yaml"], input_dim=1024, **kw)
    model_k, _ = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(gen_seed))
    model_p, _ = build_model(cfg.replace(use_flash_attn=False), device="cuda",
                             generator=torch.Generator().manual_seed(gen_seed + 1))
    model_p.load_state_dict(model_k.state_dict())
    log(f"model: MHIM-{cfg.baseline} input_dim {cfg.input_dim} inner_dim {cfg.inner_dim} heads "
        f"{cfg.n_heads}, {sum(p.numel() for p in model_k.parameters())} params, compute_dtype "
        f"{cfg.compute_dtype}")
    return cfg, model_k, model_p


def serve(label: str, cfg, model, requests, kernel_launches: dict, ref_logits=None,
          family: str = "mhim") -> dict:
    """Time the scorer's requests (bf16 policy), SERVING_REPEATS of each after
    one warm-up; fails unless each request launched ``kernel_launches``."""
    from mhim_mil_torch.utils.serving import Scorer

    scorer = Scorer(cfg, model, device="cuda", family=family)
    for _, f, mk, _ in requests:  # warm-up: library handles, allocator
        scorer.score(f, mk)
    torch.cuda.synchronize()
    reset_launches()
    rows = []
    for name, f, mk, bags in requests:
        times, out = [], None
        for _ in range(SERVING_REPEATS):
            t0 = time.perf_counter()
            out = scorer.score(f, mk)["logits"]
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        want_shape = (bags, cfg.n_classes) if f.ndim == 3 else (cfg.n_classes,)
        if out.shape != want_shape or not all(math.isfinite(x) for x in out.ravel()):
            fail(f"{label} scorer [{name}] gave {out.shape} {out}")
        rows.append({"request": f"{label} {name}", "ms": ms, "slides_per_s": bags / ms * 1e3})
        log(f"serving {label} [{name}]: {ms:.2f} ms per request (median of {SERVING_REPEATS}, host clock, "
            f"H2D of the features included), {bags / ms * 1e3:.2f} slides/s")
        if ref_logits is not None and name.startswith("batch 4"):
            err = abs(out - ref_logits.cpu().numpy()).max()
            log(f"serving {label} bf16 vs fp32 kernel-path logits: max|d| {err:.3e} (tolerance 0.1)")
            if err > 0.1:
                fail(f"{label}: bf16 serving logits drift from the fp32 logits")
    n_req = SERVING_REPEATS * len(requests)
    return {"launches": expect_launches(f"{label} scorer", **{k: v * n_req for k, v in kernel_launches.items()}),
            "serving": rows}


def flagship_batch(gen, input_dim: int):
    b, n = 4, 10240
    feats = torch.randn(b, n, input_dim, device="cuda", generator=gen)
    lengths = torch.tensor([10240, 10240, 8000, 6000], device="cuda")
    return feats, torch.arange(n, device="cuda")[None] < lengths[:, None]


def phase_serving(gen) -> dict:
    """Phase 4: MHIM-selfattn, the kernel path against the plain path in
    fp32 (forward_test + the eval teacher), then the scorer under bf16."""
    cfg, model_k, model_p = flagship_models(0)
    feats, mask = flagship_batch(gen, cfg.input_dim)
    reset_launches()
    logits_k = model_k.forward_test(feats, mask)["logits"]
    cls_k, score_k = model_k.forward_teacher(feats, mask)
    torch.cuda.synchronize()
    counted = expect_launches("forward_test + forward_teacher", K1=4, K2=4, K3p=4 * 24)
    reset_launches()
    logits_p = model_p.forward_test(feats, mask)["logits"]
    cls_p, score_p = model_p.forward_teacher(feats, mask)
    torch.cuda.synchronize()
    expect_launches("the plain path")
    # fp32 both ways; sums in another order over 10,241 tokens, through the pinv
    compare_models("serving", (("logits", logits_k, logits_p), ("cls_feat", cls_k, cls_p),
                               ("score", score_k, score_p)), 1e-3)
    ragged = torch.randn(6000, cfg.input_dim, device="cuda", generator=gen)
    requests = [
        ("batch 4 x 10240", feats.cpu().numpy(), mask.cpu().numpy(), 4),
        ("batch 1 x 10240", feats[:1].cpu().numpy(), None, 1),
        ("ragged 6000 (bucket 10240)", ragged.cpu().numpy(), None, 1),
    ]
    sv = serve("selfattn", cfg, model_k, requests, {"K1": 2, "K2": 2, "K3p": 2 * 24}, logits_k)
    return {"launches": [counted, sv["launches"]], "serving": sv["serving"]}


TRAIN_STEPS = 10  # timed bf16 steps, after 2 warm-up steps


def phase_train(gen) -> dict:
    """Phase 5: the flagship train step. One fp32 step on the kernel path
    against the plain path from the same weights, batch and generator seed
    (so the same dropout, mining and merge draws), then bf16 steps."""
    from mhim_mil_torch.engine.steps import make_mhim_train_step
    from mhim_mil_torch.engine.train_state import create_mhim_state

    cfg, model_k, model_p = flagship_models(2, compute_dtype="float32")
    feats, mask = flagship_batch(gen, cfg.input_dim)
    b = feats.shape[0]
    batch = {"feats": feats, "mask": mask, "bag_valid": torch.ones(b, dtype=torch.bool, device="cuda"),
             "target": torch.randint(0, cfg.n_classes, (b,), device="cuda", generator=gen)}
    spe = 8
    state_k = create_mhim_state(cfg, model_k, spe, seed=0, device="cuda")
    state_p = create_mhim_state(cfg, model_p, spe, seed=0, device="cuda")
    lr = float(state_k.optimizer.lr_schedule(0))
    reset_launches()
    m_k = make_mhim_train_step(cfg, spe, device="cuda")(state_k, batch)
    torch.cuda.synchronize()
    counted = expect_launches("one fp32 train step", K1=4, K2=4, K3=2, K3b=2, K3p=4 * 24 + 2 * 48, K1b=2, K2b=2)
    reset_launches()
    m_p = make_mhim_train_step(cfg.replace(use_flash_attn=False), spe, device="cuda")(state_p, batch)
    torch.cuda.synchronize()
    expect_launches("the plain-path train step")
    log("train fp32 metrics, kernel path: " + ", ".join(f"{k} {float(v):.6g}" for k, v in m_k.items()))
    log("train fp32 metrics, plain path:  " + ", ".join(f"{k} {float(v):.6g}" for k, v in m_p.items()))
    for key in ("keep_num", "patch_num"):
        if float(m_k[key]) != float(m_p[key]):
            fail(f"train: {key} differs between the paths: the mining took other instances")
    d_loss = abs(float(m_k["loss"]) - float(m_p["loss"]))
    log(f"train fp32 loss: kernel vs plain |d| {d_loss:.3e} (tolerance 1e-4 * |loss|)")
    if not math.isfinite(float(m_k["loss"])) or d_loss > 1e-4 * abs(float(m_p["loss"])):
        fail("train: the loss disagrees")
    # The gradients are the kernels' real test; Adam's first step moves each
    # parameter by about lr·sign(g), so a gradient entry near zero may move
    # the two paths' parameters apart by up to 2·lr, and the teacher by
    # (1 − mm) times that.
    g_err = max(((pk.grad - pp.grad).abs().max() / pp.grad.abs().max().clamp_min(1e-30)).item()
                for pk, pp in zip(model_k.parameters(), model_p.parameters()))
    p_err = max((pk - pp).abs().max().item() for pk, pp in zip(model_k.parameters(), model_p.parameters()))
    t_err = max((tk - tp).abs().max().item()
                for tk, tp in zip(state_k.teacher.parameters(), state_p.teacher.parameters()))
    q_err = (model_k.merge.global_q_mm - model_p.merge.global_q_mm).abs().max().item()
    log(f"train fp32 kernel vs plain: gradients max|d|/max|ref| {g_err:.3e} (tolerance 1e-3), params max|d| "
        f"{p_err:.3e} (tolerance 2·lr = {2 * lr:.3e}), teacher max|d| {t_err:.3e} (tolerance "
        f"{2 * lr * (1 - cfg.mm) + 1e-7:.3e}), global_q max|d| {q_err:.3e} (tolerance 1e-6)")
    if g_err > 1e-3 or p_err > 2 * lr or t_err > 2 * lr * (1 - cfg.mm) + 1e-7 or q_err > 1e-6:
        fail("train: the kernel path's update disagrees with the plain path's")

    cfg16 = cfg.replace(compute_dtype="bfloat16")
    step16 = make_mhim_train_step(cfg16, spe, device="cuda")
    before = [p.detach().clone() for p in model_k.parameters()]
    reset_launches()
    for _ in range(2):
        step16(state_k, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step16(state_k, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    n = TRAIN_STEPS + 2
    counted_16 = expect_launches("the bf16 train steps", K1=4 * n, K2=4 * n, K3=2 * n, K3b=2 * n,
                                 K3p=(4 * 24 + 2 * 48) * n, K1b=2 * n, K2b=2 * n)
    moved = sum(not torch.equal(p, q) for p, q in zip(model_k.parameters(), before))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(times)
    log(f"train bf16: {TRAIN_STEPS} steps, losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"{moved}/{len(before)} parameter tensors moved; {ms:.2f} ms per step (median, host clock, "
        f"synchronised; min {min(times):.2f}, max {max(times):.2f}), {b / ms * 1e3:.1f} bags/s; "
        f"peak memory {peak_gb:.2f} GiB")
    if not all(math.isfinite(x) for x in losses) or moved != len(before):
        fail("train bf16: a loss is not finite or a parameter did not move")
    return {"launches": [counted, counted_16],
            "train": {"ms_per_step": ms, "bags_per_s": b / ms * 1e3, "peak_gib": peak_gb}}


def phase_attn(gen) -> dict:
    """Phase 6: MHIM-attn, the kernel path (K4) against the plain path in
    fp32, then the scorer under bf16: K4 once per request."""
    cfg, model_k, model_p = flagship_models(4, baseline="attn")
    feats, mask = flagship_batch(gen, cfg.input_dim)
    reset_launches()
    logits_k = model_k.forward_test(feats, mask)["logits"]
    cls_k, score_k = model_k.forward_teacher(feats, mask)
    torch.cuda.synchronize()
    counted = expect_launches("MHIM-attn forward_test + forward_teacher", K4=2)
    reset_launches()
    logits_p = model_p.forward_test(feats, mask)["logits"]
    cls_p, score_p = model_p.forward_teacher(feats, mask)
    torch.cuda.synchronize()
    expect_launches("the MHIM-attn plain path")
    compare_models("attn", (("logits", logits_k, logits_p), ("cls_feat", cls_k, cls_p),
                            ("score", score_k, score_p)), 1e-4)
    requests = [
        ("batch 4 x 10240", feats.cpu().numpy(), mask.cpu().numpy(), 4),
        ("batch 1 x 10240", feats[:1].cpu().numpy(), None, 1),
    ]
    sv = serve("attn", cfg, model_k, requests, {"K4": 1}, logits_k)
    return {"launches": [counted, sv["launches"]], "serving": sv["serving"]}


def phase_mamba(gen) -> dict:
    """Phase 7: ``2dmamba`` on ``feat_surv.yaml`` + ``surv_blca``. The eval
    step with ``pos`` on one bag of 20,000 instances at distinct random
    cells of the 275 × 381 grid, padded with 480 masked slots: the kernel
    path against the plain path in fp32 (one K5 launch per call), bf16
    against fp32; then the scorer (raster grid 101 × 102) under bf16."""
    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.engine.steps import make_eval_step
    from mhim_mil_torch.models import build_model

    cfg = load_config(["-c", "config/feat_surv.yaml"], model="2dmamba", datasets="surv_blca", input_dim=1024)
    model_k, family = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(6))
    model_p, _ = build_model(cfg.replace(use_flash_attn=False), device="cuda",
                             generator=torch.Generator().manual_seed(7))
    model_p.load_state_dict(model_k.state_dict())
    h, w = cfg.mamba_2d_max_h, cfg.mamba_2d_max_w
    log(f"model: 2dmamba input_dim {cfg.input_dim} dim {cfg.mambamil_dim} layers {cfg.mambamil_layer} "
        f"d_state {cfg.mambamil_state_dim}, {cfg.n_classes} classes ({cfg.loss}), grid {h} x {w}, "
        f"{sum(p.numel() for p in model_k.parameters())} params, compute_dtype {cfg.compute_dtype}")

    n_inst, n_slots = 20000, 20480
    cells = torch.randperm(h * w, device="cuda", generator=gen)[:n_inst]
    pos = torch.zeros(1, n_slots, 2, dtype=torch.long, device="cuda")
    pos[0, :n_inst, 0], pos[0, :n_inst, 1] = cells % w, cells // w
    batch = {"feats": torch.randn(1, n_slots, cfg.input_dim, device="cuda", generator=gen),
             "mask": torch.arange(n_slots, device="cuda")[None] < n_inst, "pos": pos}
    cfg32 = cfg.replace(compute_dtype="float32")
    step_k = make_eval_step(cfg32, model_k, family)
    reset_launches()
    logits_k = step_k(batch)["logits"]
    torch.cuda.synchronize()
    counted = [expect_launches("2dmamba eval step", K5=1)]
    reset_launches()
    logits_p = make_eval_step(cfg32, model_p, family)(batch)["logits"]
    torch.cuda.synchronize()
    expect_launches("the 2dmamba plain path")
    compare_models("2dmamba eval", (("logits", logits_k, logits_p),), 1e-4)
    step16 = make_eval_step(cfg, model_k, family)
    reset_launches()
    logits_16 = step16(batch)["logits"]
    torch.cuda.synchronize()
    counted.append(expect_launches("2dmamba bf16 eval step", K5=1))
    err = (logits_16 - logits_k).abs().max().item()
    log(f"2dmamba eval bf16 vs fp32 kernel-path logits {tuple(logits_16.shape)}: max|d| {err:.3e} (tolerance 0.1)")
    if not torch.isfinite(logits_16).all() or err > 0.1:
        fail("2dmamba: bf16 eval logits drift from the fp32 logits")
    times = []
    for _ in range(SERVING_REPEATS):
        t0 = time.perf_counter()
        step16(batch)["logits"].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    eval_ms = statistics.median(times)
    log(f"2dmamba eval bf16, one bag of {n_inst} on the {h} x {w} grid: {eval_ms:.2f} ms per call (median of "
        f"{SERVING_REPEATS}, host clock, features already on the card)")

    feats, mask = flagship_batch(gen, cfg.input_dim)
    ref = make_eval_step(cfg32, model_k, family)({"feats": feats, "mask": mask})["logits"]
    ragged = torch.randn(6000, cfg.input_dim, device="cuda", generator=gen)
    requests = [
        ("batch 4 x 10240", feats.cpu().numpy(), mask.cpu().numpy(), 4),
        ("batch 1 x 10240", feats[:1].cpu().numpy(), None, 1),
        ("ragged 6000 (bucket 10240)", ragged.cpu().numpy(), None, 1),
    ]
    sv = serve("2dmamba", cfg, model_k, requests, {"K5": 1}, ref, family=family)
    return {"launches": counted + [sv["launches"]], "serving": sv["serving"], "eval_ms": eval_ms}


DRIVER_ARGS = ["-c", "config/mhim_c16.yaml", "--datasets", "synth", "--input_dim", "1024", "--synth_bag_size",
               "10240", "--bucket_sizes", "10240", "--batch_size", "4", "--synth_n_slides", "24", "--cv_fold", "2",
               "--num_epoch", "2", "--max_epoch", "2", "--num_bootstrap", "50"]
MAMBA_ARGS = ["-c", "config/feat_surv.yaml", "--model", "2dmamba", "--datasets", "surv_synth", "--input_dim", "1024",
              "--synth_bag_size", "10240", "--bucket_sizes", "10240", "--batch_size", "4", "--cv_fold", "1",
              "--num_epoch", "1", "--use_flash_attn", "true"]


def drive(label: str, argv) -> tuple:
    """One run of the port's command line from zero launch counts: its
    results, its launches and its host seconds."""
    from mhim_mil_torch.main import main as cli

    log(f"driver [{label}]: python3 -m mhim_mil_torch.main {' '.join(argv)}")
    reset_launches()
    t0 = time.perf_counter()
    res = cli(argv)
    torch.cuda.synchronize()
    return res, launches(), time.perf_counter() - t0


def log_folds(label: str, res: dict):
    for f in res["folds"]:
        t = f["timing"]
        rate = t["train_steps"] / t["train_seconds"] if t["train_seconds"] else float("nan")
        log(f"driver [{label}] fold {f['fold']}: {t['seconds']:.2f} s wall, {t['train_steps']} train steps in "
            f"{t['train_seconds']:.2f} s ({rate:.2f} steps/s, host clock, meters read once an epoch), "
            f"eval {t['eval_seconds']:.2f} s; best epoch {f['best_epoch']}, test "
            + ", ".join(f"{k} {v:.4f}" for k, v in f["test"].items() if isinstance(v, float)))


def finite_rows(label: str, res: dict, rows, key: str):
    for f in res["folds"]:
        for row in rows:
            vals = [f.get(row, {}).get(k, float("nan")) for k in ((key, "acc") if key == "auc" else (key,))]
            if not all(math.isfinite(v) for v in vals):
                fail(f"driver [{label}] fold {f['fold']}: no finite {row} row: {f.get(row)}")


def phase_driver() -> dict:
    """Phase 8: the k-fold driver through its command line, the kernel gate
    on auto in the first run; then the reload of the bests; then 2dmamba
    survival with the kernels named explicitly (one gate per script)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_driver_") as tmp:
        out = os.path.join(tmp, "mhim")
        torch.cuda.reset_peak_memory_stats()
        res, seen, secs = drive("flagship", DRIVER_ARGS + ["--output_path", out])
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        gate = res["kernel_gate"]
        log(f"driver [flagship] kernel gate: {gate['outcome']} in {gate['seconds']:.2f} s, K6 launched "
            f"{gate['probe_launches']} time(s) in its probe; {gate['detail']}")
        if gate["outcome"] != "enabled" or gate["probe_launches"] < 1:
            fail(f"driver: the kernel gate gave {gate}")
        log_folds("flagship", res)
        log(f"driver [flagship] launches {seen}; {secs:.2f} s in all (host clock, data made, gate and "
            f"checkpoints included); peak device memory {peak_gb:.2f} GiB")
        for kid in ("K1", "K2", "K3", "K3b", "K3p", "K1b", "K2b"):
            if seen[kid] < 1:
                fail(f"driver [flagship]: {kid} was not launched")
        finite_rows("flagship", res, ("test", "test_ema"), "auc")
        if not (res.get("summary") and res.get("summary_ema")):
            fail("driver [flagship]: no summary or summary_ema")
        for k in range(2):
            for name in (f"fold_{k}_model_best.ckpt", f"fold_{k}_ema_model_best.ckpt"):
                if not os.path.exists(os.path.join(out, name)):
                    fail(f"driver [flagship]: {name} was not written")

        res2, seen2, secs2 = drive("reload", DRIVER_ARGS + ["--use_flash_attn", "true", "--script_mode", "test",
                                                         "--model_path", out, "--output_path", ""])
        for f1, f2 in zip(res["folds"], res2["folds"]):
            d = max(abs(f1["test"][k] - f2["test"][k]) for k in ("auc", "acc"))
            log(f"driver [reload] fold {f1['fold']}: test auc {f2['test']['auc']:.6f}, acc {f2['test']['acc']:.6f}; "
                f"max|d| {d:.3e} against the training run's (tolerance 1e-6)")
            if not d <= 1e-6:
                fail("driver [reload]: the reloaded best does not reproduce the test row")
        log(f"driver [reload] launches {seen2}; {secs2:.2f} s")

        res3, seen3, secs3 = drive("2dmamba", MAMBA_ARGS + ["--output_path", os.path.join(tmp, "mamba")])
        log_folds("2dmamba", res3)
        finite_rows("2dmamba", res3, ("test",), "cindex")
        if seen3["K5"] < 1:
            fail("driver [2dmamba]: K5 was not launched")
        log(f"driver [2dmamba] launches {seen3}; {secs3:.2f} s; c-index {res3['summary']['cindex']['mean']:.4f}")
        probes = {"K6": gate["probe_launches"] + res3["kernel_gate"]["probe_launches"]}
    return {"launches": [seen, seen2, seen3, probes], "seconds": secs + secs2 + secs3}


def main():
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = phase_nystrom_kernels(gen)
    report.update(phase_k4(gen))
    report.update(phase_k3(gen))
    report.update(phase_k3p(gen))
    report.update(phase_k2b(gen))
    report.update(phase_k1b(gen))
    report.update(phase_k5(gen))
    report.update(phase_k6(gen))
    counted = {kid: 0 for kid in KERNELS}
    for phase in (phase_serving, phase_train, phase_attn, phase_mamba, lambda g: phase_driver()):
        for seen in phase(gen)["launches"]:
            for kid, n in seen.items():
                counted[kid] += n
    log(f"launches on the main paths: {counted}")
    meta = {
        "K1": ("flash_nystrom_pass_a (pass_a_partial_kernel over key splits + pass_a_merge_kernel)",
               "mhim_mil_torch/csrc/flash_nystrom.cu", "mhim_mil_tpu/ops/pallas_nystrom.py:45"),
        "K2": ("flash_nystrom_pass_b (pass_b_kernel)", "mhim_mil_torch/csrc/flash_nystrom.cu",
               "mhim_mil_tpu/ops/pallas_nystrom.py:85"),
        "K3": ("flash_nystrom (PassA, PassB: K1 + K2 forward; K2b, the glue's autograd and K1b backward; the "
               "pseudo-inverse on K3p)", "mhim_mil_torch/ops/flash_nystrom.py", "mhim_mil_tpu/ops/pallas_nystrom.py:249"),
        "K3p": ("nystrom_pinv_product (pinv_product_kernel), the Newton-Schulz pseudo-inverse of K3's glue, "
                "forward and backward", "mhim_mil_torch/csrc/nystrom_pinv.cu", "mhim_mil_tpu/ops/nystrom.py:33"),
        "K2b": ("flash_nystrom_pass_b_bwd (token_kernel + landmark_kernel), K3's backward of K2's pass",
                "mhim_mil_torch/csrc/flash_nystrom_bwd.cu", "mhim_mil_tpu/ops/pallas_nystrom.py:280"),
        "K1b": ("flash_nystrom_pass_a_bwd (k1b_kernel: landmark and key blocks in one grid), K3's backward of "
                "K1's pass", "mhim_mil_torch/csrc/flash_nystrom_k1b.cu", "mhim_mil_tpu/ops/pallas_nystrom.py:280"),
        "K4": ("abmil_pool", "mhim_mil_torch/csrc/abmil_pool.cu", "mhim_mil_tpu/ops/pallas_abmil.py:42"),
        "K5": ("scan2d (scan2d_cluster_kernel; scan2d_wide_kernel above 1,152 columns)",
               "mhim_mil_torch/csrc/scan2d.cu", "mhim_mil_tpu/ops/pallas_scan2d.py:56"),
        "K6": ("probe", "mhim_mil_torch/csrc/probe.cu", "mhim_mil_tpu/utils/pallas_gate.py:37"),
    }
    kernels = []
    for kid, (name, source, replaces) in meta.items():
        r = report[kid]
        if counted[kid] < 1 or (kid == "K3" and counted["K3b"] < 1):
            fail(f"{kid} was not launched on the main paths")
        row = {
            "name": name, "id": kid, "status": "ported", "route": "cuda", "source": source,
            "replaces": replaces, "launches": counted[kid], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"], "library_device_ms": r["library_device_ms"],
        }
        for key in ("bound_parts_ms", "batch1", "dh128", "dh256", "dh192", "no_attn", "cls", "s3", "library", "bf16",
                    "serving", "serving_bf16", "backward", "product", "vjp_max_abs_err", "cuda_records_in_5_calls",
                    "empty_launch_device_ms"):
            if key in r:
                row[key] = r[key]
        if kid == "K3":
            row["backward_calls"] = counted["K3b"]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
