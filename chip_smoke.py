"""Smoke run of the PyTorch port on one Hopper card: ``python3 chip_smoke.py``.

Drives the port's paths at the flagship width (``config/mhim_c16.yaml``,
input_dim 1024, inner_dim 512, 8 heads, 256 landmarks, 2 TransLayers) on
bags of 10,240 instances at batch 4, with random weights from a seeded
``torch.Generator``: the MHIM-selfattn serving path (``forward_test``
through the ``Scorer``, the eval-mode ``forward_teacher``), the MHIM train
step, and the MHIM-attn serving path; then the 2D-Mamba survival model of
the README (``config/feat_surv.yaml``, ``--model 2dmamba``, ``surv_blca``:
input 1024, width 128, one layer, 16 states, the 275 × 381 BLCA grid) on
its eval step and its scorer; then the zoo (abmil, gabmil, transmil, dsmil
and MHIM-dsmil), zoo II (clam_sb, clam_mb, dtfd, ibmil, rrtmil), mambamil,
the streamed Nystrom path and the attention-heatmap export; then the
flagship and K3 at the 16,384 and 32,768 buckets; then the train step's
diagnostic variants and the in-step breakdown and HBM tools; then the
serving export bundle; then feature extraction, from a synthetic slide to
the flagship's score; then the slide readers, from the slide's files to its
attention; then data parallelism over bags; then sequence parallelism over
instances; then data parallelism over bags for the rest of the zoo; then
sequence parallelism for the scan families; then sequence parallelism for
the rest of the zoo.
Phases, each of which fails the run:

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
   launches alone (the profiler's record); K3 again at the teacher stage's
   length, B 4, H 8, N 10,241, full and ragged bags (out and attn against
   the fp32 plain path, everything against fp64 by the VJP criterion,
   timed with each kernel's device ms); K3p, the Newton–Schulz
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
   in fp32 from the same weights and draws, both paths' mining held to the
   plain teacher's scores (the kernel teacher's own within 1e-4·max|ref|
   of them: a 1-ulp difference moves instances whose scores tie across the
   mining's cut, ROADMAP fault 14), again with ties planted across the
   high-mining cut (which must pass) and with the kernel path's mining on
   the scores reflected (a control, which must fail), then steps under
   bf16; then the same for the teacher stage's step (``--model
   mhim_pure``: K3 over the whole bag, no teacher forward), whose teacher
   must not move;
6. attn: MHIM-attn ``forward_test`` on the kernel path against the plain
   path in fp32, then the scorer's requests under bf16;
7. 2dmamba: the eval step on one 20,000-instance bag on the BLCA grid, the
   kernel path (K5) against the plain path in fp32 and bf16 against fp32,
   then the scorer's requests on the raster grid under bf16;
8. driver: ``mhim_mil_torch.main.main`` on synthetic bags of 5,120-10,240
   instances in the 10,240 bucket: one fold of abmil
   (``config/feat_cls.yaml``) with ``use_flash_attn`` on auto, so the
   kernel gate builds and launches K6 in its probe and runs the kernel
   check, and K4 pools its evaluations; then the two-stage workflow, two
   folds of two epochs each: the teacher stage (``--model mhim_pure``),
   then the flagship with ``--teacher_init`` from the teacher stage's
   directory (each fold's teacher its stage-1 best, bit for bit), its
   student and EMA bests final-tested; the ``script_mode test`` reload of
   those bests; then one fold of the 2dmamba survival model, training on
   the plain scan and evaluating through K5; then one fold of clam_sb
   (``config/feat_cls.yaml``, two epochs), its instance loss nonzero;
9. zoo: ``config/feat_cls.yaml`` (act gelu) at input 1024, inner 512, 8
   heads of 64, 256 landmarks, on the ragged 4 × 10,240 batch: abmil and
   gabmil, the eval step through K4 against the plain pool in fp32, then
   the scorer under bf16, and abmil's bf16 train steps; transmil, the eval
   step (K1 + K2) against the plain path in fp32, one fp32 train step on
   K3 forward and backward against the plain path, then bf16 steps with
   the device's busy time; dsmil and MHIM-dsmil, bf16 eval against fp32;
10. zoo II, at the same width on the same batch, none of which runs a
   kernel: clam_sb, clam_mb, dtfd, ibmil (a bank of 8 prototypes drawn by
   the port's kmeans from its own bag features) and rrtmil (1 R-MSA + 1
   CR-MSA, 8 heads, region_num 8, epeg_k 15, crmsa_k 3): the fp32 eval
   step on the card against the CPU, CLAM's instance loss on the card
   against the CPU (dropout off) and its top-k on planted ties, bf16 eval
   against fp32, bf16 train steps with the device's busy time;
11. the last modules, none of which adds a kernel: (a) mambamil
   (``config/feat_cls.yaml`` + ``--model mambamil``: width 128, one layer,
   16 states, ``sr_rate`` 10) as simple, srmamba and bimamba on the same
   batch: the fp32 eval step on the card against the CPU, bf16 against
   fp32, three checked bf16 train steps each, and for bimamba twelve timed
   ones with busy time and peak memory (below 14 full scan lattices), no
   kernel launched; (b) the streamed Nystrom
   path at B 4, H 8, N 10,241 against the kernel path, with the peak
   memory of the three paths, and the teacher-stage step on
   ``use_flash_attn=False`` (streamed) against the materialising path;
   (c) the attention-heatmap export CLI on a synthetic ``.pt`` store,
   MHIM selfattn through K1, K2 and K3p and abmil through K4, each grid
   against the plain path's. Phase 8 adds one bimamba fold;
12. stress, the 16,384 and 32,768 buckets (``tools/stress_30k.py``'s
   config, ``bench.py``'s flagship at batch 2): the batch-1
   ``forward_test`` on a full bag of 32,768 (K1 and K2 over 32,769 tokens),
   kernel path against plain path in fp32; one fp32 flagship train step on
   ``stress_30k``'s ragged 2 × 32,768 batch, kernel path against plain path
   at phase 5's tolerances, then 3 bf16 steps with their peak memory; K3
   alone at B 2, H 8, N 32,769, full and ragged, and N 16,385, as at
   10,241 in phase 3 (out and attn against the fp32 plain path, everything
   against fp64 by the VJP criterion, each kernel's device ms and bound:
   the kernels line's ``stress``);
13. the MHIM train step's ``ablate`` variants and the step tools: (a) the
   flagship step and its ``no_teacher``, ``fwd_only``, ``no_opt_ema`` and
   ``no_ema`` variants, one fp32 step each on phase 5's ragged batch, the
   kernel path against the plain path at phase 5's tolerances, with each
   variant's launches (``no_teacher``: no teacher K1 or K2; ``fwd_only``:
   the inference path, no K3 call and no backward) and its invariants
   (``fwd_only`` and ``no_opt_ema`` move no parameter, teacher or Adam
   moment, ``fwd_only`` moves global_q, ``no_opt_ema``'s gradient norm
   within 1e-3 of the plain path's, ``no_ema`` updates as the full step
   does and keeps the teacher); (b) ``tools/roofline.py``'s streaming
   probes over 1 GiB (each at most 1.05 × the data sheet's 3.35 TB/s) and
   ``tools/step_breakdown.py`` on ``tools/bench.py``'s bf16 flagship: the
   host-clock components, each variant's device-busy ms (at most 1.05 × the
   host ms of the same steps), the device ms of each stage and the bytes
   floor at the measured rate;
14. the serving export bundle: each kernel's ``torch.ops.mhim_mil_torch``
   op refuses an operand on the CPU; the flagship exported for ``cuda`` at
   buckets 1,024, 4,096 and 10,240, abmil (K4) and 2dmamba (K5) at 10,240,
   each in fp32 and bf16 (each program's export seconds and MB); a fresh
   process loads every bundle with ``mhim_mil_torch.utils.serving`` alone
   (neither ``jax`` nor ``mhim_mil_torch.models`` imported; each program's
   load seconds) and scores 4 × 10,240 ragged, 1 × 3,000, 1 × 900 and a
   batch of 3 (the flagship) or 4 × 10,240 and 1 × 6,000; each request's
   logits against the live ``Scorer``'s on the same model (fp32 within
   1e-4, bf16 within 1e-2, × max(1, max|ref|)) and its launches equal to
   the Scorer's and nonzero (K1 2, K2 2, K3p 48; K4 1; K5 1); the bf16
   flagship's 1 × 10,240 p50 through the bundle and the Scorer, in turns;
15. feature extraction, after phase 8: (a) the seven patch encoders at
   their published geometries (``resnet50_trunc``, ``r18``, ``uni_v1``
   ViT-L/16, ``gigap`` ViT-giant/16, ``conch_v1`` CLIP ViT-B/16, ``chief``
   Swin-T, ``sd_vae``), random weights from a seed written as an
   upstream-named ``state_dict`` and loaded through ``get_encoder`` on the
   card and on the CPU, 8 patches each at 224 px (``uni_v1`` also at 256):
   card against CPU within 1e-4 × max(1, max|ref|) with TF32 off, the
   deviation with PyTorch's TF32 defaults printed beside it; (b) each
   encoder's patches a second alone on the card, both ways, with its GFLOPs
   a patch and peak memory; (c) the slice end to end: a synthetic 6,144 ×
   6,144 slide, ``segment_tissue`` on its thumbnail, ``generate_patch_coords``
   at 256/256 (at least 400 patches), ``extract_features`` with
   ``resnet50_trunc`` on the card, ``save_feature_store`` (pt only),
   ``FeatureBagStore`` (bit for bit), the flagship ``Scorer`` in bf16 in
   the 10,240 bucket (K1 2, K2 2, K3p 48; finite logits within 0.1 of fp32);
16. the slide readers, on 15c's slide and encoder: (a) the port's writer
   writes the slide as a 3-level pyramid of 256-px tiles in deflate, raw and
   BigTIFF raw, and a 1,024² crop in LZW; ``open_slide`` opens each
   with the native LZW/PackBits codec built into ``build/native/`` and
   loaded; each level's dimensions and downsample, and 64 seeded level-0
   reads of 256² equal to the raster bit for bit, with host ms a read and
   the thumbnail's seconds; (b) the CLI's steps on the deflate file
   (thumbnail, segmentation, patch grid) and ``extract_features`` from the
   file on the card, equal bit for bit to the in-memory sweep of the same
   coordinates, then ``tools.extract_features.main`` on the file, its ``pt``
   equal to those features; (c) ``tools.export_attention`` with the
   flagship on that store, kernel path against plain path
   (``compare_attention`` 1e-4; K1 2, K2 2, K3p 48), the grid the scores'
   percentile raster. Where PIL is there: a 2,048² crop as ``.svs``,
   ``.ndpi``, ``.mrxs``, ``.vms``, Philips TIFF, ``.scn`` and ``.bif``
   through ``open_slide``, every level at least 30 dB PSNR against the
   raster's box pyramid. Where h5py, matplotlib and PIL are all there: the
   overlays of ``--image_dir`` at level 1 against
   ``render_heatmap_pyramidal`` and the ROI CSV. A line names the parts
   that ran and the package each part left out lacks;
17. data parallelism over bags (``mhim_mil_torch/parallel``): (a) phase
   8's abmil run with ``--mesh_dp 4 --mesh_sp 2`` (and the kernels named
   on, as phase 8's gate turned them on) in this one process trains and
   equals phase 8's run bit for bit; (b) an NCCL world of one
   process: one fp32 flagship step (4 × 10,240, dropout on) under
   ``make_mesh(dp=1)`` equals the step without a mesh bit for bit (loss,
   metrics, every parameter, gradient and teacher tensor, global_q_mm) with
   the same launches; (c) two processes of this script sharing the card in
   a gloo world, 2 of the 4 bags each: the fp32 step against (b)'s
   (loss rtol 2e-5, keep_num and patch_num equal, gradients within 1e-4
   of max|g|, student, teacher and global_q_mm within 2·lr), the flagship's
   ``forward_test`` logits gathered within 1e-4·max|ref|, 3 bf16 steps
   with finite losses, each rank's launches and step ms (two processes on
   one card: not a scaling figure) and the gradient all-reduce's bytes;
18. sequence parallelism over instances: two processes of this script
   sharing the card in a gloo world, ``make_mesh(dp=1, sp=2)``, each
   holding one block of every bag's instances: (a) the fp32 flagship step
   on 17b's 4 × 10,240 × 1024 batch against 17b's one-process kernel step
   at 17c's tolerances and ``forward_test``'s logits, every K1, K2, K1b
   and K2b call seeing at most ⌈10,241/2⌉ tokens and each rank launching
   what one process launches (K3p 192), each rank's step ms and the sp
   collectives' bytes a step; (b) MHIM-attn's ``forward_test`` and abmil's
   eval step and attention, K4 on each rank's block and the blocks merged
   by their log-sum-exp, within 1e-4·max|ref| of one process;
19. data parallelism over bags for the rest of the zoo: two processes of
   this script sharing the card in a gloo world, ``make_mesh(dp=2)``, 2 of
   the 4 bags each: one fp32 train step at full width (dropout on) of
   clam_sb, clam_mb, dsmil, dtfd, ibmil (its bank overwritten on rank 1
   before the state is broadcast), rrtmil, mambamil's three variants,
   MHIM-dsmil and its teacher stage, against the one-process step on the
   ragged 4 × 10,240 batch at 17c's tolerances; 2dmamba (``surv_blca``) on
   2 bags of 20,000 instances, one a rank: its train step on their raster
   grid (the plain scan's autograd on the 275 × 381 grid would hold about
   67 GB a bag), then its eval step with ``pos`` on the BLCA grid through
   K5 on each rank's bag, the gathered logits within 1e-4·max|ref| of one
   process's K5 path and each rank's K5 output within 1e-4·max(1,
   max|ref|) of the plain scan; each rank's step ms;
20. sequence parallelism for the scan families: two processes of this
   script sharing the card in a gloo world, ``make_mesh(dp=1, sp=2)``: (a)
   2dmamba's eval step on phase 19's two BLCA bags, each rank a band of
   whole grid rows (138 and 137) through K5, the state entering the second
   band carried from the first (one K5 launch on rank 0, two on rank 1),
   the gathered logits within 1e-4·max|ref| of phase 19's one-process K5
   path, each K5 call within 1e-4·max(1, max|ref|) of the plain scan from
   the same state, and the bands scanned without the carry outside that
   tolerance; (b) 2dmamba's fp32 train step on the raster grid and (c)
   mambamil's three variants' on the ragged zoo batch, against phase 19's
   one-process steps at 17c's tolerances, with each rank's step ms and
   peak memory beside one process's;
21. sequence parallelism for the rest of the zoo: two processes of this
   script sharing the card in a gloo world, ``make_mesh(dp=1, sp=2)``, on
   phase 19's ragged 4 × 10,240 batch at full width (dropout on): one fp32
   train step and the evaluation step of transmil (PPEG), gabmil, meanmil,
   maxmil, ibmil, clam_sb, clam_mb, dsmil, MHIM-dsmil, MHIM with PEG, dtfd
   (AFS and MaxMinS), rrtmil and transmil on the ``parity`` Nystrom path,
   against the one-process step at 17c's tolerances and a loss within
   1e-6 (MHIM's mining held to the one-process teacher's scores, the
   ranks' own within 1e-4·max|ref|) and the one-process evaluation's
   logits within 1e-4·max|ref|; transmil's and MHIM-peg's K1, K2, K1b and
   K2b calls each see at most ⌈10,241/2⌉ tokens, gabmil's K4 runs once a
   rank on its block, each rank launching what one process launches (dtfd,
   rrtmil and the parity path none).

Phase 3 also holds K6, the gate's probe, against its plain version, K5
on rows wider than a cluster of blocks holds (1,500, 2,100 and 4,200
columns), and K5 from a carried state (``scan2d_carry``: y and h_last
against the plain scan from the same random h0 on a BLCA band of 138
rows, and on rows of 1,500 and 4,200 columns). Phases 4-21 each reset the
launch counts before their main-path runs and read them after (17c's,
18's, 19's, 20's and 21's ranks in their own processes); the kernels' launches
are the sums of those readings, plus the K6 launches of the gate's probe.

The line before the last lists the kernels as JSON; the last line is the
run's JSON verdict. Any failure exits nonzero before it.
"""

from __future__ import annotations

import contextlib
import copy
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


def peak_gib(fn):
    """``fn()`` and the peak device memory it reached above what was allocated before, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


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


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an H100")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")
    smi = card()
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


def k3_operands(gen, b, h, n, dh):
    """q (scaled by dh**-0.5), k, v and out's cotangent ``[B,H,N,dh]``, and
    attn's cotangent ``[B,H,N]``, standard normal."""
    q, k, v, co = (torch.randn(b, h, n, dh, device="cuda", generator=gen) for _ in range(4))
    return q * dh ** -0.5, k, v, co, torch.randn(b, h, n, device="cuda", generator=gen)


def k3_grads(f, qkv, cots, dtype=torch.float32, use_attn=True):
    """``(out, attn, dq, dk, dv)`` of ``f(q, k, v)`` in ``dtype`` under the
    cotangents of out and (with ``use_attn``) attn."""
    qq, kk, vv = (t.to(dtype, copy=True).requires_grad_() for t in qkv)
    out, attn = f(qq, kk, vv)
    outs = (out, attn) if use_attn else (out,)
    grads = torch.autograd.grad(outs, (qq, kk, vv), tuple(c.to(dtype) for c in cots[:len(outs)]))
    return (out.detach(), attn.detach(), *grads)


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
    q, k, v, co, ca = k3_operands(gen, b, h, n, dh)
    lengths = torch.randint(600, n + 1, (b,), device="cuda", generator=gen)
    lengths[0] = n
    mask = torch.arange(n, device="cuda")[None] < lengths[:, None]
    run = lambda f, dtype=torch.float32, use_attn=True: k3_grads(f, (q, k, v), (co, ca), dtype, use_attn)

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
    for label, ragged in (("long", False), ("long_ragged", True)):
        r[label] = k3_long(gen, label, ragged)
    return {"K3": r}


K3_LONG_N = 10241  # the cls token and a bag of 10,240: K3's length in the teacher stage (mhim_pure)
K3_LONG_KERNELS = ("K1", "K2", "K3p", "K1b", "K2b")


def k3_long(gen, label: str, ragged: bool, b: int = 4, n: int = K3_LONG_N) -> dict:
    """K3 at the teacher stage's length (B 4, H 8, N 10,241, dh 64, m 256;
    phase 12 also B 2 at N 16,385 and 32,769), every bag full or ragged
    (half to all of the N tokens valid, cls included: 5,121-10,241): out
    and attn against the fp32 plain path (out rtol 1e-4 atol 1e-5, attn
    max|d| <= 1e-4·max|ref|), and out, attn and the q/k/v gradients under
    random cotangents against the fp64 plain path by the kernel gate's VJP
    criterion (the fp32 plain path's share beside it); one forward +
    backward launches K1b and K2b once each. Timed beside the plain path,
    with each kernel's device ms and records a call (profiler) and the
    bound at this shape, and the peak memory of the fp64 plain path. Every
    check is printed before any fails the run."""
    from mhim_mil_torch.ops import flash_nystrom as fn
    from mhim_mil_torch.ops.nystrom import nystrom_attention
    from mhim_mil_torch.utils.kernel_check import vjp_close
    from mhim_mil_torch.utils.time_scan2d import breakdown

    h, dh, m = 8, 64, 256
    q, k, v, co, ca = k3_operands(gen, b, h, n, dh)
    lengths = torch.full((b,), n, device="cuda")
    if ragged:
        lengths = 1 + torch.randint((n - 1) // 2, n, (b,), device="cuda", generator=gen)
    mask = torch.arange(n, device="cuda")[None] < lengths[:, None]
    kern = lambda: k3_grads(lambda *t: fn.flash_nystrom(*t, mask, m), (q, k, v), (co, ca))
    plain_f = lambda *t: nystrom_attention(*t, mask, m, return_attn=True)
    plain = lambda: k3_grads(plain_f, (q, k, v), (co, ca))
    before = launches()
    got = kern()
    torch.cuda.synchronize()
    calls = {kid: n - before[kid] for kid, n in launches().items()}
    once = (calls["K1b"], calls["K2b"]) == (1, 1)
    want = plain()
    out_err = (got[0] - want[0]).abs()
    out_off = int((out_err > 1e-5 + 1e-4 * want[0].abs()).sum())
    attn_rel = ((got[1] - want[1]).abs().max() / want[1].abs().max()).item()
    want64, peak64 = peak_gib(lambda: k3_grads(plain_f, (q, k, v), (co, ca), torch.float64))
    crit, bad = [], []
    for name, g, w32, w64 in zip(("out", "attn", "dq", "dk", "dv"), got, want, want64):
        r64, r32 = vjp_close(g, w64), vjp_close(w32, w64)
        crit.append(f"{name} {r64['of_allowance']:.3f} of the allowance ({r64['n_bad']} entries miss; fp32 plain "
                    f"{r32['of_allowance']:.3f}, {r32['n_bad']} miss)")
        if not r64["ok"]:
            bad.append(f"{name} misses the VJP criterion against fp64 in {r64['n_bad']} entries")
    del want64
    row = {"lengths": lengths.tolist(), "max_abs_err": max(out_err.max().item(), attn_rel), "launches": calls,
           "out_entries_off_fp32": out_off, "plain_fp64_peak_gib": peak64, **k3_bounds(lengths.tolist(), h, n, m, dh)}
    log(f"K3 [{label}] B={b} H={h} N={n} dh={dh} m={m} valid={lengths.tolist()}: against the fp32 plain path out "
        f"max|d| {out_err.max().item():.3e} ({out_off} entries beyond rtol 1e-4 atol 1e-5; max|out| "
        f"{want[0].abs().max().item():.3e}), attn max|d|/max|ref| {attn_rel:.3e} (tolerance 1e-4); against the fp64 "
        f"plain path by the VJP criterion: {'; '.join(crit)}; K1b and K2b once each in a backward: {once}; the fp64 "
        f"plain path's peak memory {peak64:.2f} GiB")
    if out_off:
        bad.append(f"out: {out_off} entries beyond rtol 1e-4 atol 1e-5 of the fp32 plain path")
    if not attn_rel <= 1e-4 or not torch.isfinite(got[1]).all():
        bad.append(f"attn: max|d|/max|ref| {attn_rel:.3e} against the fp32 plain path")
    if not once:
        bad.append("its backward did not launch K1b and K2b once each")
    if bad:
        fail(f"K3 [{label}]: " + "; ".join(bad))
    del got, want
    torch.cuda.empty_cache()
    timed(row, kern, plain, plain_iters=5)
    # each kernel's bound for its part of this call (K2b with the cls term, K1b with s3's cotangent)
    o = {"q": q, "mask": mask}
    bound = {"K1": bounds("K1", o, h, m, dh), "K2": bounds("K2", o, h, m, dh), "K3p": pinv_bounds(b * h, m, 72, 4),
             "K1b": k1b_bounds(mask, h, m, dh, True), "K2b": k2b_bounds(mask, h, m, dh, True)}
    by = {kid: {"device_ms": 0.0, "records": 0, "bound_ms": bound[kid]["bound_ms"], "launches": calls[kid]}
          for kid in K3_LONG_KERNELS}
    for _, kid, ms, calls in breakdown(kern, iters=5):
        if kid in by:
            by[kid]["device_ms"] += ms
            by[kid]["records"] += calls
    row["by_kernel"] = by
    log(f"K3 [{label}] forward+backward {fmt_ms(row, '')}, plain {fmt_ms(row, 'plain_')}, {fmt_bound(row)}; "
        f"a call by kernel: device ms (profiler records, wrapper launches; bound ms) "
        + ", ".join(f"{kid} {t['device_ms']:.4f} ({t['records']}, {t['launches']}; {t['bound_ms']:.4f})"
                    for kid, t in by.items()))
    del q, k, v, co, ca
    torch.cuda.empty_cache()
    return row


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


def k5_bounds(x, a_log, carry: bool = False):
    """K5's least time: x and Δ read and y written (fp32) once per
    (cell, channel), B and C once per cell (with ``carry``, h0 read and
    h_last written once per (column, channel, state) too); the exponentials
    ā, one per (cell, channel, state), on the special-function units; 8
    FLOPs per (cell, channel, state) on the fp32 pipes (Δ·a, b̄x, the two
    recurrences' FMAs, the contraction with C). Returns the bound, what
    sets it and the three times."""
    bs, h, w, ed = x.shape
    n = a_log.shape[-1]
    cells = bs * h * w
    nbytes = 2 * cells * ed * x.element_size() + cells * ed * F32 + 2 * cells * n * x.element_size()
    nbytes += 2 * bs * w * ed * n * F32 if carry else 0
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
    # K5 with a carried state (the scan2d_carry op, phase 20's path): from a
    # random h0, writing the last row's state, y and h_last against the
    # plain scan from the same h0; a BLCA band of 138 rows on the cluster
    # kernel, and rows of 1,500 and 4,200 columns on the wide kernel (the h
    # of its third chunk on in shared memory, then in the global scratch).
    # Their operands come from a generator of their own, so that the later
    # phases draw what they drew before these rows were added
    r["carry"] = {}
    carry_gen = torch.Generator(device="cuda").manual_seed(24)
    for label, h, w in (("BLCA band", 138, 381), ("wide 1,500", 64, 1500), ("wide 4,200", 64, 4200)):
        ops = operands(1, h, w, torch.float32, carry_gen)
        h0 = torch.randn(1, w, 256, 16, device="cuda", generator=carry_gen)
        y, last = scan2d.scan2d_carry(*ops, h0)
        torch.cuda.synchronize()
        want_y, want_last = scan2d.scan2d_carry_plain(*ops, h0)
        err = max(check_close(f"K5 carry [{label}] y", y, want_y, 1e-4, 1e-5),
                  check_close(f"K5 carry [{label}] h_last", last, want_last, 1e-4, 1e-5))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r_c = {}
        timed(r_c, lambda: scan2d.scan2d_carry(*ops, h0), None)
        bound_ms, bound_by, _ = k5_bounds(ops[0], ops[2], carry=True)
        r["carry"][label] = {"ms": r_c["ms"], "device_ms": r_c["device_ms"], "bound_ms": bound_ms,
                             "bound_by": bound_by, "max_abs_err": err}
        log(f"K5 carry [{label}] Bs=1 H={h} W={w} ED=256 N=16 fp32, h0 and h_last [1, {w}, 256, 16]: y and h_last "
            f"max|d| {err:.3e} (rtol 1e-4, atol 1e-5); kernel {fmt_ms(r_c, '')}, bound {bound_ms:.4f} ms "
            f"({bound_by})")
        del ops, h0, y, last, want_y, want_last
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
    from mhim_mil_torch.tools.timing import kernel_launches

    return kernel_launches()


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


def compare_attention(label: str, pairs, tol: float, what: str = "kernel vs plain"):
    """Hold attention weights, whose values are near 1/N and far below 1, at
    ``tol``·max|ref|, their own scale; and fail unless that limit is below
    max|ref − mean(ref)|, what a constant attention of the right mean
    would miss by, so that the check tells the reference from such a one.
    ``what`` names the two sides in the log."""
    for name, got, want in pairs:
        err = (got - want).abs().max().item()
        limit = tol * want.abs().max().item()
        spread = (want - want.mean()).abs().max().item()
        log(f"{label} fp32 {name} {tuple(got.shape)}: {what} max|d| {err:.3e} (tolerance {tol} * max|ref| "
            f"= {limit:.3e}; a constant of the mean would miss by {spread:.3e})")
        if not torch.isfinite(got).all() or err > limit:
            fail(f"{label} fp32 {name} disagrees")
        if limit >= spread:
            fail(f"{label} fp32 {name}: the limit {limit:.3e} does not tell the reference from a constant")


def config_models(cfg, source: str, gen_seed: int):
    """The kernel-path and plain-path models of ``cfg`` on the same random
    weights, and the family; ``source`` names the config in the log."""
    from mhim_mil_torch.models import build_model

    model_k, family = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(gen_seed))
    model_p, _ = build_model(cfg.replace(use_flash_attn=False), device="cuda",
                             generator=torch.Generator().manual_seed(gen_seed + 1))
    model_p.load_state_dict(model_k.state_dict())
    name = cfg.model + (f"-{cfg.baseline}" if cfg.model.startswith("mhim") else "")
    log(f"model: {name} ({source}) input_dim {cfg.input_dim} inner_dim {cfg.inner_dim} heads {cfg.n_heads}, "
        f"{sum(p.numel() for p in model_k.parameters())} params, compute_dtype {cfg.compute_dtype}")
    return family, model_k, model_p


def preset_models(preset: str, gen_seed: int, **kw):
    """The kernel-path and plain-path models of ``preset`` at input_dim 1024
    on the same random weights, and the family."""
    from mhim_mil_torch.config import load_config

    cfg = load_config(["-c", preset], input_dim=1024, **kw)
    return (cfg, *config_models(cfg, preset, gen_seed))


def flagship_models(gen_seed: int, **kw):
    """The kernel-path and plain-path models of ``config/mhim_c16.yaml`` at
    input_dim 1024 on the same random weights."""
    cfg, _, model_k, model_p = preset_models("config/mhim_c16.yaml", gen_seed, **kw)
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


def train_batch(gen, cfg) -> dict:
    feats, mask = flagship_batch(gen, cfg.input_dim)
    b = feats.shape[0]
    return {"feats": feats, "mask": mask, "bag_valid": torch.ones(b, dtype=torch.bool, device="cuda"),
            "target": torch.randint(0, cfg.n_classes, (b,), device="cuda", generator=gen)}


def train_step_for(cfg, spe: int, family=None, ablate=None):
    """The MHIM train step (``family`` None; its ``ablate`` variant) or the generic one of ``family``."""
    from mhim_mil_torch.engine.steps import make_mhim_train_step, make_train_step

    if family is None:
        return make_mhim_train_step(cfg, spe, device="cuda", ablate=ablate)
    return make_train_step(cfg, family, spe, device="cuda")


def max_diff(a, b) -> float:
    return max((pa - pb).abs().max().item() for pa, pb in zip(a.parameters(), b.parameters()))


def fp32_step_pair(label: str, cfg, model_k, model_p, batch, spe: int, family=None, ablate=None, states=None,
                   **launches_per_step):
    """One fp32 train step on the kernel path and one on the plain path, from
    the same weights, batch and generator seed (so the same dropout, mining
    and merge draws): the MHIM step (its ``ablate`` variant), or the generic
    step of ``family``.
    Fails unless the kernel path launched ``launches_per_step`` and the plain
    path no kernel, the losses agree to 1e-4 relative, the gradients to 1e-3
    of max|g| and the parameters to 2·lr: Adam's first step moves each
    parameter by about lr·sign(g), so a gradient entry near zero may move
    the two paths' parameters apart by up to 2·lr. Returns the two states,
    their metrics (with the peak memory of each step, ``peak_gib``), the
    launches and lr. ``states``: the two train states, made by the caller
    (else here, seed 0)."""
    from mhim_mil_torch.engine.train_state import create_mhim_state, create_train_state

    create = create_mhim_state if family is None else create_train_state
    state_k, state_p = states or (create(cfg, model_k, spe, seed=0, device="cuda"),
                                  create(cfg, model_p, spe, seed=0, device="cuda"))
    lr = float(state_k.optimizer.lr_schedule(0))
    reset_launches()
    m_k, peak_k = peak_gib(lambda: train_step_for(cfg, spe, family, ablate)(state_k, batch))
    counted = expect_launches(f"one fp32 {label} step", **launches_per_step)
    reset_launches()
    m_p, peak_p = peak_gib(lambda: train_step_for(cfg.replace(use_flash_attn=False), spe, family, ablate)(state_p,
                                                                                                        batch))
    expect_launches(f"the plain-path {label} step")
    log(f"{label} fp32 metrics, kernel path: " + ", ".join(f"{k} {float(v):.6g}" for k, v in m_k.items()))
    log(f"{label} fp32 metrics, plain path:  " + ", ".join(f"{k} {float(v):.6g}" for k, v in m_p.items()))
    if set(m_k) != set(m_p):
        fail(f"{label}: the paths return other metrics: {sorted(m_k)} against {sorted(m_p)}")
    d_loss = abs(float(m_k["loss"]) - float(m_p["loss"]))
    g_err = 0.0 if ablate == "fwd_only" else max(  # fwd_only takes no gradient
        ((pk.grad - pp.grad).abs().max() / pp.grad.abs().max().clamp_min(1e-30)).item()
        for pk, pp in zip(model_k.parameters(), model_p.parameters()))
    p_err = max_diff(model_k, model_p)
    log(f"{label} fp32 kernel vs plain: loss |d| {d_loss:.3e} (tolerance 1e-4 * |loss|), gradients max|d|/max|ref| "
        f"{g_err:.3e} (tolerance 1e-3), params max|d| {p_err:.3e} (tolerance 2·lr = {2 * lr:.3e})")
    if not math.isfinite(float(m_k["loss"])) or d_loss > 1e-4 * abs(float(m_p["loss"])):
        fail(f"{label}: the loss disagrees")
    if g_err > 1e-3 or p_err > 2 * lr:
        fail(f"{label}: the kernel path's update disagrees with the plain path's")
    log(f"{label} fp32 step peak memory above the states and the batch: {peak_k:.2f} GiB, plain path {peak_p:.2f} GiB")
    m_k["peak_gib"], m_p["peak_gib"] = peak_k, peak_p
    m_k["grad_rel_err"], m_k["param_err"] = g_err, p_err
    return state_k, state_p, m_k, m_p, counted, lr


def bf16_steps(label: str, cfg, state, batch, spe: int, family=None, steps: int = TRAIN_STEPS,
               **launches_per_step) -> dict:
    """2 warm-up and ``steps`` timed bf16 steps of ``state`` (the MHIM step,
    or the generic step of ``family``): the host ms of each (synchronised),
    the losses, the peak memory of the timed steps, the launches
    (``launches_per_step`` a step, else the run fails) and the step. Fails
    unless every loss is finite and every parameter moved."""
    step16 = train_step_for(cfg.replace(compute_dtype="bfloat16"), spe, family)
    before = [p.detach().clone() for p in state.model.parameters()]
    reset_launches()
    for _ in range(2):
        step16(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step16(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    n = steps + 2
    counted = expect_launches(f"the bf16 {label} steps", **{k: v * n for k, v in launches_per_step.items()})
    moved = sum(not torch.equal(p, q) for p, q in zip(state.model.parameters(), before))
    r = {"ms": statistics.median(times), "times": times, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
         "counted": counted, "step": step16}
    log(f"{label} bf16: {steps} steps, losses {', '.join(f'{x:.4f}' for x in losses)}; {moved}/{len(before)} "
        f"parameter tensors moved; {r['ms']:.2f} ms per step (median, host clock, synchronised; min {min(times):.2f}, "
        f"max {max(times):.2f}), {batch['feats'].shape[0] / r['ms'] * 1e3:.1f} bags/s; peak memory "
        f"{r['peak_gib']:.2f} GiB")
    if not all(math.isfinite(x) for x in losses) or moved != len(before):
        fail(f"{label} bf16: a loss is not finite or a parameter did not move")
    return r


TRAIN_LAUNCHES = dict(K1=4, K2=4, K3=2, K3b=2, K3p=4 * 24 + 2 * 48, K1b=2, K2b=2)  # a flagship step
TEACHER_LAUNCHES = dict(K1=2, K2=2, K3=2, K3b=2, K3p=2 * 24 + 2 * 48, K1b=2, K2b=2)  # a teacher-stage step
TEACHER_FWD_LAUNCHES = dict(K1=2, K2=2, K3p=2 * 24)  # the teacher's forward: two TransLayers on K1, K2, K3p


def variant_launches(ablate) -> dict:
    """A flagship step's launches in each ``ablate`` variant, from
    TRAIN_LAUNCHES: ``no_teacher`` drops the teacher's forward; ``fwd_only``
    runs the teacher's and the student's forwards under no_grad, both on
    the kernels' inference path (``NystromMSA`` takes ``flash_nystrom_infer``
    without a gradient: K1, K2, K3p; no K3 call, no backward); the others
    launch what the full step launches."""
    if ablate == "no_teacher":
        return {k: v - TEACHER_FWD_LAUNCHES.get(k, 0) for k, v in TRAIN_LAUNCHES.items()}
    if ablate == "fwd_only":
        return {k: 2 * v for k, v in TEACHER_FWD_LAUNCHES.items()}
    return dict(TRAIN_LAUNCHES)


HIGH_POOL = 2 * 0.03  # the flagship's high-mining pool: mask_ratio_h / mask_ratio_hr of each bag's valid instances
TIE_BAND = (0.02, 0.20)  # planted ties: each bag's scores of these descending ranks (shares of its valid ones)


def plant_ties(scores, mask):
    """``scores`` with each bag's valid instances of descending rank
    TIE_BAND[0]·n to TIE_BAND[1]·n set to one value, their mean: many
    equal scores straddling the high-mining pool's cut at HIGH_POOL·n."""
    out = scores.clone()
    for b in range(scores.shape[0]):
        n = int(mask[b].sum())
        order = torch.argsort(scores[b].masked_fill(~mask[b], -math.inf), descending=True, stable=True)
        band = order[int(TIE_BAND[0] * n):int(TIE_BAND[1] * n)]
        out[b, band] = scores[b, band].mean()
    return out


def reflect(scores, mask):
    """Each bag's valid scores reflected about the middle of their range
    (``max + min − s``): the ranks of every score not tied reversed."""
    hi = scores.masked_fill(~mask, -math.inf).amax(-1, keepdim=True)
    lo = scores.masked_fill(~mask, math.inf).amin(-1, keepdim=True)
    return torch.where(mask, hi + lo - scores, scores)


@contextlib.contextmanager
def held_mining(state_k, state_p, rec: dict, plant=None, control: bool = False):
    """Hold both paths' mining to one decision (ROADMAP fault 14): while
    it is entered, the kernel path's teacher runs its own forward and then
    the plain path's teacher on the same inputs and the same dropout draws
    (the generator set back in between), records both (``rec``), and hands
    the plain path's mining scores (through ``plant`` when given) to the
    mining; the plain path's teacher hands on the same tensor. The kernel
    teacher's own scores are checked against the plain ones after the step
    (:func:`flagship_step_pair`). A 1-ulp difference between K1/K2 and the
    plain path can move instances whose scores are tied across the mining's
    cut: a weak check, not a kernel fault. ``control`` hands the kernel
    path's mining the scores reflected (:func:`reflect`), a decision that
    differs on instances whose scores are not tied: the step's check must
    then fail."""
    teacher_k, teacher_p = state_k.teacher, state_p.teacher
    own_k, own_p = teacher_k.forward_teacher, teacher_p.forward_teacher

    def kernel(feats, mask, training=False, gen=None):
        before = gen.get_state()
        cls_k, attn_k = own_k(feats, mask, training=training, gen=gen)
        after = gen.get_state()
        gen.set_state(before)
        cls_p, attn_p = own_p(feats, mask, training=training, gen=gen)
        if not torch.equal(gen.get_state(), after):
            fail("the two teachers drew other numbers from the step's generator")
        mined = attn_p if plant is None else plant(attn_p, mask)
        rec.update(attn_k=attn_k, attn_p=attn_p, cls_k=cls_k, cls_p=cls_p, mask=mask, mined=mined)
        return cls_k, reflect(mined, mask) if control else mined

    def plain(feats, mask, training=False, gen=None):
        cls_p, attn_p = own_p(feats, mask, training=training, gen=gen)
        rec["attn_p_again"] = attn_p
        return cls_p, rec["mined"]

    teacher_k.forward_teacher, teacher_p.forward_teacher = kernel, plain
    try:
        yield
    finally:
        del teacher_k.forward_teacher, teacher_p.forward_teacher


def flagship_step_pair(label: str, cfg, model_k, model_p, batch, spe: int, ablate=None, plant=None,
                       control: bool = False):
    """:func:`fp32_step_pair` of the flagship step (its ``ablate`` variant)
    with its launches (:func:`variant_launches`), both paths' mining held
    to one decision on the plain path's scores (:func:`held_mining`, with
    ``plant`` and ``control``), and the mining's, the teacher EMA's and
    global_q's checks: the kernel teacher's mining scores within
    1e-4·max|ref| of the plain teacher's, its cls feature within
    1e-4·max(1, max|ref|), keep_num and patch_num equal, the teacher within
    (1 − mm)·2·lr, global_q within 1e-6. Returns the two states, their
    metrics and the launches."""
    from mhim_mil_torch.engine.train_state import create_mhim_state

    rec: dict = {}
    create = create_mhim_state
    states = (create(cfg, model_k, spe, seed=0, device="cuda"), create(cfg, model_p, spe, seed=0, device="cuda"))
    with held_mining(*states, rec, plant, control):
        state_k, state_p, m_k, m_p, counted, lr = fp32_step_pair(label, cfg, model_k, model_p, batch, spe,
                                                                 ablate=ablate, states=states,
                                                                 **variant_launches(ablate))
    if rec:
        mask = rec["mask"]
        s_err = (rec["attn_k"] - rec["attn_p"]).abs().max().item()
        s_tol = 1e-4 * rec["attn_p"].abs().max().item()
        c_err = (rec["cls_k"] - rec["cls_p"]).abs().max().item()
        c_tol = 1e-4 * max(1.0, rec["cls_p"].abs().max().item())
        again = (rec["attn_p_again"] - rec["attn_p"]).abs().max().item()
        valid = rec["mined"][mask]
        log(f"{label} fp32 teacher, kernel vs plain: mining scores max|d| {s_err:.3e} (tolerance 1e-4 * max|ref| = "
            f"{s_tol:.3e}), cls max|d| {c_err:.3e} (tolerance {c_tol:.3e}); the mining of both paths read the plain "
            f"scores{' with planted ties' if plant else ''}: {valid.numel()} valid scores, {valid.unique().numel()} "
            f"distinct; the plain step's own scores again max|d| {again:.3e}"
            + ("; control: the kernel path's mining read them reflected" if control else ""))
        if not torch.isfinite(rec["attn_k"]).all() or s_err > s_tol or c_err > c_tol:
            fail(f"{label}: the kernel path's teacher disagrees with the plain path's")
    for key in ("keep_num", "patch_num"):
        if float(m_k[key]) != float(m_p[key]):
            fail(f"{label}: {key} differs between the paths: the mining took other instances")
    t_err = max_diff(state_k.teacher, state_p.teacher)
    q_err = (model_k.merge.global_q_mm - model_p.merge.global_q_mm).abs().max().item()
    log(f"{label} fp32 kernel vs plain: teacher max|d| {t_err:.3e} (tolerance {2 * lr * (1 - cfg.mm) + 1e-7:.3e}), "
        f"global_q max|d| {q_err:.3e} (tolerance 1e-6)")
    if t_err > 2 * lr * (1 - cfg.mm) + 1e-7 or q_err > 1e-6:
        fail(f"{label}: the kernel path's teacher EMA or global_q disagrees with the plain path's")
    m_k["teacher_err"], m_k["global_q_err"] = t_err, q_err
    return state_k, state_p, m_k, m_p, counted


def phase_train(gen) -> dict:
    """Phase 5: the flagship train step. One fp32 step on the kernel path
    against the plain path (:func:`flagship_step_pair`: both paths' mining
    held to the plain teacher's scores, the kernel teacher's scores within
    1e-4·max|ref| of them, keep_num and patch_num equal, the teacher within
    (1 − mm)·2·lr, global_q within 1e-6); the same from the same weights
    with ties planted in those scores across the high-mining cut
    (:func:`plant_ties`), which must pass, and the control whose kernel
    path mines the scores reflected, which must fail; then bf16 steps."""
    cfg, model_k, model_p = flagship_models(2, compute_dtype="float32")
    batch = train_batch(gen, cfg)
    spe = 8
    fresh = [(copy.deepcopy(model_k), copy.deepcopy(model_p)) for _ in range(2)]
    state_k, _, _, _, counted = flagship_step_pair("train", cfg, model_k, model_p, batch, spe)
    _, _, m_t, _, _ = flagship_step_pair("train, planted ties", cfg, *fresh[0], batch, spe, plant=plant_ties)
    try:
        flagship_step_pair("train, control", cfg, *fresh[1], batch, spe, control=True)
    except SystemExit as e:
        log(f"train, control (the kernel path's mining on reflected scores) failed, as it must: {e}")
    else:
        fail("train, control: the kernel path mined other instances and the step's check passed: it cannot see "
             "the mining")
    del fresh
    r = bf16_steps("train", cfg, state_k, batch, spe, **TRAIN_LAUNCHES)
    b = batch["feats"].shape[0]
    return {"launches": [counted, r["counted"]],
            "train": {"ms_per_step": r["ms"], "bags_per_s": b / r["ms"] * 1e3, "peak_gib": r["peak_gib"],
                      "planted_ties_loss": float(m_t["loss"])}}


def phase_teacher(gen) -> dict:
    """Phase 5b: the teacher-stage step (``--model mhim_pure``, selfattn, no
    mining or merge, K3 over the whole bag of up to 10,241 tokens). One fp32
    step on the kernel path against the plain path (:func:`fp32_step_pair`,
    phase 5's tolerances), with its launches; then bf16 steps: host ms, the
    device's busy ms a step (profiler), peak memory. The teacher, which no
    EMA moves in this stage, must keep its initial weights bit for bit."""
    cfg, model_k, model_p = flagship_models(6, model="mhim_pure", compute_dtype="float32")
    batch = train_batch(gen, cfg)
    spe = 8
    teacher0 = [p.detach().clone() for p in model_k.parameters()]
    state_k, state_p, m_k, _, counted, _ = fp32_step_pair("teacher", cfg, model_k, model_p, batch, spe,
                                                          **TEACHER_LAUNCHES)
    log(f"teacher fp32: patch_num {float(m_k['patch_num']):.1f}, keep_num {float(m_k['keep_num']):.1f}, "
        f"aux_loss {float(m_k['aux_loss'])}")
    if float(m_k["keep_num"]) != float(m_k["patch_num"]) or float(m_k["aux_loss"]) != 0.0:
        fail("teacher: the mhim_pure step mined, merged or paid a consistency loss")
    del state_p, model_p
    torch.cuda.empty_cache()
    r = bf16_steps("teacher", cfg, state_k, batch, spe, **TEACHER_LAUNCHES)
    busy = device_ms(lambda: r["step"](state_k, batch), iters=5)
    frozen = all(torch.equal(p, q) for p, q in zip(state_k.teacher.parameters(), teacher0))
    log(f"teacher bf16: device busy {'not measured' if busy is None else f'{busy:.2f} ms a step'} (profiler, 5 "
        f"steps) of {r['ms']:.2f} ms; the teacher kept its initial weights: {frozen}")
    if not frozen:
        fail("teacher: the mhim_pure step moved the teacher")
    b = batch["feats"].shape[0]
    return {"launches": [counted, r["counted"]],
            "teacher": {"ms_per_step": r["ms"], "bags_per_s": b / r["ms"] * 1e3, "peak_gib": r["peak_gib"],
                        "device_busy_ms": busy}}


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


ZOO = "config/feat_cls.yaml"


def zoo_eval_pair(label: str, cfg, family, model_k, model_p, batch, tol: float, **launches) -> tuple:
    """The fp32 eval step of ``model_k`` (kernel path, ``launches``) against
    ``model_p``'s (plain path, no launch) on ``batch``, within tol·max(1,
    max|ref|). Returns the kernel path's logits and its launches."""
    from mhim_mil_torch.engine.steps import make_eval_step

    cfg32 = cfg.replace(compute_dtype="float32")
    reset_launches()
    out_k = make_eval_step(cfg32, model_k, family)(batch)
    torch.cuda.synchronize()
    counted = expect_launches(f"{label} eval step", **launches)
    reset_launches()
    out_p = make_eval_step(cfg32, model_p, family)(batch)
    torch.cuda.synchronize()
    expect_launches(f"the {label} plain path")
    compare_models(label, [(k, out_k[k], out_p[k]) for k in out_p], tol)
    return out_k["logits"], counted


def phase_zoo(gen) -> dict:
    """Phase 9: the zoo at full width (``config/feat_cls.yaml``, act gelu,
    input 1024, inner 512, 8 heads of 64, 256 landmarks) on the ragged
    4 × 10,240 batch. abmil and gabmil: the eval step through K4 against the
    plain pool in fp32 (1e-4·max(1, max|ref|)), then the scorer under bf16
    (K4 once a request), and abmil's bf16 train steps (the plain pool: K4
    has no gradient). transmil: the eval step (K1 + K2 in each layer)
    against the plain path in fp32 (1e-3·max(1, max|ref|)), one fp32 train
    step on K3 forward and backward against the plain path (phase 5's
    tolerances), then bf16 steps with the device's busy ms (profiler).
    dsmil and MHIM-dsmil, which run no kernel: the eval step in bf16
    against fp32 within 0.1 (dsmil's logits fused on the host as the
    driver fuses them)."""
    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.engine.steps import make_eval_step, make_mhim_eval_step
    from mhim_mil_torch.engine.train_state import create_train_state

    batch = train_batch(gen, load_config(["-c", ZOO], input_dim=1024))
    counted, readings, rows = [], {}, []
    spe = 8
    for seed, name in ((10, "abmil"), (12, "gabmil")):
        cfg, family, model_k, model_p = preset_models(ZOO, seed, model=name)
        logits_k, c = zoo_eval_pair(name, cfg, family, model_k, model_p, batch, 1e-4, K4=1)
        counted.append(c)
        with torch.no_grad():  # bag_feat and attn through K4 against the plain pool
            got = model_k(batch["feats"], batch["mask"], return_attn=True)
            want = model_p(batch["feats"], batch["mask"], return_attn=True)
        compare_models(name, [(k, got[k], want[k]) for k in ("bag_feat", "attn")], 1e-4)
        requests = [("batch 4 x 10240", batch["feats"].cpu().numpy(), batch["mask"].cpu().numpy(), 4),
                    ("batch 1 x 10240", batch["feats"][:1].cpu().numpy(), None, 1)]
        sv = serve(name, cfg, model_k, requests, {"K4": 1}, logits_k, family=family)
        counted.append(sv["launches"])
        rows += sv["serving"]
        if name == "abmil":
            del model_p
            state = create_train_state(cfg, model_k, spe, seed=0, device="cuda")
            r = bf16_steps(name, cfg, state, batch, spe, family=family)
            busy = device_ms(lambda: r["step"](state, batch), iters=5)
            log(f"abmil bf16: device busy {'not measured' if busy is None else f'{busy:.2f} ms a step'} "
                f"(profiler, 5 steps) of {r['ms']:.2f} ms")
            readings[name] = {"ms_per_step": r["ms"], "peak_gib": r["peak_gib"], "device_busy_ms": busy}
        torch.cuda.empty_cache()

    cfg, family, model_k, model_p = preset_models(ZOO, 14, model="transmil", compute_dtype="float32")
    _, c = zoo_eval_pair("transmil", cfg, family, model_k, model_p, batch, 1e-3, K1=2, K2=2, K3p=2 * 24)
    counted.append(c)
    state_k, state_p, m_k, _, c, _ = fp32_step_pair("transmil", cfg, model_k, model_p, batch, spe,
                                                    family=family, **TEACHER_LAUNCHES)
    counted.append(c)
    del state_p, model_p
    torch.cuda.empty_cache()
    r = bf16_steps("transmil", cfg, state_k, batch, spe, family=family, **TEACHER_LAUNCHES)
    counted.append(r["counted"])
    busy = device_ms(lambda: r["step"](state_k, batch), iters=5)
    log(f"transmil bf16: device busy {'not measured' if busy is None else f'{busy:.2f} ms a step'} (profiler, "
        f"5 steps) of {r['ms']:.2f} ms")
    readings["transmil"] = {"ms_per_step": r["ms"], "peak_gib": r["peak_gib"], "device_busy_ms": busy}
    del state_k, model_k
    torch.cuda.empty_cache()

    for label, preset, kw in (("dsmil", ZOO, dict(model="dsmil")),
                              ("mhim-dsmil", "config/mhim_c16.yaml", dict(baseline="dsmil"))):
        cfg, family, model, _ = preset_models(preset, 16, **kw)
        make = make_mhim_eval_step if family == "mhim" else (lambda c, m: make_eval_step(c, m, family))
        reset_launches()
        outs = {}
        for dtype in ("float32", "bfloat16"):
            out = make(cfg.replace(compute_dtype=dtype), model)(batch)
            outs[dtype] = 0.5 * out["logits"] + 0.5 * out["sub_logits"] if "sub_logits" in out else out["logits"]
        torch.cuda.synchronize()
        counted.append(expect_launches(f"{label} eval steps"))
        err = (outs["bfloat16"] - outs["float32"]).abs().max().item()
        log(f"{label} eval bf16 vs fp32 logits {tuple(outs['float32'].shape)}: max|d| {err:.3e} (tolerance 0.1)")
        if not torch.isfinite(outs["bfloat16"]).all() or err > 0.1:
            fail(f"{label}: bf16 eval logits drift from the fp32 logits")
    return {"launches": counted, "serving": rows, "zoo": readings}


# CLAM's instance loss and DTFD's pseudo-bag loss are its aux loss, which
# feat_cls.yaml weights 0 (aux_alpha's default): 0.5, as mhim_c16.yaml
# weights MHIM's, so that the steps train their instance and tier-1 heads.
ZOO_II = (("clam_sb", dict(aux_alpha=0.5)), ("clam_mb", dict(aux_alpha=0.5)), ("dtfd", dict(aux_alpha=0.5)),
          ("ibmil", {}),
          ("rrtmil", dict(rrt_n_layers=2, rrt_n_heads=8, region_num=8, epeg_k=15, crmsa_k=3)))


class NoDropout:
    """Dropout off in the port's models while the ``with`` block runs, so that
    a training forward on the card and on the CPU draw nothing."""

    def __enter__(self):
        from mhim_mil_torch.models import layers

        self.layers, self.real = layers, layers.Dropout.forward
        layers.Dropout.forward = lambda self_, x, *a, **k: x
        return self

    def __exit__(self, *exc):
        self.layers.Dropout.forward = self.real


def ibmil_bank(gen, path: str, seed: int) -> None:
    """IBMIL's bank of 8 prototypes: the port's ``kmeans`` over the fp32 bag
    features that the model without a bank (weights from ``seed``, the
    embed and pool the banked model draws first) gives 32 random bags of
    1,024 instances; saved to ``path``."""
    import numpy as np

    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.models import build_model
    from mhim_mil_torch.utils.confounders import build_confounders

    cfg = load_config(["-c", ZOO], input_dim=1024, model="ibmil")
    model, _ = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
    feats = torch.randn(32, 1024, cfg.input_dim, device="cuda", generator=gen)
    with torch.no_grad():
        bags = model(feats, torch.ones(feats.shape[:2], dtype=torch.bool, device="cuda"))["bag_feat"]
    protos = build_confounders(bags.cpu().numpy(), 8, path, seed=seed)
    log(f"ibmil bank: kmeans of {tuple(bags.shape)} bag features into {protos.shape}, finite "
        f"{bool(np.isfinite(protos).all())}")


def planted_topk(gen):
    """CLAM's top-k on the card against the CPU, index for index, on scores
    with planted ties (rounded to 0.1) and NEG_INF padding, ``[4, 2, 10240]``
    with 10,240, 10,240, 8,000 and 5 valid instances: the last bag's top-8
    reach into its padding, which ties among itself."""
    from mhim_mil_torch.models.clam import top_k_indices
    from mhim_mil_torch.ops.masked import NEG_INF

    lengths = torch.tensor([10240, 10240, 8000, 5], device="cuda")
    mask = torch.arange(10240, device="cuda")[None] < lengths[:, None]
    s = torch.round(torch.randn(4, 2, 10240, device="cuda", generator=gen) * 10) / 10
    for sign in (1.0, -1.0):
        scores = torch.where(mask[:, None], sign * s, NEG_INF)
        got, want = top_k_indices(scores, 8).cpu(), top_k_indices(scores.cpu(), 8)
        if not torch.equal(got, want) or got[3, 0, 5:].tolist() != [5, 6, 7]:
            fail(f"clam top-k on the card {got[3].tolist()} != the CPU's {want[3].tolist()}")
    log("clam top-k with planted ties: the card's indices equal the CPU's (ties in index order)")


def phase_zoo2(gen) -> dict:
    """Phase 10, zoo II, at full width (``config/feat_cls.yaml``, act gelu,
    Adam 2e-4, input 1024, inner 512) on the ragged 4 × 10,240 batch:
    clam_sb, clam_mb, dtfd, ibmil (with a bank of 8 prototypes that the
    port's kmeans draws from its own bag features) and rrtmil (1 R-MSA + 1
    CR-MSA, 8 heads, region_num 8, epeg_k 15, crmsa_k 3: 64 regions of 169
    tokens); CLAM and DTFD weight their aux loss 0.5. For each: the fp32
    eval step on the card against the same
    model on the CPU (1e-4·max(1, max|ref|)); for CLAM the training
    forward's ``aux_loss``, dropout off, card against CPU (1e-4 relative);
    bf16 eval against fp32 (0.1) and its host ms; 2 + TRAIN_STEPS bf16
    train steps (finite, every parameter moved), host ms, the device's busy
    ms (profiler) and peak memory; none of K1-K6 launched."""
    import copy

    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.engine.steps import make_eval_step
    from mhim_mil_torch.engine.train_state import create_train_state

    planted_topk(gen)
    batch = train_batch(gen, load_config(["-c", ZOO], input_dim=1024))
    batch["target"] = torch.tensor([0, 1, 0, 1], device="cuda")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    counted, readings, spe = [], {}, 8
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ibmil_") as tmp:
        bank = os.path.join(tmp, "bank.npy")
        ibmil_bank(gen, bank, 20)
        for seed, (name, kw) in enumerate(ZOO_II, start=20):
            extra = {"confounder_path": bank} if name == "ibmil" else {}
            cfg, family, model, _ = preset_models(ZOO, seed, model=name, **kw, **extra)
            model_c = copy.deepcopy(model).cpu()
            cfg32 = cfg.replace(compute_dtype="float32")
            reset_launches()
            out = make_eval_step(cfg32, model, family)(batch)
            torch.cuda.synchronize()
            counted.append(expect_launches(f"{name} eval step"))
            ref = make_eval_step(cfg32, model_c, family)(cpu_batch)
            compare_models(f"{name} card vs CPU", [("logits", out["logits"].cpu(), ref["logits"])], 1e-4)
            if family == "clam":
                with NoDropout(), torch.no_grad():
                    aux = model(batch["feats"], batch["mask"], batch["target"], training=True)["aux_loss"]
                    aux_c = model_c(cpu_batch["feats"], cpu_batch["mask"], cpu_batch["target"],
                                    training=True)["aux_loss"]
                d = abs(float(aux) - float(aux_c))
                log(f"{name} fp32 aux_loss (instance loss, dropout off): card {float(aux):.7f}, CPU "
                    f"{float(aux_c):.7f}, |d| {d:.3e} (tolerance 1e-4 * |CPU|)")
                if not math.isfinite(float(aux)) or d > 1e-4 * abs(float(aux_c)):
                    fail(f"{name}: the card's instance loss disagrees with the CPU's")
            del model_c
            step16 = make_eval_step(cfg, model, family)
            reset_launches()
            logits16 = step16(batch)["logits"]
            torch.cuda.synchronize()
            counted.append(expect_launches(f"{name} bf16 eval step"))
            err = (logits16 - out["logits"]).abs().max().item()
            log(f"{name} eval bf16 vs fp32 logits {tuple(logits16.shape)}: max|d| {err:.3e} (tolerance 0.1)")
            if not torch.isfinite(logits16).all() or err > 0.1:
                fail(f"{name}: bf16 eval logits drift from the fp32 logits")
            times = []
            for _ in range(SERVING_REPEATS):
                t0 = time.perf_counter()
                step16(batch)["logits"].cpu()
                times.append((time.perf_counter() - t0) * 1e3)
            eval_ms = statistics.median(times)
            state = create_train_state(cfg, model, spe, seed=0, device="cuda")
            r = bf16_steps(name, cfg, state, batch, spe, family=family)
            counted.append(r["counted"])
            busy = device_ms(lambda: r["step"](state, batch), iters=5)
            log(f"{name} bf16: eval {eval_ms:.2f} ms a call (median of {SERVING_REPEATS}, host clock, features on "
                f"the card); train step device busy {'not measured' if busy is None else f'{busy:.2f} ms'} "
                f"(profiler, 5 steps) of {r['ms']:.2f} ms")
            readings[name] = {"ms_per_step": r["ms"], "peak_gib": r["peak_gib"], "device_busy_ms": busy,
                              "eval_ms": eval_ms}
            del state, model, r
            torch.cuda.empty_cache()
    log(f"zoo II readings: {json.dumps(readings)}")
    return {"launches": counted, "zoo2": readings}


MAMBAMIL = (("simple", "SimpleMamba"), ("srmamba", "SRMamba"), ("bimamba", "BiMamba"))
MAMBAMIL_TIMED = "bimamba"  # the variant whose evaluation and train steps are timed (and its memory held)
LATTICE_BYTES = 4 * 10240 * 256 * 16 * F32  # one fp32 [Bs, L, ED, N] lattice of the 1D scan at full width


def phase_mambamil(gen) -> dict:
    """Phase 11a: ``mambamil`` at full width (``config/feat_cls.yaml`` +
    ``--model mambamil``: input 1024, width 128, one layer, 16 states,
    ``sr_rate`` 10) on the ragged 4 × 10,240 batch, for each of simple,
    srmamba and bimamba: the fp32 eval step on the card against the same
    model on the CPU for bags 3 and 4 (8,000 and 6,000 valid: the CPU
    reference at full size doubled the script's time), within
    1e-4·max(1, max|ref|); bf16 eval against fp32 (0.1); bf16 train steps
    (finite losses, every parameter moved): 2 + 1 for simple and srmamba,
    and for bimamba alone (MAMBAMIL_TIMED) 2 + TRAIN_STEPS with host ms,
    its eval's host ms, the device's busy ms (profiler) and peak memory;
    none of K1-K6 launched (the 1D scan is plain torch, as
    JAX runs it in XLA). bimamba's step must peak below 14 full lattices
    (one a doubling step of the scan: what a scan that kept its lattice
    for the backward would hold)."""
    import copy

    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.engine.steps import make_eval_step
    from mhim_mil_torch.engine.train_state import create_train_state

    batch = train_batch(gen, load_config(["-c", ZOO], input_dim=1024))
    cpu_batch = {k: v[2:].cpu() for k, v in batch.items()}  # the ragged bags
    counted, readings, spe = [], {}, 8
    for seed, (variant, mtype) in enumerate(MAMBAMIL, start=30):
        cfg, family, model, _ = preset_models(ZOO, seed, model="mambamil", mambamil_type=mtype)
        cfg32 = cfg.replace(compute_dtype="float32")
        reset_launches()
        out = make_eval_step(cfg32, model, family)(batch)
        torch.cuda.synchronize()
        counted.append(expect_launches(f"mambamil {variant} eval step"))
        ref = make_eval_step(cfg32, copy.deepcopy(model).cpu(), family)(cpu_batch)
        compare_models(f"mambamil {variant} card vs CPU, bags 3-4", [("logits", out["logits"][2:].cpu(),
                                                                       ref["logits"])], 1e-4)
        step16 = make_eval_step(cfg, model, family)
        reset_launches()
        logits16 = step16(batch)["logits"]
        torch.cuda.synchronize()
        counted.append(expect_launches(f"mambamil {variant} bf16 eval step"))
        err = (logits16 - out["logits"]).abs().max().item()
        log(f"mambamil {variant} eval bf16 vs fp32 logits {tuple(logits16.shape)}: max|d| {err:.3e} (tolerance 0.1)")
        if not torch.isfinite(logits16).all() or err > 0.1:
            fail(f"mambamil {variant}: bf16 eval logits drift from the fp32 logits")
        state = create_train_state(cfg, model, spe, seed=0, device="cuda")
        if variant != MAMBAMIL_TIMED:  # the depth cut: the others' bf16 steps checked, not timed
            counted.append(bf16_steps(f"mambamil {variant}", cfg, state, batch, spe, family=family,
                                      steps=1)["counted"])
            del state, model
            torch.cuda.empty_cache()
            continue
        times = []
        for _ in range(SERVING_REPEATS):
            t0 = time.perf_counter()
            step16(batch)["logits"].cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        eval_ms = statistics.median(times)
        eval_busy = device_ms(lambda: step16(batch), iters=5)
        r = bf16_steps(f"mambamil {variant}", cfg, state, batch, spe, family=family)
        counted.append(r["counted"])
        busy = device_ms(lambda: r["step"](state, batch), iters=5)
        fmt = lambda x: "not measured" if x is None else f"{x:.2f} ms"
        log(f"mambamil {variant} bf16: eval {eval_ms:.2f} ms a call (median of {SERVING_REPEATS}, host clock, "
            f"features on the card; device busy {fmt(eval_busy)}); train step device busy {fmt(busy)} (profiler, 5 "
            f"steps) of {r['ms']:.2f} ms; peak {r['peak_gib']:.2f} GiB against one full lattice "
            f"[4, 10240, 256, 16] fp32 of {LATTICE_BYTES / 2 ** 30:.3f} GiB")
        readings[variant] = {"ms_per_step": r["ms"], "peak_gib": r["peak_gib"], "device_busy_ms": busy,
                             "eval_ms": eval_ms, "eval_device_busy_ms": eval_busy}
        if variant == "bimamba" and r["peak_gib"] * 2 ** 30 >= 14 * LATTICE_BYTES:
            fail(f"mambamil bimamba: the train step peaked at {r['peak_gib']:.2f} GiB, not below 14 lattices "
                 f"({14 * LATTICE_BYTES / 2 ** 30:.2f} GiB): the scan keeps its lattice for the backward")
        del state, model, r
        torch.cuda.empty_cache()
    log(f"mambamil readings: {json.dumps(readings)}")
    return {"launches": counted, "mambamil": readings}


def phase_streamed(gen) -> dict:
    """Phase 11b: the streamed Nystrom path (``nystrom_attention_streamed``,
    windows of 1,024 tokens) on the card. At B 4, H 8, N 10,241, dh 64,
    m 256, fp32, full and ragged bags: out and the cls row against the
    kernel path (K1 + K2 with the pseudo-inverse on K3p), out within
    1e-3·max(1, max|ref|) (phase 4's), the cls row (values near 1/N)
    within 1e-4·max|ref| (``compare_attention``), with the peak memory of the
    streamed, materialising and kernel paths. Then the teacher-stage step
    (``--model mhim_pure``) with ``use_flash_attn=False``, whose two
    TransLayers stream at 10,241 tokens: one fp32 step against the same
    step on the materialising path (phase 5's tolerances; no kernel), with
    the peak memory of each."""
    from mhim_mil_torch.models.transformer import NystromMSA
    from mhim_mil_torch.ops import flash_nystrom as fn
    from mhim_mil_torch.ops.nystrom import nystrom_attention, nystrom_attention_streamed

    b, h, n, dh, m = 4, 8, K3_LONG_N, 64, 256
    q, k, v, _, _ = k3_operands(gen, b, h, n, dh)
    row = {}
    for label, ragged in (("full", False), ("ragged", True)):
        lengths = torch.full((b,), n, device="cuda")
        if ragged:
            lengths = 1 + torch.randint(5120, n, (b,), device="cuda", generator=gen)
        mask = torch.arange(n, device="cuda")[None] < lengths[:, None]
        with torch.no_grad():
            (s_out, s_attn), s_peak = peak_gib(lambda: nystrom_attention_streamed(
                *(t.transpose(1, 2) for t in (q, k, v)), mask, m, return_attn=True))
            (k_out, k_attn), k_peak = peak_gib(lambda: fn.flash_nystrom_infer(q, k, v, mask, m))
            _, m_peak = peak_gib(lambda: nystrom_attention(q, k, v, mask, m, return_attn=True))
        compare_models(f"streamed [{label}] vs the kernel path", (
            ("out", s_out, k_out.transpose(1, 2).reshape(b, n, h * dh)),), 1e-3)
        compare_attention(f"streamed [{label}] vs the kernel path", (("cls attn", s_attn, k_attn),), 1e-4,
                          what="streamed vs kernels")
        row[label] = {"lengths": lengths.tolist(), "peak_gib": {"streamed": s_peak, "kernels": k_peak,
                                                                "materialising": m_peak}}
        log(f"streamed [{label}] B={b} H={h} N={n} dh={dh} m={m} valid={lengths.tolist()}: peak memory above the "
            f"inputs, no grad: streamed {s_peak:.3f} GiB, kernel path {k_peak:.3f}, materialising {m_peak:.3f}")
        del s_out, s_attn, k_out, k_attn
    del q, k, v
    torch.cuda.empty_cache()

    cfg, model_s, model_m = flagship_models(40, model="mhim_pure", compute_dtype="float32", use_flash_attn=False)
    for mod in model_m.modules():
        if isinstance(mod, NystromMSA):
            mod.stream_min_len = 1 << 30
    batch = train_batch(gen, cfg)
    paths = {n_: mod.path(K3_LONG_N, True) for n_, model in (("s", model_s), ("m", model_m))
             for mod in model.modules() if isinstance(mod, NystromMSA)}
    if paths != {"s": "streamed", "m": "materialising"}:
        fail(f"streamed: the teacher-stage models take the paths {paths}")
    _, _, m_s, m_m, counted, _ = fp32_step_pair("streamed teacher-stage", cfg, model_s, model_m, batch, 8)
    row["step_peak_gib"] = {"streamed": m_s["peak_gib"], "materialising": m_m["peak_gib"]}
    log(f"streamed teacher-stage fp32 step: peak memory streamed {m_s['peak_gib']:.2f} GiB, materialising "
        f"{m_m['peak_gib']:.2f} GiB")
    return {"launches": [counted], "streamed": row}


EXPORT_RUNS = (  # label, flags, kernel launches a slide on the kernel path
    ("mhim selfattn", ["-c", "config/mhim_c16.yaml", "--model", "mhim"], dict(K1=2, K2=2, K3p=2 * 24)),
    ("abmil", ["-c", ZOO, "--model", "abmil"], dict(K4=1)),
)
EXPORT_LENGTHS = (10240, 8000, 6000)


def phase_heatmaps(gen) -> dict:
    """Phase 11c: ``python -m mhim_mil_torch.tools.export_attention`` on a
    synthetic ``.pt`` store of three slides (10,240, 8,000 and 6,000
    instances of width 1024; no coordinates, so each grid is the raster),
    random weights from the config's seed: MHIM selfattn (``forward_test``,
    K1 + K2 with K3p in each of its two layers) and abmil (K4), each against
    the same export on the plain path (``--use_flash_attn false``: MHIM's
    layers stream at these lengths), slide by slide: the raw scores the
    tool returns within 1e-4·max|ref| (``compare_attention``), and each
    written grid the percentile raster of its scores; the launches of each
    kernel-path export."""
    import numpy as np

    from mhim_mil_torch.tools.export_attention import main as export
    from mhim_mil_torch.utils.heatmap import attention_to_grid

    counted = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_heatmaps_") as tmp:
        os.makedirs(os.path.join(tmp, "store", "pt_files"))
        for i, n in enumerate(EXPORT_LENGTHS):
            torch.save(torch.randn(n, 1024, device="cuda", generator=gen).cpu(),
                       os.path.join(tmp, "store", "pt_files", f"slide{i}.pt"))
        for label, flags, per_slide in EXPORT_RUNS:
            runs = {}
            for path, flash in (("kernels", "true"), ("plain", "false")):
                out = os.path.join(tmp, f"{label}-{path}")
                reset_launches()
                t0 = time.perf_counter()
                scores = export(["--out", out, "--dataset_root", os.path.join(tmp, "store"), "--input_dim", "1024",
                                 "--use_flash_attn", flash, *flags])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                want = {kid: k * len(EXPORT_LENGTHS) for kid, k in per_slide.items()} if path == "kernels" else {}
                seen = expect_launches(f"heatmaps [{label}] export on the {path} path", **want)
                if path == "kernels":
                    counted.append(seen)
                log(f"heatmaps [{label}] {path} path: {len(scores)} slides exported in {secs:.2f} s (host clock, "
                    f"model built and files written), launches {seen}")
                for sid, sc in scores.items():
                    grid = np.load(os.path.join(out, f"{sid}_attn.npy"))
                    if not np.array_equal(grid, attention_to_grid(sc), equal_nan=True):
                        fail(f"heatmaps [{label}] {path} path: {sid}'s grid is not the raster of its scores")
                runs[path] = scores
            if sorted(runs["kernels"]) != sorted(runs["plain"]):
                fail(f"heatmaps [{label}]: the two paths exported {sorted(runs['kernels'])}, {sorted(runs['plain'])}")
            for sid, want in runs["plain"].items():
                compare_attention(f"heatmaps [{label}] {sid}", [(
                    "scores", torch.from_numpy(runs["kernels"][sid]), torch.from_numpy(want))], 1e-4)
    return {"launches": counted}


# ---- phase 12: the 16,384 and 32,768 buckets -------------------------------------

STRESS_N = 32768  # the largest bucket of data/bucketing.DEFAULT_BUCKETS
STRESS_K3 = (("n32769", 32769, False), ("n32769_ragged", 32769, True), ("n16385", 16385, False))  # cls + bag


def phase_stress(gen) -> dict:
    """Phase 12: the flagship at the 32,768 bucket and K3 at 16,385 and
    32,769 tokens. (b) Batch-1 ``forward_test`` on a full bag of 32,768
    (K1 and K2 over 32,769 tokens), the kernel path against the plain path
    in fp32 at phase 4's 1e-3·max(1, max|ref|); (a) one fp32 flagship step
    on ``tools/stress_30k.py``'s ragged 2 × 32,768 batch, kernel path
    against plain path at phase 5's tolerances (:func:`flagship_step_pair`),
    then 3 bf16 steps with finite losses and their peak memory; (c) K3 alone
    (:func:`k3_long`) at B 2, H 8, N 32,769, full and ragged (16,385-32,769
    valid), and at N 16,385 full. The fp64 plain path's peak is reckoned
    before (c) and the run fails first if the card lacks the room."""
    from mhim_mil_torch.tools.bench import flagship_config
    from mhim_mil_torch.tools.stress_30k import BATCH, stress_inputs

    cfg = flagship_config([f"--batch_size={BATCH}"]).replace(compute_dtype="float32")
    _, model_k, model_p = config_models(cfg, "tools/stress_30k.py", 12)
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).cuda() for k, v in stress_inputs(BATCH, STRESS_N, cfg.input_dim).items()}
    lengths = batch["mask"].sum(dim=1).tolist()
    log(f"stress batch {BATCH} x {STRESS_N} x {cfg.input_dim}, lengths {lengths} (tools/stress_30k.py's draw), "
        f"made in {time.perf_counter() - t0:.1f} s")
    full = torch.ones_like(batch["mask"][:1])
    reset_launches()
    logits_k = model_k.forward_test(batch["feats"][:1], full)["logits"]
    torch.cuda.synchronize()
    counted_eval = expect_launches("stress forward_test", K1=2, K2=2, K3p=2 * 24)
    reset_launches()
    logits_p = model_p.forward_test(batch["feats"][:1], full)["logits"]
    torch.cuda.synchronize()
    expect_launches("the plain-path stress forward_test")
    compare_models(f"stress forward_test 1 x {STRESS_N}", (("logits", logits_k, logits_p),), 1e-3)
    spe = 8
    state_k, state_p, m_k, _, counted = flagship_step_pair("stress", cfg, model_k, model_p, batch, spe)
    del state_p, model_p
    torch.cuda.empty_cache()
    r = bf16_steps("stress", cfg, state_k, batch, spe, steps=3, **TRAIN_LAUNCHES)
    bf16_counted = r["counted"]
    flagship = {"lengths": lengths, "fp32_loss": float(m_k["loss"]), "fp32_peak_gib": m_k["peak_gib"],
                "bf16_ms_per_step": r["ms"], "bf16_peak_gib": r["peak_gib"], "keep_num": float(m_k["keep_num"])}
    del state_k, model_k, batch, r
    torch.cuda.empty_cache()

    rows = {}
    for label, n, ragged in STRESS_K3:
        b, h, m = BATCH, 8, 256
        one = b * h * n * m * 8  # one [B,H,N,m] fp64 tensor
        free, total = torch.cuda.mem_get_info()
        log(f"K3 [{label}] reckoning: the fp64 plain path holds [B,H,N,m] = [{b},{h},{n},{m}] tensors of "
            f"{one / 2 ** 30:.2f} GiB (sim1, attn1, sim3, attn3, their softmax temporaries and gradients: about 12, "
            f"{12 * one / 2 ** 30:.1f} GiB), the fp32 paths half that; {free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} "
            f"GiB free")
        if 18 * one > free:
            fail(f"K3 [{label}]: the card lacks the room for the fp64 plain path")
        rows[label] = k3_long(gen, label, ragged, b=b, n=n)
    return {"launches": [counted_eval, counted, bf16_counted], "stress": {"flagship": flagship, "K3": rows}}


# ---- phase 13: the ablate= variants, the in-step breakdown and the HBM ceiling ------

ABLATE = (None, "no_teacher", "fwd_only", "no_opt_ema", "no_ema")
PEAK_BYTES_SLACK = 1.05  # a streaming probe above this share of the data sheet's rate is a wrong reading
PROFILER_SLACK = 1.05  # a step's device-busy ms may exceed the host ms of the same steps by this factor


def unchanged(model, w0) -> bool:
    return all(torch.equal(p, q) for p, q in zip(model.parameters(), w0))


def phase_ablate_variants(gen) -> tuple:
    """Phase 13a: the flagship step and its four ``ablate`` variants in fp32
    on phase 5's ragged batch, each from copies of the same models, the
    kernel path against the plain path at phase 5's tolerances with its
    launches (:func:`flagship_step_pair`), and each variant's own
    invariants."""
    cfg, model_k, model_p = flagship_models(13, compute_dtype="float32")
    batch = train_batch(gen, cfg)
    spe = 8
    w0 = [p.detach().clone() for p in model_k.parameters()]
    q0 = model_k.merge.global_q_mm.clone()
    counted, rows, full = [], {}, None
    for ablate in ABLATE:
        label = f"13a {ablate or 'full'}"
        state_k, state_p, m_k, m_p, c = flagship_step_pair(label, cfg, copy.deepcopy(model_k),
                                                           copy.deepcopy(model_p), batch, spe, ablate)
        counted.append(c)
        sk, lr, opt = state_k.model, float(state_k.optimizer.lr_schedule(0)), state_k.optimizer
        rows[ablate or "full"] = {k: float(m_k[k]) for k in ("loss", "grad_rel_err", "param_err", "teacher_err",
                                                              "global_q_err")}
        if ablate in ("fwd_only", "no_opt_ema"):
            if not (unchanged(sk, w0) and unchanged(state_k.teacher, w0)) or opt.opt.state or opt.count:
                fail(f"{label}: the parameters, the teacher or the Adam moments moved")
        if ablate == "fwd_only" and torch.equal(sk.merge.global_q_mm, q0):
            fail(f"{label}: global_q did not move")
        if ablate == "no_opt_ema":
            gk, gp = float(m_k["gnorm"]), float(m_p["gnorm"])
            rows["no_opt_ema"].update(gnorm=gk, gnorm_plain=gp)
            log(f"{label}: gnorm {gk:.6g}, plain {gp:.6g} (1e-3 relative)")
            if any(p.grad is None for p in sk.parameters()) or not math.isfinite(gk) or abs(gk - gp) > 1e-3 * gp:
                fail(f"{label}: a parameter has no gradient, or gnorm is not finite or disagrees")
        if ablate is None:
            full = [p.detach().clone() for p in sk.parameters()]
        if ablate == "no_ema":
            e = max((p - q).abs().max().item() for p, q in zip(sk.parameters(), full))
            rows["no_ema"]["param_err_vs_full"] = e
            log(f"{label}: params against the full step's {e:.3e} (2·lr), the teacher unchanged: "
                f"{unchanged(state_k.teacher, w0)}")
            if e > 2 * lr or not unchanged(state_k.teacher, w0):
                fail(f"{label}: the update differs from the full step's, or the teacher moved")
        del state_k, state_p
    return counted, rows


def phase_ablate(gen) -> dict:
    """Phase 13: (a) :func:`phase_ablate_variants`; (b) the tools at full
    width in bf16: ``roofline.measure_hbm_ceiling`` (1 GiB) and
    ``step_breakdown.run`` on ``tools/bench.py``'s flagship (kernels on),
    with its launches (each variant's, :func:`steps_taken` steps each). It
    fails if a probe reads 0 or above 1.05 × the data sheet, a variant's
    device-busy ms exceeds the host ms of the same steps by more than 5%, or
    a timing is not finite. The component differences are printed, not
    gated: on a host-bound step they are noisy."""
    from mhim_mil_torch.tools import roofline, step_breakdown
    from mhim_mil_torch.tools.bench import flagship_config

    t0 = time.perf_counter()
    counted, rows = phase_ablate_variants(gen)
    log(f"phase 13a: {time.perf_counter() - t0:.1f} s")
    smi = card()
    dev = torch.device("cuda")
    hbm = roofline.measure_hbm_ceiling(dev)
    spec = hbm["spec_gb_s"]
    for name, rate in hbm["gb_s"].items():
        log(f"13b HBM {name}: {rate:.1f} GB/s over {hbm['nbytes'] / 2 ** 30:.0f} GiB, {rate / spec:.3f} of the data "
            f"sheet's {spec:.0f} GB/s ({smi})")
        if not math.isfinite(rate) or rate <= 0 or rate > PEAK_BYTES_SLACK * spec:
            fail(f"the {name} probe read {rate} GB/s")
    cfg = flagship_config().replace(use_flash_attn=True)
    reset_launches()
    res = step_breakdown.run(cfg, dev, 10240, hbm=hbm)
    torch.cuda.synchronize()
    n = step_breakdown.steps_taken()
    want = {}
    for ablate in ABLATE:
        for kid, k in variant_launches(ablate).items():
            want[kid] = want.get(kid, 0) + n * k
    counted.append(expect_launches("the breakdown's steps", **want))
    comps, med = res["components_ms"], res["variant_ms"]
    busy, host = res["variant_device_busy_ms"], res["variant_profiled_host_ms"]
    log(f"13b breakdown, {cfg.compute_dtype}, 4 x 10240, warm {res['protocol']['warm']}, windows of "
        f"{res['protocol']['window']} x {res['protocol']['rounds']}: components (host clock) "
        + ", ".join(f"{k} {v:.3f}" for k, v in comps.items())
        + f" ms; sum {res['sum_check_ms']:.3f} against the full step's {res['full_step_ms']:.3f} ms ({smi})")
    log("13b components on the device-busy ms (profiler): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["device_components_ms"].items()) + " ms")
    for k in med:
        ranges = res["range_device_ms"].get(k)
        log(f"13b {k}: {med[k]:.3f} ms a step (windows {', '.join(f'{x:.3f}' for x in res['variant_windows_ms'][k])}); "
            f"profiled {host[k]:.3f} ms host, device busy {busy[k]:.3f} ms ({busy[k] / host[k]:.1%})"
            + ("" if ranges is None else "; device ms by range " + ", ".join(f"{r} {v:.3f}" for r, v in ranges.items())))
    for k, row in res["bytes_model"].items():
        if not k.startswith("_"):
            meas = "n/a" if row["measured_ms"] is None else f"{row['measured_ms']:.3f}"
            log(f"13b bytes floor {k}: {row['floor_mb']:.1f} MB, {row['floor_ms_at_measured_hbm']:.4f} ms at the "
                f"measured {hbm['ceiling_gb_s']:.0f} GB/s, {row['floor_ms_at_spec']:.4f} ms at {spec:.0f}; the "
                f"host-clock component {meas} ms")
    timings = (list(comps.values()) + list(res["device_components_ms"].values()) + list(med.values()) + [x for w in res["variant_windows_ms"].values() for x in w]
               + list(busy.values()) + list(host.values())
               + [v for r in res["range_device_ms"].values() for v in r.values()])
    if not all(v is not None and math.isfinite(v) for v in timings):
        fail(f"13b: a timing is not finite: {res}")
    for k in med:
        if busy[k] > PROFILER_SLACK * host[k] or (k != "null" and busy[k] <= 0):
            fail(f"13b {k}: device busy {busy[k]} ms against {host[k]} ms on the host clock")
    return {"launches": counted, "ablate": {"variants": rows, "hbm": hbm, "breakdown": res, "card": smi}}


# ---- phase 14: the serving export bundle ------------------------------------------

BUNDLE_BUCKETS = (1024, 4096, 10240)
BUNDLE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # × max(1, max|ref|): bundle against the live Scorer
BUNDLE_REPEATS = 20  # bf16 calls of 1 × 10,240 through each of the two, in turns
# a fresh process scores every bundle of the plan with the loader alone, and
# reports each program's load seconds and each request's launches
BUNDLE_LOADER = r"""
import json, sys, time
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from mhim_mil_torch.utils.serving import load_bundle
from mhim_mil_torch.ops import abmil_pool, nystrom_pinv, scan2d
from mhim_mil_torch.ops import flash_nystrom as fn

def counts():
    return {"K1": fn.pass_a.launches, "K2": fn.pass_b.launches, "K3p": nystrom_pinv.pinv_product.launches,
            "K4": abmil_pool.fused_abmil_pool.launches, "K5": scan2d.selective_scan_2d_fused.launches}

plan, res = json.load(open(sys.argv[1])), {}
for b in plan:
    bundle = load_bundle(b["path"])
    load_s = {}
    for n in bundle.buckets:
        t0 = time.perf_counter()
        bundle.program(n)
        load_s[n] = time.perf_counter() - t0
    rows = []
    for r in b["requests"]:
        mask = None if r["mask"] is None else np.load(r["mask"])
        before = counts()
        logits = bundle.score(np.load(r["feats"]), mask)["logits"]
        torch.cuda.synchronize()
        after = counts()
        np.save(r["out"], logits)
        rows.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
    res[b["label"]] = {"load_s": load_s, "launches": rows}
res["imported"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "mhim_mil_tpu")
                         or m.startswith("mhim_mil_torch.models"))
json.dump(res, open(sys.argv[2], "w"))
"""


def bundle_mixed_devices():
    """Each kernel's op refuses a CUDA call with one operand on the CPU:
    the dispatcher picks the CUDA kernel, which raises, and no plain
    version runs."""
    import mhim_mil_torch.utils.serving  # noqa: F401 (registers the ops)

    c, h = torch.ones(1, 1, 16, 16, device="cuda"), torch.ones(1, 1, 16, 16)
    m = torch.ones(1, 16, dtype=torch.bool, device="cuda")
    ops = torch.ops.mhim_mil_torch
    calls = {
        "pass_a": lambda: ops.pass_a(c, h, c, m),
        "pass_b": lambda: ops.pass_b(c, h, m, c, m, c, c, c[..., 0], c[..., 0]),
        "newton_schulz": lambda: ops.newton_schulz(c[0], h[0], 1, False),
        "abmil_pool": lambda: ops.abmil_pool(c[0], h[0, 0], m),
        "scan2d": lambda: ops.scan2d(c, c, h[0, 0], c, c, c[0, 0, 0]),
    }
    for name, call in calls.items():
        before = launches()
        try:
            call()
        except (ValueError, RuntimeError) as e:
            if launches() != before:
                fail(f"14: {name} launched on mixed devices")
            log(f"14: {name} with one operand on the CPU raises {type(e).__name__}: {str(e)[:90]}")
            continue
        fail(f"14: {name} ran with one operand on the CPU")


def export_bundle(label: str, cfg, model, family: str, out: str, buckets) -> dict:
    """``export_serving_bundle`` for ``cuda``, with each program's export
    seconds (``torch.export.export``'s own, timed by a shim) and MB."""
    from mhim_mil_torch.utils.serving import export_serving_bundle, program_name

    seconds, real = [], torch.export.export

    def timed_export(*a, **k):
        t0 = time.perf_counter()
        prog = real(*a, **k)
        seconds.append(time.perf_counter() - t0)
        return prog

    torch.export.export = timed_export
    try:
        t0 = time.perf_counter()
        manifest = export_serving_bundle(cfg, model, family, out, buckets=buckets)
        total = time.perf_counter() - t0
    finally:
        torch.export.export = real
    rows = {}
    for n, s in zip(buckets, seconds):
        mb = os.path.getsize(os.path.join(out, program_name(n, "cuda"))) / 2 ** 20
        rows[n] = {"export_s": s, "mb": mb}
        log(f"14 {label}: bucket {n} exported in {s:.2f} s (torch.export.export, host clock), {mb:.2f} MB")
    log(f"14 {label}: bundle of {len(buckets)} programs written in {total:.2f} s, manifest "
        f"{ {k: manifest[k] for k in ('family', 'buckets', 'platforms', 'compute_dtype', 'torch_version')} }")
    return rows


def bundle_requests(gen, tmp: str, case: str, input_dim: int, names) -> list:
    """The requests of phase 14's ``case`` on the host, each saved for the
    loader: ``(name, feats, mask or None, paths)``."""
    import numpy as np

    feats, mask = flagship_batch(gen, input_dim)
    made = {
        "4 x 10240 ragged": (feats, mask),
        "1 x 6000": (torch.randn(6000, input_dim, device="cuda", generator=gen), None),
        "1 x 3000": (torch.randn(3000, input_dim, device="cuda", generator=gen), None),
        "1 x 900": (torch.randn(900, input_dim, device="cuda", generator=gen), None),
        "3 x 4000 ragged": (torch.randn(3, 4000, input_dim, device="cuda", generator=gen),
                            torch.arange(4000, device="cuda")[None] < torch.tensor([[4000], [2500], [1200]],
                                                                                    device="cuda")),
    }
    out = []
    for i, name in enumerate(names):
        f, mk = (None if t is None else t.cpu().numpy() for t in made[name])
        paths = {"feats": os.path.join(tmp, f"{case}_req{i}_feats.npy"),
                 "mask": None if mk is None else os.path.join(tmp, f"{case}_req{i}_mask.npy")}
        np.save(paths["feats"], f)
        if mk is not None:
            np.save(paths["mask"], mk)
        out.append((name, f, mk, paths))
    return out


def phase_bundle(gen) -> dict:
    """Phase 14: the serving export bundle. (a) The flagship
    (``config/mhim_c16.yaml``, selfattn, random weights from a seed) exported
    for ``cuda`` at buckets 1,024, 4,096 and 10,240 in fp32 and in the
    config's bf16; (b) abmil (``feat_cls.yaml``, K4) and 2dmamba
    (``feat_surv.yaml`` + ``surv_blca``, K5 on the raster grid) at bucket
    10,240, in both. A fresh process loads every bundle with
    ``mhim_mil_torch.utils.serving`` alone (neither ``jax`` nor
    ``mhim_mil_torch.models`` imported) and scores the requests; each
    request's logits against the live ``Scorer``'s on the same model (fp32
    within 1e-4, bf16 within 1e-2, × max(1, max|ref|)) and its launches
    equal to the Scorer's and nonzero. (c) The bf16 flagship's 1 × 10,240
    p50 through the bundle and through the Scorer, in turns. Every op also
    refuses mixed devices."""
    import numpy as np

    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.models import build_model
    from mhim_mil_torch.utils.serving import Scorer, load_bundle

    bundle_mixed_devices()
    smi = card()
    cases = [  # label, cfg, buckets, requests, launches a request
        ("flagship", load_config(["-c", "config/mhim_c16.yaml"], input_dim=1024), BUNDLE_BUCKETS,
         ("4 x 10240 ragged", "1 x 3000", "1 x 900", "3 x 4000 ragged"), dict(K1=2, K2=2, K3p=2 * 24)),
        ("abmil", load_config(["-c", ZOO], model="abmil", input_dim=1024), (10240,),
         ("4 x 10240 ragged", "1 x 6000"), dict(K4=1)),
        ("2dmamba", load_config(["-c", "config/feat_surv.yaml"], model="2dmamba", datasets="surv_blca",
                                input_dim=1024), (10240,), ("4 x 10240 ragged", "1 x 6000"), dict(K5=1)),
    ]
    counted, report, plan, checks = [], {"card": smi, "exports": {}, "requests": []}, [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bundle_") as tmp:
        for seed, (name, cfg, buckets, names, per_request) in enumerate(cases):
            model, family = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(140 + seed))
            requests = bundle_requests(gen, tmp, name, cfg.input_dim, names)
            for dtype in ("float32", "bfloat16"):
                label = f"{name} {dtype}"
                cfg_d = cfg.replace(compute_dtype=dtype)
                path = os.path.join(tmp, label.replace(" ", "_"))
                report["exports"][label] = export_bundle(label, cfg_d, model, family, path, buckets)
                outs = [os.path.join(path, f"out{i}.npy") for i in range(len(requests))]
                plan.append({"label": label, "path": path, "requests": [
                    {**paths, "out": o} for (_, _, _, paths), o in zip(requests, outs)]})
                checks.append((label, cfg_d, model, family, buckets, requests, outs, per_request))
        with open(os.path.join(tmp, "plan.json"), "w") as f:
            json.dump(plan, f)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", BUNDLE_LOADER, os.path.join(tmp, "plan.json"),
                              os.path.join(tmp, "loaded.json")], cwd=os.path.dirname(os.path.abspath(__file__)),
                             env=env, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"14: the loader process failed:\n{res.stderr[-4000:]}")
        with open(os.path.join(tmp, "loaded.json")) as f:
            loaded = json.load(f)
        log(f"14: the loader process scored {len(plan)} bundles in {time.perf_counter() - t0:.2f} s (host clock, "
            f"process start and loads included)")
        if loaded["imported"]:
            fail(f"14: the loader imported {loaded['imported']}")
        log("14: the loader process imported neither jax nor mhim_mil_torch.models")
        for label, cfg_d, model, family, buckets, requests, outs, per_request in checks:
            log(f"14 {label}: program load seconds {loaded[label]['load_s']}")
            report["exports"][label] = {n: {**r, "load_s": loaded[label]["load_s"][str(n)]}
                                        for n, r in report["exports"][label].items()}
            scorer = Scorer(cfg_d, model, buckets, "cuda", family)
            tol = BUNDLE_TOL[cfg_d.compute_dtype]
            for (name, f, mk, _), out, seen in zip(requests, outs, loaded[label]["launches"]):
                reset_launches()
                want = scorer.score(f, mk)["logits"]
                torch.cuda.synchronize()
                ref = {k: v for k, v in launches().items() if v}
                got = np.load(out)
                err = float(np.abs(got - want).max()) if got.shape == want.shape else math.inf
                limit = tol * max(1.0, float(np.abs(want).max()))
                log(f"14 {label} [{name}]: bundle vs Scorer logits {got.shape} max|d| {err:.3e} (tolerance {limit:.3e}), "
                    f"launches bundle {seen}, Scorer {ref}")
                if not np.isfinite(got).all() or err > limit:
                    fail(f"14 {label} [{name}]: the bundle's logits disagree with the Scorer's")
                if seen != ref or ref != per_request:
                    fail(f"14 {label} [{name}]: launches bundle {seen}, Scorer {ref}, want {per_request}")
                counted += [seen, ref]
                report["requests"].append({"bundle": label, "request": name, "max_abs_err": err, "tolerance": limit,
                                           "launches": seen})
        # (c) the bf16 flagship, 1 × 10,240, through the bundle and the Scorer in turns
        label, cfg_d, model, family, buckets, requests, _, _ = checks[1]
        bundle, scorer = load_bundle(plan[1]["path"]), Scorer(cfg_d, model, buckets, "cuda", family)
        one = requests[0][1][:1]
        for fn in (bundle.score, scorer.score):  # warm-up
            fn(one)
        reset_launches()
        times = {"bundle": [], "scorer": []}
        for _ in range(BUNDLE_REPEATS):
            for key, fn in (("bundle", bundle.score), ("scorer", scorer.score)):
                t0 = time.perf_counter()
                fn(one)
                times[key].append((time.perf_counter() - t0) * 1e3)
        counted.append(expect_launches("14c", K1=2 * 2 * BUNDLE_REPEATS, K2=2 * 2 * BUNDLE_REPEATS,
                                       K3p=2 * 48 * BUNDLE_REPEATS))
    p50 = {k: statistics.median(v) for k, v in times.items()}
    log(f"14c {label} 1 x 10240: p50 bundle {p50['bundle']:.3f} ms, Scorer {p50['scorer']:.3f} ms (median of "
        f"{BUNDLE_REPEATS} each, in turns, host clock, H2D of the features and D2H of the logits included), {smi}")
    report["p50_ms"] = p50
    return {"launches": counted, "bundle": report}


DRIVER_ARGS = ["-c", "config/mhim_c16.yaml", "--datasets", "synth", "--input_dim", "1024", "--synth_bag_size",
               "10240", "--bucket_sizes", "10240", "--batch_size", "4", "--synth_n_slides", "24", "--cv_fold", "2",
               "--num_epoch", "2", "--max_epoch", "2", "--num_bootstrap", "50"]
ABMIL_ARGS = ["-c", "config/feat_cls.yaml", "--model", "abmil", "--datasets", "synth", "--input_dim", "1024",
              "--synth_bag_size", "10240", "--bucket_sizes", "10240", "--batch_size", "4", "--synth_n_slides", "24",
              "--cv_fold", "1", "--num_epoch", "2", "--max_epoch", "2", "--num_bootstrap", "50"]
CLAM_ARGS = ["-c", "config/feat_cls.yaml", "--model", "clam_sb", "--datasets", "synth", "--input_dim", "1024",
             "--synth_bag_size", "10240", "--bucket_sizes", "10240", "--batch_size", "4", "--synth_n_slides", "24",
             "--cv_fold", "1", "--num_epoch", "2", "--max_epoch", "2", "--num_bootstrap", "50",
             "--aux_alpha", "0.5", "--use_flash_attn", "true"]
MAMBAMIL_ARGS = ["-c", "config/feat_cls.yaml", "--model", "mambamil", "--mambamil_type", "BiMamba", "--datasets",
                 "synth", "--input_dim", "1024", "--synth_bag_size", "10240", "--bucket_sizes", "10240", "--batch_size",
                 "4", "--synth_n_slides", "24", "--cv_fold", "1", "--num_epoch", "2", "--max_epoch", "2",
                 "--num_bootstrap", "50", "--use_flash_attn", "true"]
MAMBA_ARGS = ["-c", "config/feat_surv.yaml", "--model", "2dmamba", "--datasets", "surv_synth", "--input_dim", "1024",
              "--synth_bag_size", "10240", "--bucket_sizes", "10240", "--batch_size", "4", "--synth_n_slides", "24",
              "--cv_fold", "1", "--num_epoch", "1", "--use_flash_attn", "true"]


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


class TeachersBuilt:
    """Records the teacher each fold of a driver run starts from: wraps
    ``driver._build_fold`` while the ``with`` block runs."""

    def __enter__(self):
        from mhim_mil_torch.engine import driver

        self.driver, self.real, self.teachers = driver, driver._build_fold, {}

        def build(cfg, train_slides, fold_seed, fold=0, device=None):
            out = self.real(cfg, train_slides, fold_seed, fold, device)
            self.teachers[fold] = {k: v.detach().clone() for k, v in out[2].teacher.state_dict().items()}
            return out

        driver._build_fold = build
        return self

    def __exit__(self, *exc):
        self.driver._build_fold = self.real


def phase_driver() -> dict:
    """Phase 8: the k-fold driver through its command line. One fold of
    abmil (``config/feat_cls.yaml``) with the kernel gate on auto, K4 in its
    evaluations; then the two-stage workflow: the teacher stage (``--model
    mhim_pure``), then the flagship with ``--teacher_init`` from its output
    directory, each fold's teacher its stage-1 best, bit for bit; then the
    reload of the flagship's bests; then 2dmamba survival; then one fold of
    clam_sb (no kernel; a finite test row and a nonzero instance loss in
    each epoch). Those name the kernels explicitly (one gate per script)."""
    from mhim_mil_torch.utils.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory(prefix="chip_smoke_driver_") as tmp:
        stage1, out = os.path.join(tmp, "mhim_pure"), os.path.join(tmp, "mhim")
        torch.cuda.reset_peak_memory_stats()
        res0, seen0, secs0 = drive("abmil", ABMIL_ARGS + ["--output_path", os.path.join(tmp, "abmil")])
        peak0 = torch.cuda.max_memory_allocated() / 2 ** 30
        gate = res0["kernel_gate"]
        log(f"driver [abmil] kernel gate: {gate['outcome']} in {gate['seconds']:.2f} s, K6 launched "
            f"{gate['probe_launches']} time(s) in its probe; {gate['detail']}")
        if gate["outcome"] != "enabled" or gate["probe_launches"] < 1:
            fail(f"driver: the kernel gate gave {gate}")
        log_folds("abmil", res0)
        log(f"driver [abmil] launches {seen0}; {secs0:.2f} s in all (host clock, data made, gate and checkpoints "
            f"included); peak device memory {peak0:.2f} GiB")
        if seen0["K4"] < 1:
            fail("driver [abmil]: K4 was not launched")
        finite_rows("abmil", res0, ("test",), "auc")

        torch.cuda.reset_peak_memory_stats()
        res1, seen1, secs1 = drive("teacher stage", DRIVER_ARGS + ["--model", "mhim_pure", "--use_flash_attn", "true",
                                                                   "--output_path", stage1])
        peak1 = torch.cuda.max_memory_allocated() / 2 ** 30
        log_folds("teacher stage", res1)
        log(f"driver [teacher stage] launches {seen1}; {secs1:.2f} s in all (host clock, data made and "
            f"checkpoints included); peak device memory {peak1:.2f} GiB")
        for kid in ("K1", "K2", "K3", "K3b", "K3p", "K1b", "K2b"):
            if seen1[kid] < 1:
                fail(f"driver [teacher stage]: {kid} was not launched")
        finite_rows("teacher stage", res1, ("test", "test_ema"), "auc")

        torch.cuda.reset_peak_memory_stats()
        with TeachersBuilt() as built:
            res, seen, secs = drive("flagship", DRIVER_ARGS + ["--use_flash_attn", "true", "--teacher_init", stage1,
                                                               "--output_path", out])
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        log_folds("flagship", res)
        log(f"driver [flagship] launches {seen}; {secs:.2f} s in all (host clock, data made and checkpoints "
            f"included); peak device memory {peak_gb:.2f} GiB")
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
            best = load_checkpoint(os.path.join(stage1, f"fold_{k}_model_best.ckpt"))["model"]
            teacher = built.teachers.get(k, {})
            same = sum(name in teacher and torch.equal(teacher[name].cpu(), w) for name, w in best.items())
            log(f"driver [flagship] fold {k}: its teacher at the start holds {same} of the {len(best)} tensors of "
                f"the teacher stage's best, bit for bit")
            if same != len(best):
                fail(f"driver [flagship] fold {k}: the teacher is not its stage-1 best")

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

        res4, seen4, secs4 = drive("clam_sb", CLAM_ARGS + ["--output_path", os.path.join(tmp, "clam")])
        log_folds("clam_sb", res4)
        finite_rows("clam_sb", res4, ("test",), "auc")
        aux = [h.get("aux_loss", 0.0) for h in res4["folds"][0]["history"]]
        log(f"driver [clam_sb] launches {seen4}; {secs4:.2f} s; instance loss (aux_loss) by epoch "
            f"{', '.join(f'{a:.4f}' for a in aux)}")
        if not all(math.isfinite(a) and a > 0 for a in aux):
            fail("driver [clam_sb]: the instance loss is not finite and nonzero in every epoch")
        if any(seen4.values()):
            fail(f"driver [clam_sb]: launched {seen4}, want no kernel")
        res5, seen5, secs5 = drive("mambamil", MAMBAMIL_ARGS + ["--output_path", os.path.join(tmp, "mambamil")])
        log_folds("mambamil", res5)
        finite_rows("mambamil", res5, ("test",), "auc")
        log(f"driver [mambamil] launches {seen5}; {secs5:.2f} s")
        if any(seen5.values()):
            fail(f"driver [mambamil]: launched {seen5}, want no kernel")
        runs = (res0, res1, res, res2, res3, res4, res5)
        probes = {"K6": sum(r["kernel_gate"]["probe_launches"] for r in runs)}
    return {"launches": [seen0, seen1, seen, seen2, seen3, seen4, seen5, probes],
            "seconds": secs0 + secs1 + secs + secs2 + secs3 + secs4 + secs5, "abmil": res0}


# ---- phase 15: feature extraction --------------------------------------------------


PARITY_PATCHES = 8
ENCODER_TOL = 1e-4  # × max(1, max|ref|): the card against the CPU, fp32, TF32 off
ENCODER_SEED = 150
# name, its published geometry, the port module at it, parity sizes, timed sizes, timed batch
ENCODER_CASES = (
    ("resnet50_trunc", "ResNet-50 to layer3 (torchvision)", lambda E: E.ResNetTrunc((3, 4, 6), "bottleneck"),
     (224,), (224, 256), 256),
    ("r18", "ResNet-18 to layer3 (torchvision)", lambda E: E.ResNetTrunc((2, 2, 2), "basic"), (224,), (224,), 256),
    ("uni_v1", "ViT-L/16, 1,024 wide, 24 blocks, LayerScale (timm)",
     lambda E: E.ViTEncoder(1024, 24, 16, 4.0, 16, True), (224, 256), (224,), 256),
    ("gigap", "ViT-giant/16, 1,536 wide, 40 blocks, 24 heads, mlp_ratio 4, LayerScale (timm)",
     lambda E: E.ViTEncoder(1536, 40, 24, 4.0, 16, True), (224,), (224,), 64),
    ("conch_v1", "CLIP ViT-B/16 visual tower, classic layout (open_clip)", lambda E: E.CLIPVisualTower(768, 12, 12, 16),
     (224,), (224,), 256),
    ("chief", "Swin-T, window 7, depths 2/2/6/2, heads 3/6/12/24, ConvStem (timm)", lambda E: E.SwinChief(),
     (224,), (224,), 256),
    ("sd_vae", "AutoencoderKL encoder, channels 128/256/512/512, 2 layers a block (diffusers)",
     lambda E: E.SDVAEEncoder((128, 256, 512, 512), 2, 4), (224,), (224,), 32),
)
RASTER_SIDE = 6144  # the synthetic slide's level 0, px
RASTER_PATCH = 256
MIN_PATCHES = 400


def set_tf32(convolutions: bool):
    """TF32 for cuDNN's convolutions on or off; matrix products stay fp32
    (PyTorch's defaults are convolutions on, products off)."""
    torch.backends.cudnn.allow_tf32 = convolutions
    torch.backends.cuda.matmul.allow_tf32 = False


def normalized_patches(gen, norm: str, b: int, size: int) -> torch.Tensor:
    """``b`` random uint8 RGB patches, normalised as ``extract_features``
    normalises them, NCHW on the CPU."""
    from mhim_mil_torch.preprocess.extract import NORM_CONSTANTS

    mean, std = (torch.tensor(c) for c in NORM_CONSTANTS[norm])
    u = torch.randint(0, 256, (b, size, size, 3), generator=gen, dtype=torch.uint8)
    return ((u.float() / 255.0 - mean) / std).permute(0, 3, 1, 2).contiguous()


def gflops_a_patch(module, size: int) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        module(torch.zeros(1, 3, size, size, device="cuda"))
    return counter.get_total_flops() / 1e9


def encoder_speed(name: str, module, size: int, batch: int, smi: str) -> dict:
    """Patches a second of ``module`` alone on the card at ``size`` px,
    batch ``batch``, fp32: the median of 3 CUDA-event blocks of one batch
    each after a warm-up batch, with PyTorch's TF32 defaults and with TF32
    off; beside them its GFLOPs a patch and its peak memory above its weights."""
    x = torch.randn(batch, 3, size, size, device="cuda")
    r = {"size": size, "batch": batch, "gflops_a_patch": gflops_a_patch(module, size)}
    for label, conv_tf32 in (("defaults", True), ("tf32_off", False)):
        set_tf32(conv_tf32)
        with torch.inference_mode():
            ms = time_ms(lambda: module(x), iters=3, warmup=1)
            _, peak = peak_gib(lambda: module(x))
        r[label] = {"ms_a_batch": ms, "patches_per_s": batch / ms * 1e3,
                    "tflop_s": batch * r["gflops_a_patch"] / ms, "peak_gib": peak}
    set_tf32(False)
    log(f"15b {name} {size} px, batch {batch}: {r['gflops_a_patch']:.2f} GFLOP a patch; PyTorch's TF32 defaults "
        f"{r['defaults']['patches_per_s']:.1f} patches/s ({r['defaults']['ms_a_batch']:.2f} ms a batch, "
        f"{r['defaults']['tflop_s']:.1f} TFLOP/s), TF32 off {r['tf32_off']['patches_per_s']:.1f} patches/s "
        f"({r['tf32_off']['ms_a_batch']:.2f} ms, {r['tf32_off']['tflop_s']:.1f} TFLOP/s); peak "
        f"{r['defaults']['peak_gib']:.2f} / {r['tf32_off']['peak_gib']:.2f} GiB above the weights (CUDA events, "
        f"median of 3 batches), {smi}")
    return r


def phase_encoders(smi: str) -> dict:
    """Phase 15a and 15b: each encoder family at its published geometry,
    random weights from a seed written as an upstream-named ``state_dict``
    to a ``.pt`` and loaded through ``get_encoder(name, path)`` on the card
    and on the CPU; 8 patches on both (fp32, TF32 off: within 1e-4 ×
    max(1, max|ref|); with PyTorch's defaults: printed); then its
    patches a second alone on the card."""
    from mhim_mil_torch.preprocess import encoders as E

    gen = torch.Generator().manual_seed(ENCODER_SEED)
    out = {}
    for i, (name, geometry, make, parity_sizes, speed_sizes, batch) in enumerate(ENCODER_CASES):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_encoder_") as tmp:
            path = os.path.join(tmp, f"{name}.pt")
            t0 = time.perf_counter()
            source = E.random_init_(make(E), torch.Generator().manual_seed(ENCODER_SEED + i))
            params = sum(p.numel() for p in source.parameters())
            torch.save(source.state_dict(), path)
            del source
            made_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            on_cpu, norm = E.get_encoder(name, path, device="cpu")
            on_card, _ = E.get_encoder(name, path, device="cuda")
            load_s = time.perf_counter() - t0
        r = {"geometry": geometry, "params": params, "norm": norm, "parity": {}}
        log(f"15a {name}: {geometry}, {params / 1e6:.2f} M parameters; random weights from seed {ENCODER_SEED + i} "
            f"written to a .pt in {made_s:.1f} s, loaded through get_encoder on the CPU and the card in {load_s:.1f} s")
        for size in parity_sizes:
            x = normalized_patches(gen, norm, PARITY_PATCHES, size)
            with torch.inference_mode():
                ref = on_cpu(x)
                set_tf32(False)
                got = on_card(x.cuda()).cpu()
                set_tf32(True)
                got_defaults = on_card(x.cuda()).cpu()
                set_tf32(False)
            if got.shape != ref.shape or ref.shape[0] != PARITY_PATCHES:
                fail(f"15a {name} {size} px: card {tuple(got.shape)}, CPU {tuple(ref.shape)}")
            err = (got - ref).abs().max().item()
            err_defaults = (got_defaults - ref).abs().max().item()
            limit = ENCODER_TOL * max(1.0, ref.abs().max().item())
            log(f"15a {name} {size} px: [{PARITY_PATCHES}, {ref.shape[1]}] card vs CPU max|d| {err:.3e} with TF32 off "
                f"(tolerance {limit:.3e}); with PyTorch's defaults (cuDNN TF32) {err_defaults:.3e}; max|ref| "
                f"{ref.abs().max().item():.3f}")
            if not torch.isfinite(got).all() or err > limit:
                fail(f"15a {name} {size} px: the card disagrees with the CPU")
            r["parity"][size] = {"max_abs_err": err, "tolerance": limit, "max_abs_err_tf32_defaults": err_defaults}
        del on_cpu
        r["speed"] = {size: encoder_speed(name, on_card, size, batch, smi) for size in speed_sizes}
        del on_card
        torch.cuda.empty_cache()
        out[name] = r
    return out


def synthetic_raster(seed: int, side: int = RASTER_SIDE, cell: int = 16):
    """An RGB slide at level 0: tissue-like blobs (a union of ellipses drawn
    on a ``cell``-px grid, pink with purple nuclei) on a white background,
    with scanner-like noise; from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = side // cell
    yy, xx = np.mgrid[:n, :n] / n
    tissue = np.zeros((n, n), bool)
    for _ in range(12):
        cy, cx = rng.uniform(0.2, 0.8, 2)
        ry, rx = rng.uniform(0.18, 0.34, 2)
        tissue |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    img = np.full((side, side, 3), 242, np.uint8)
    full = np.repeat(np.repeat(tissue, cell, 0), cell, 1)
    img[full] = (214, 142, 188)
    img[full & (rng.random((side, side), dtype=np.float32) < 0.02)] = (118, 62, 150)
    img -= rng.integers(0, 16, img.shape, dtype=np.uint8)
    return img


_RASTER = []  # 15c's synthetic slide, made once a process: phase 16 reads it back from its files


def slide_raster():
    if not _RASTER:
        _RASTER.append(synthetic_raster(ENCODER_SEED))
    return _RASTER[0]


def write_sweep_weights(tmp: str) -> str:
    """15c's resnet50_trunc, random weights from ``ENCODER_SEED``, as a
    ``state_dict`` in upstream names at ``tmp/resnet50_trunc.pt``."""
    from mhim_mil_torch.preprocess import encoders as E

    path = os.path.join(tmp, "resnet50_trunc.pt")
    torch.save(E.random_init_(ENCODER_CASES[0][2](E), torch.Generator().manual_seed(ENCODER_SEED)).state_dict(), path)
    return path


def phase_extract(encoders: dict) -> dict:
    """Phase 15c, the slice end to end: a synthetic 6,144 × 6,144 RGB slide;
    ``segment_tissue`` on its thumbnail (the CLI's: at most 2,048 px a
    side); ``generate_patch_coords`` at 256/256; ``extract_features`` with
    ``resnet50_trunc`` on the card; ``save_feature_store`` (pt only); the
    port's ``FeatureBagStore``; the flagship ``Scorer`` in bf16 in the
    10,240 bucket (K1, K2, K3p). The store equals the features in memory
    bit for bit, the logits are finite and within 0.1 of the fp32 Scorer's."""
    import numpy as np

    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.data.readers import FeatureBagStore
    from mhim_mil_torch.models import build_model
    from mhim_mil_torch.preprocess import encoders as E
    from mhim_mil_torch.preprocess.extract import extract_features, save_feature_store
    from mhim_mil_torch.preprocess.segment import _connected_components, generate_patch_coords, segment_tissue
    from mhim_mil_torch.utils.serving import Scorer

    t0 = time.perf_counter()
    raster = slide_raster()
    make_s = time.perf_counter() - t0
    step = max(1, max(raster.shape[:2]) // 2048)
    thumb = raster[::step, ::step]
    t0 = time.perf_counter()
    mask = segment_tissue(thumb)
    seg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _connected_components(mask)
    cc_s = time.perf_counter() - t0
    grid = generate_patch_coords(mask, raster.shape[:2], RASTER_PATCH, RASTER_PATCH, 0.5)
    coords = grid["coords"]
    log(f"15c raster {raster.shape} made in {make_s:.1f} s; segment_tissue on the {thumb.shape[:2]} thumbnail "
        f"{seg_s:.2f} s host (tissue {mask.mean():.3f}); its Python connected components alone {cc_s:.2f} s; "
        f"{len(coords)} patches of {RASTER_PATCH} px")
    if len(coords) < MIN_PATCHES:
        fail(f"15c: {len(coords)} patches, want at least {MIN_PATCHES}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_encoder_") as tmp:
        encoder, norm = E.get_encoder("resnet50_trunc", write_sweep_weights(tmp), device="cuda")
    extract_features(encoder, raster, coords[:RASTER_PATCH], RASTER_PATCH, 256, norm)  # warm-up: cuDNN's plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = extract_features(encoder, raster, coords, RASTER_PATCH, 256, norm)
    sweep_s = time.perf_counter() - t0
    alone = encoders["resnet50_trunc"]["speed"][256]["tf32_off"]["patches_per_s"]
    rate = len(coords) / sweep_s
    log(f"15c extract_features resnet50_trunc: {feats.shape} in {sweep_s:.3f} s, {rate:.1f} patches/s end to end "
        f"(crop, pinned copy, normalisation and encoder; host clock, TF32 off) against {alone:.1f} for the encoder "
        f"alone (15b, batch 256, 256 px): {rate / alone:.2f} of it")
    if feats.shape != (len(coords), 1024) or not np.isfinite(feats).all():
        fail(f"15c: features {feats.shape}, finite {np.isfinite(feats).all()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        save_feature_store(tmp, "synthetic_slide", feats)
        store = FeatureBagStore(tmp)
        bag = store.load("synthetic_slide.pt")
    if store.files != ["synthetic_slide.pt"] or bag.dtype != feats.dtype or not np.array_equal(bag, feats):
        fail("15c: the store's features differ from the extracted ones")
    log(f"15c the store (pt_files only) read back through FeatureBagStore: {bag.shape}, equal bit for bit")

    cfg = load_config(["-c", "config/mhim_c16.yaml"], input_dim=1024)
    model, family = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(ENCODER_SEED + 10))
    scorer = Scorer(cfg, model, (10240,), "cuda", family)
    ref = Scorer(cfg.replace(compute_dtype="float32"), model, (10240,), "cuda", family).score(bag)["logits"]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits = scorer.score(bag)["logits"]
    torch.cuda.synchronize()
    score_ms = (time.perf_counter() - t0) * 1e3
    seen = expect_launches("15c the flagship Scorer", K1=2, K2=2, K3p=2 * 24)
    err = float(np.abs(logits - ref).max())
    log(f"15c flagship Scorer ({cfg.compute_dtype}, bucket 10240) on the extracted bag: logits {logits.tolist()} in "
        f"{score_ms:.2f} ms (host clock, the first call of this Scorer), launches {seen}; bf16 vs fp32 max|d| "
        f"{err:.3e} (tolerance 0.1)")
    if logits.shape != (cfg.n_classes,) or not np.isfinite(logits).all() or err > 0.1:
        fail(f"15c: the flagship's logits {logits} (fp32 {ref})")
    return {"launches": [seen], "extract": {
        "patches": len(coords), "segment_s": seg_s, "connected_components_s": cc_s, "sweep_s": sweep_s,
        "sweep_patches_per_s": rate, "encoder_alone_patches_per_s": alone, "score_ms": score_ms}}


def phase_features() -> dict:
    """Phase 15: feature extraction (15a parity, 15b speed, 15c the slice end to end)."""
    smi = card()
    encoders = phase_encoders(smi)
    res = phase_extract(encoders)
    res["encoders"] = encoders
    return res


# ---- phase 16: slides from the file ------------------------------------------------

SLIDE_LEVELS = 3
SLIDE_TILE = 256
LZW_SIDE = 1024  # the LZW file's crop: the writer's encoder is Python
SLIDE_READS = 64  # seeded level-0 reads a file
JPEG_SIDE = 2048  # the JPEG-coded formats' crop
JPEG_PSNR_DB = 30.0  # each JPEG-coded level against the raster at the writer's quality
OPTIONAL_PACKAGES = ("h5py", "matplotlib", "PIL")


def read_locations(side: int, seed: int):
    """``SLIDE_READS`` level-0 locations of 256² reads: corners and edges
    (partly outside the slide), off-tile offsets, the rest seeded."""
    import numpy as np

    fixed = [(0, 0), (side - 256, side - 256), (side - 100, 37), (13, side - 1), (side - 1, side - 1),
             (SLIDE_TILE - 1, SLIDE_TILE + 1), (side // 2 + 77, side // 3 + 129)]
    rng = np.random.default_rng(seed)
    return np.concatenate([np.asarray(fixed), rng.integers(0, side, (SLIDE_READS - len(fixed), 2))]).astype(np.int64)


def box_levels(img, levels: int) -> list:
    """The writers' pyramid: each level the 2 × 2 box mean of the one
    above, truncated to uint8."""
    out = [img]
    for _ in range(1, levels):
        prev = out[-1]
        h, w = prev.shape[0] // 2 * 2, prev.shape[1] // 2 * 2
        out.append(prev[:h, :w].reshape(h // 2, 2, w // 2, 2, 3).mean((1, 3)).astype("uint8"))
    return out


def psnr_db(a, b) -> float:
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def phase_slide_readers(raster, tmp: str) -> dict:
    """Phase 16a: the port's writer writes the raster as a 3-level pyramid of
    256-px tiles in deflate and raw, once as a BigTIFF (raw), and a
    1,024² crop in LZW; ``open_slide`` opens each (``PyramidalTiff``, the
    native codec built and used): every level's dimensions and downsample,
    and 64 seeded level-0 reads of 256² (edges, off-tile offsets) equal to
    the raster bit for bit; host ms a read on a freshly opened file (the
    file's pages warm in the host's cache) and ``get_thumbnail(2048)``'s
    seconds."""
    import numpy as np

    from mhim_mil_torch import native
    from mhim_mil_torch.preprocess.extract import crop_patches
    from mhim_mil_torch.preprocess.tiff import PyramidalTiff, open_slide, write_pyramidal_tiff

    if not native.have_native():
        fail("16a: the native LZW/PackBits codec did not build (cc, gcc) or load")
    lib = native.library_path()
    if lib.parent.name != "native" or lib.parent.parent.name != "build" or not lib.exists():
        fail(f"16a: the codec library is at {lib}, not under build/native/")
    log(f"16a native codec: {lib.relative_to(lib.parents[2])} built and loaded (have_native() true)")
    files = (("deflate", raster, dict(compression="deflate")), ("raw", raster, dict(compression="raw")),
             ("bigtiff raw", raster, dict(compression="raw", bigtiff=True)),
             ("lzw", raster[:LZW_SIDE, :LZW_SIDE], dict(compression="lzw")))
    out = {"native": str(lib.name), "files": {}}
    for label, img, kw in files:
        path = os.path.join(tmp, label.replace(" ", "_") + ".tif")
        t0 = time.perf_counter()
        write_pyramidal_tiff(path, img, levels=SLIDE_LEVELS, tile=SLIDE_TILE, **kw)
        write_s = time.perf_counter() - t0
        side = img.shape[0]
        slide = open_slide(path)
        if type(slide) is not PyramidalTiff:
            fail(f"16a {label}: open_slide gave {type(slide).__name__}")
        want_dims = [(side >> i, side >> i) for i in range(SLIDE_LEVELS)]
        if slide.level_dimensions != want_dims or list(slide.level_downsamples) != [2.0 ** i for i in range(SLIDE_LEVELS)]:
            fail(f"16a {label}: levels {slide.level_dimensions} {slide.level_downsamples}, want {want_dims}")
        locs = read_locations(side, ENCODER_SEED + len(out["files"]))
        want = crop_patches(img, locs, 256)
        t0 = time.perf_counter()
        got = [slide.read_region((int(x), int(y)), 0, (256, 256)) for x, y in locs]
        read_ms = (time.perf_counter() - t0) * 1e3 / len(locs)
        bad = [tuple(loc) for loc, g, w in zip(locs.tolist(), got, want) if not np.array_equal(g, w)]
        if bad:
            fail(f"16a {label}: level-0 reads differ from the raster at {bad[:5]} ({len(bad)} of {len(locs)})")
        for level in range(1, SLIDE_LEVELS):
            r = slide.read_region((0, 0), level, (256, 256))
            if r.shape != (256, 256, 3) or not r.any():
                fail(f"16a {label}: level {level} read {r.shape}, any {r.any()}")
        slide.close()
        slide = open_slide(path)
        t0 = time.perf_counter()
        thumb = slide.get_thumbnail(2048)
        thumb_s = time.perf_counter() - t0
        slide.close()
        mb = os.path.getsize(path) / 2 ** 20
        log(f"16a {label}: {side}² in {SLIDE_LEVELS} levels of {SLIDE_TILE}-px tiles, {mb:.1f} MB written in "
            f"{write_s:.2f} s; {len(locs)} level-0 reads of 256² equal to the raster bit for bit, {read_ms:.3f} host ms "
            f"a read (a freshly opened file, its pages warm in the host's cache); get_thumbnail(2048) "
            f"{thumb.shape[:2]} in {thumb_s:.3f} s")
        out["files"][label] = {"side": side, "mb": mb, "write_s": write_s, "read_ms": read_ms, "thumbnail_s": thumb_s,
                               "path": path}
    return out


def phase_slide_sweep(raster, tmp: str, path: str, encoders) -> dict:
    """Phase 16b: the CLI's steps on the deflate file: ``get_thumbnail(2048)``,
    ``segment_tissue``, ``generate_patch_coords`` at 256/256, then
    ``extract_features`` with ``slide_patch_reader`` on the card (TF32 off)
    against the in-memory sweep of the same coordinates (``crop_patches`` of
    the raster, the same batch): equal bit for bit; then
    ``tools.extract_features.main`` on a directory holding the file: its
    ``pt`` equals those features (its ``h5`` needs h5py)."""
    import importlib.util

    import numpy as np

    from mhim_mil_torch.preprocess import encoders as E
    from mhim_mil_torch.preprocess.extract import extract_features, slide_patch_reader
    from mhim_mil_torch.preprocess.segment import generate_patch_coords, segment_tissue
    from mhim_mil_torch.preprocess.tiff import open_slide
    from mhim_mil_torch.tools import extract_features as cli

    set_tf32(False)
    weights = write_sweep_weights(tmp)
    encoder, norm = E.get_encoder("resnet50_trunc", weights, device="cuda")
    slide = open_slide(path)
    t0 = time.perf_counter()
    thumb = slide.get_thumbnail(2048)
    thumb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mask = segment_tissue(thumb)
    seg_s = time.perf_counter() - t0
    w0, h0 = slide.dimensions
    coords = generate_patch_coords(mask, (h0, w0), RASTER_PATCH, RASTER_PATCH, 0.5)["coords"]
    if len(coords) < MIN_PATCHES:
        fail(f"16b: {len(coords)} patches, want at least {MIN_PATCHES}")
    extract_features(encoder, raster, coords[:RASTER_PATCH], RASTER_PATCH, 256, norm)  # warm-up: cuDNN's plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from_file = extract_features(encoder, slide_patch_reader(slide, RASTER_PATCH), coords, RASTER_PATCH, 256, norm)
    file_s = time.perf_counter() - t0
    slide.close()
    t0 = time.perf_counter()
    in_memory = extract_features(encoder, raster, coords, RASTER_PATCH, 256, norm)
    memory_s = time.perf_counter() - t0
    if from_file.shape != (len(coords), 1024) or not np.array_equal(from_file, in_memory):
        fail(f"16b: the sweep from the file {from_file.shape} differs from the in-memory sweep {in_memory.shape}")
    alone = encoders["resnet50_trunc"]["speed"][256]["tf32_off"]["patches_per_s"] if encoders else None
    rate, rate_memory = len(coords) / file_s, len(coords) / memory_s
    log(f"16b thumbnail {thumb.shape[:2]} in {thumb_s:.3f} s, segment_tissue {seg_s:.2f} s host (tissue "
        f"{mask.mean():.3f}), {len(coords)} patches of {RASTER_PATCH} px; the sweep from the file {file_s:.3f} s "
        f"({rate:.1f} patches/s end to end: tile decode, crop, pinned copy, normalisation, encoder; host clock, TF32 "
        f"off) against {rate_memory:.1f} in memory ({memory_s:.3f} s) and {alone if alone is None else f'{alone:.1f}'} "
        f"for the encoder alone (15b): {rate / rate_memory:.2f} of the in-memory sweep"
        + ("" if alone is None else f", {rate / alone:.2f} of the encoder alone") + "; features equal bit for bit")

    src, store = os.path.join(tmp, "slides"), os.path.join(tmp, "store")
    os.makedirs(src)
    os.symlink(path, os.path.join(src, "synthetic_slide.tif"))
    argv = ["--source", src, "--save_dir", store, "--encoder", "resnet50_trunc", "--ckpt_path", weights,
            "--patch_size", str(RASTER_PATCH), "--step_size", str(RASTER_PATCH), "--batch_size", "256",
            "--device", "cuda"]
    have_h5py = importlib.util.find_spec("h5py") is not None
    t0 = time.perf_counter()
    try:
        cli.main(argv)
    except ImportError as e:
        if have_h5py or "h5py" not in str(e):
            raise
        log(f"16b the CLI wrote pt_files and raised at h5_files, as it does without h5py: {e}")
    cli_s = time.perf_counter() - t0
    pt = torch.load(os.path.join(store, "pt_files", "synthetic_slide.pt"), weights_only=True).numpy()
    if not np.array_equal(pt, from_file):
        fail(f"16b: the CLI's pt {pt.shape} differs from the sweep's features {from_file.shape}")
    if have_h5py:
        import h5py

        with h5py.File(os.path.join(store, "h5_files", "synthetic_slide.h5")) as f:
            if not np.array_equal(f["coords"][:], coords):
                fail("16b: the CLI's h5 coordinates differ from the sweep's")
    log(f"16b tools.extract_features.main on the card: {cli_s:.2f} s (host clock: encoder load, thumbnail, "
        f"segmentation, sweep, store); its pt equals the sweep's features bit for bit"
        + ("; its h5 coordinates equal the grid" if have_h5py else ""))
    return {"patches": len(coords), "thumbnail_s": thumb_s, "segment_s": seg_s, "file_s": file_s,
            "memory_s": memory_s, "file_patches_per_s": rate, "memory_patches_per_s": rate_memory,
            "encoder_alone_patches_per_s": alone, "cli_s": cli_s, "store": store, "h5": have_h5py}


SLIDE_EXPORT = ["-c", "config/mhim_c16.yaml", "--model", "mhim", "--input_dim", "1024"]


def phase_slide_attention(store: str) -> dict:
    """Phase 16c: ``tools.export_attention`` with the flagship (random weights
    from the config's seed) on the store the CLI wrote, on the kernel path
    and on the plain path (``--use_flash_attn false``): the kernel path's
    launches (11c's, K1 2, K2 2, K3p 48 a slide), the scores within
    ``compare_attention`` of the plain path's at 1e-4, the ``_attn.npy`` grid
    the percentile raster of the scores."""
    import numpy as np

    from mhim_mil_torch.data.readers import FeatureBagStore
    from mhim_mil_torch.tools.export_attention import main as export
    from mhim_mil_torch.utils.heatmap import attention_to_grid

    per_slide = EXPORT_RUNS[0][2]  # mhim selfattn
    runs, seen, secs = {}, None, {}
    n = FeatureBagStore(store).load("synthetic_slide.pt").shape[0]
    for path, flash in (("kernels", "true"), ("plain", "false")):
        out = os.path.join(os.path.dirname(store), f"attn-{path}")
        reset_launches()
        t0 = time.perf_counter()
        runs[path] = export(["--out", out, "--dataset_root", store, "--use_flash_attn", flash, *SLIDE_EXPORT])
        torch.cuda.synchronize()
        secs[path] = time.perf_counter() - t0
        counted = expect_launches(f"16c export on the {path} path", **(per_slide if path == "kernels" else {}))
        if path == "kernels":
            seen = counted
        sc = runs[path]["synthetic_slide"]
        grid = np.load(os.path.join(out, "synthetic_slide_attn.npy"))
        if sc.shape != (n,) or not np.array_equal(grid, attention_to_grid(sc, FeatureBagStore(store).coords(
                "synthetic_slide.pt")), equal_nan=True):
            fail(f"16c {path} path: scores {sc.shape} for {n} patches, or the grid is not their percentile raster")
    compare_attention("16c export", [("scores", torch.from_numpy(runs["kernels"]["synthetic_slide"]),
                                      torch.from_numpy(runs["plain"]["synthetic_slide"]))], 1e-4)
    log(f"16c export_attention on the slide's bag ({n} tokens): kernel path {secs['kernels']:.2f} s, plain path "
        f"{secs['plain']:.2f} s (host clock, model built and files written); kernel path launches {seen}")
    return {"launches": [seen], "tokens": n, "kernels_s": secs["kernels"], "plain_s": secs["plain"]}


def phase_jpeg_slides(raster, tmp: str) -> dict:
    """Phase 16, the JPEG-coded formats (needs PIL): a 2,048² crop of the
    raster written by the port's writers as Aperio ``.svs``, ``.ndpi``,
    ``.mrxs``, ``.vms``, Philips TIFF, ``.scn`` and ``.bif``, opened through
    ``open_slide`` (the reader each routes to), every level read whole and
    held against the raster's box pyramid at the writer's quality: PSNR at
    least 30 dB on the overlap."""
    from mhim_mil_torch.preprocess import mirax, ndpi, tiff, vendor_tiff, vms

    y0, x0 = (raster.shape[0] - JPEG_SIDE) // 2, (raster.shape[1] - JPEG_SIDE) // 2
    crop = raster[y0:y0 + JPEG_SIDE, x0:x0 + JPEG_SIDE].copy()
    pyramid = box_levels(crop, 4)
    formats = (
        ("svs", "slide.svs", "PyramidalTiff", lambda p: tiff.write_aperio_svs(p, crop, levels=3, tile=256)),
        ("ndpi", "slide.ndpi", "NdpiSlide", lambda p: ndpi.write_ndpi(p, crop, levels=3)),
        ("mrxs", "slide.mrxs", "MiraxSlide", lambda p: mirax.write_mirax(p, crop, levels=3, tile=256, overlap=32)),
        ("vms", "slide.vms", "VmsSlide", lambda p: vms.write_vms(p, crop, cols=2, rows=2)),
        ("philips", "philips.tiff", "PhilipsTiff", lambda p: vendor_tiff.write_philips_tiff(p, crop, levels=3,
                                                                                            tile=256)),
        ("scn", "slide.scn", "LeicaScn", lambda p: vendor_tiff.write_leica_scn(p, crop, levels=3, tile=256)),
        ("bif", "slide.bif", "VentanaBif", lambda p: vendor_tiff.write_ventana_bif(p, crop, levels=3, tile=256)),
    )
    out = {}
    for label, name, reader, write in formats:
        d = os.path.join(tmp, f"jpeg-{label}")
        os.makedirs(d)
        path = os.path.join(d, name)
        t0 = time.perf_counter()
        write(path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        slide = tiff.open_slide(path)
        if type(slide).__name__ != reader:
            fail(f"16 jpeg {label}: open_slide gave {type(slide).__name__}, want {reader}")
        levels = []
        for level in range(slide.level_count):
            w, h = slide.level_dimensions[level]
            got = slide.read_region((0, 0), level, (w, h))
            ds = slide.level_downsamples[level]
            k = int(round(math.log2(ds)))
            if 2 ** k != ds or k >= len(pyramid):
                fail(f"16 jpeg {label}: level {level} downsample {ds}")
            ref = pyramid[k]
            hh, ww = min(h, ref.shape[0]), min(w, ref.shape[1])
            db = psnr_db(got[:hh, :ww], ref[:hh, :ww])
            levels.append({"dims": (w, h), "downsample": ds, "psnr_db": db})
            if not db >= JPEG_PSNR_DB:
                fail(f"16 jpeg {label}: level {level} {w}x{h} PSNR {db:.2f} dB against the raster, want "
                     f">= {JPEG_PSNR_DB}")
        assoc = sorted(slide.associated_images)
        slide.close()
        read_s = time.perf_counter() - t0
        log(f"16 jpeg {label}: {reader}, {len(levels)} levels "
            + ", ".join(f"{lv['dims'][0]}x{lv['dims'][1]} {lv['psnr_db']:.2f} dB" for lv in levels)
            + f"; associated {assoc}; written in {write_s:.2f} s, opened and every level read in {read_s:.2f} s")
        out[label] = {"reader": reader, "levels": levels, "associated": assoc, "write_s": write_s, "read_s": read_s}
    return out


def phase_overlays(store: str, slide_path: str) -> dict:
    """Phase 16, the overlays (needs h5py, matplotlib and PIL):
    ``export_attention --image_dir`` with ``--vis_level 1 --sample_rois
    topk`` on the store and the deflate file: the overlay has level 1's
    size and equals ``render_heatmap_pyramidal`` of the returned scores; the
    ROI CSV has ``roi_k`` rows."""
    import numpy as np
    from PIL import Image

    from mhim_mil_torch.data.readers import FeatureBagStore
    from mhim_mil_torch.preprocess.tiff import open_slide
    from mhim_mil_torch.tools.export_attention import main as export
    from mhim_mil_torch.utils.heatmap import render_heatmap_pyramidal

    images = os.path.join(os.path.dirname(store), "images")
    os.makedirs(images)
    os.symlink(slide_path, os.path.join(images, "synthetic_slide.tif"))
    out = os.path.join(os.path.dirname(store), "overlays")
    t0 = time.perf_counter()
    got = export(["--out", out, "--dataset_root", store, "--image_dir", images, "--patch_size", str(RASTER_PATCH),
                  "--vis_level", "1", "--sample_rois", "topk", "--roi_k", "5", *SLIDE_EXPORT])["synthetic_slide"]
    secs = time.perf_counter() - t0
    overlay = np.asarray(Image.open(os.path.join(out, "synthetic_slide_overlay.png")))
    slide = open_slide(slide_path)
    want = render_heatmap_pyramidal(slide, FeatureBagStore(store).pixel_coords("synthetic_slide.pt"), got,
                                    patch_size=RASTER_PATCH, vis_level=1)
    dims = slide.level_dimensions[1]
    slide.close()
    if overlay.shape != (dims[1], dims[0], 3) or not np.array_equal(overlay, want):
        fail(f"16 overlays: the overlay {overlay.shape} is not render_heatmap_pyramidal's at level 1 {dims}")
    with open(os.path.join(out, "synthetic_slide_rois.csv")) as f:
        rows = f.read().splitlines()
    if rows[0] != "x,y,score" or len(rows) != 1 + 5:
        fail(f"16 overlays: the ROI CSV has {len(rows) - 1} rows, want 5")
    log(f"16 overlays: --image_dir at level 1 {overlay.shape[:2]} in {secs:.2f} s, equal to render_heatmap_pyramidal; "
        f"{len(rows) - 1} ROIs")
    return {"overlay": overlay.shape, "seconds": secs}


def phase_slides(encoders=None) -> dict:
    """Phase 16: the slide readers behind the extraction CLI and the
    attention export, on 15c's synthetic slide and its resnet50_trunc: 16a
    the readers, 16b the sweep from the file and the CLI, 16c the flagship's
    attention on the bag; then each part that needs a package the card's
    machine may lack, where it has it: the JPEG-coded formats (PIL) and the
    overlays (h5py, matplotlib, PIL)."""
    import importlib.util

    missing = {p: importlib.util.find_spec(p) is None for p in OPTIONAL_PACKAGES}
    raster = slide_raster()
    res = {"launches": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slides_") as tmp:
        t0 = time.perf_counter()
        res["readers"] = phase_slide_readers(raster, tmp)
        res["readers_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["sweep"] = phase_slide_sweep(raster, tmp, res["readers"]["files"]["deflate"]["path"], encoders)
        res["sweep_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        attention = phase_slide_attention(res["sweep"]["store"])
        res["attention_s"] = time.perf_counter() - t0
        res["launches"] += attention.pop("launches")
        res["attention"] = attention
        ran, skipped = ["16a readers", "16b sweep and CLI", "16c attention"], []
        if not res["sweep"]["h5"]:
            skipped.append("the CLI's h5_files (h5py)")
        t0 = time.perf_counter()
        if missing["PIL"]:
            skipped.append("JPEG-coded formats (PIL)")
        else:
            res["jpeg"] = phase_jpeg_slides(raster, tmp)
            ran.append("JPEG-coded formats")
        res["jpeg_s"] = time.perf_counter() - t0
        lacks = [p for p in OPTIONAL_PACKAGES if missing[p]]
        if lacks:
            skipped.append(f"overlays ({', '.join(lacks)})")
        else:
            res["overlays"] = phase_overlays(res["sweep"]["store"], res["readers"]["files"]["deflate"]["path"])
            ran.append("overlays")
    res["parts"] = {"ran": ran, "skipped": skipped}
    log(f"16 parts ran: {', '.join(ran)}; not run, for a missing package: {', '.join(skipped) or 'none'}")
    return res


# ---- phase 17: data parallelism over bags ------------------------------------------------

DP_WORLD = 2  # processes of 17c, sharing the one card
DP_BF16_STEPS = 3
DP_FWD_LAUNCHES = dict(K1=2, K2=2, K3p=2 * 24)  # the flagship's forward_test: two TransLayers
DP_TIMEOUT_S = 300


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_processes(flag: str, world: int, timeout: float, phase: str, tmp: str) -> list:
    """Start ``world`` processes of this script as the ranks of ``phase``
    (``python3 chip_smoke.py <flag> <rank> <tmp> <port>``) and return each
    rank's results, ``tmp/rank<rank>.pt``; fails, and kills the ranks left,
    when one exits nonzero or outlasts ``timeout`` seconds."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r), tmp, str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                text, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                fail(f"{phase} rank {r} did not finish in {timeout} s")
            if p.returncode != 0:
                fail(f"{phase} rank {r} exited {p.returncode}:\n{text[-3000:]}")
            outs.append(torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def dp_flagship(seed: int):
    """The fp32 flagship on the kernel path with its batch's inputs: the
    config, the model, its initial weights on the host and the 4 × 10,240
    batch (dropout on, as the preset sets it)."""
    cfg, model, model_p = flagship_models(seed, compute_dtype="float32")
    del model_p
    return cfg, model, {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def dp_state(cfg, model, spe: int):
    from mhim_mil_torch.engine.train_state import create_mhim_state

    return create_mhim_state(cfg, model, spe, seed=0, device="cuda")


def dp_abmil_flags(ref: dict) -> dict:
    """17a, fault 13: phase 8's one-fold abmil run with ``--mesh_dp 4
    --mesh_sp 2`` in this one process equals the run without them (phase
    8's ``ref``, or a run made here) bit for bit in every row. The kernels
    are named on, as phase 8's gate turned them on, so that the gate's
    subprocesses do not run twice."""
    args = ABMIL_ARGS + ["--use_flash_attn", "true", "--output_path", ""]
    res, seen, secs = drive("abmil --mesh_dp 4 --mesh_sp 2", args + ["--mesh_dp", "4", "--mesh_sp", "2"])
    if ref is None:
        ref, _, _ = drive("abmil", args)
    elif ref["kernel_gate"]["outcome"] != "enabled":
        fail(f"17a: phase 8's gate gave {ref['kernel_gate']}")
    rows = 0
    for f_ref, f in zip(ref["folds"], res["folds"]):
        pairs = [("test", f_ref["test"], f["test"])]
        pairs += [(f"epoch {a['epoch']} val", a["val"], b["val"]) for a, b in zip(f_ref["history"], f["history"])]
        pairs += [(f"epoch {a['epoch']} train_loss", a["train_loss"], b["train_loss"])
                  for a, b in zip(f_ref["history"], f["history"])]
        for name, a, b in pairs:
            rows += 1
            if a != b:
                fail(f"17a fold {f['fold']} {name}: with the mesh flags {b}, without {a}")
    if len(res["folds"]) != len(ref["folds"]) or not rows:
        fail("17a: the runs have other folds")
    log(f"17a fault 13: one process with --mesh_dp 4 --mesh_sp 2 trained; {rows} rows (test, each epoch's val and "
        f"train_loss) equal to the run without the flags bit for bit; launches {seen}; {secs:.2f} s")
    return {"launches": seen, "rows": rows, "seconds": secs}


def dp_world_of_one(gen, spe: int) -> dict:
    """17b: one fp32 flagship step in an NCCL world of one process under
    ``make_mesh(dp=1)`` against the same step without a mesh, from the same
    weights and generator seed: loss, metrics, every parameter and
    gradient, the teacher and global_q_mm bit for bit, with the same
    launches. Returns the no-mesh step's results, the reference of 17c."""
    import torch.distributed as dist

    from mhim_mil_torch.parallel import make_mesh, replicate_tree

    cfg, model_a, init = dp_flagship(17)
    model_b = copy.deepcopy(model_a)
    batch = train_batch(gen, cfg)
    with torch.no_grad():
        ref_logits = model_b.forward_test(batch["feats"], batch["mask"])["logits"].float()
    state_a, state_b = dp_state(cfg, model_a, spe), dp_state(cfg, model_b, spe)
    step = train_step_for(cfg, spe)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        reset_launches()
        with make_mesh(dp=1) as mesh:
            replicate_tree(mesh, state_a)
            m_a = step(state_a, batch)
        torch.cuda.synchronize()
        seen_a = expect_launches("17b the step under make_mesh(dp=1)", **TRAIN_LAUNCHES)
    finally:
        dist.destroy_process_group()
    reset_launches()
    m_b = step(state_b, batch)
    torch.cuda.synchronize()
    expect_launches("17b the step without a mesh", **TRAIN_LAUNCHES)
    diffs = [k for k in m_b if float(m_a[k]) != float(m_b[k])]
    for name, a, b in (("student", model_a, model_b), ("teacher", state_a.teacher, state_b.teacher)):
        sa, sb = a.state_dict(), b.state_dict()
        diffs += [f"{name} {k}" for k in sb if not torch.equal(sa[k], sb[k])]
    diffs += [f"gradient {n}" for (n, p), q in zip(model_a.named_parameters(), model_b.parameters())
              if not torch.equal(p.grad, q.grad)]
    log(f"17b NCCL world of one: the fp32 flagship step under make_mesh(dp=1) against the step without a mesh: "
        f"loss {float(m_a['loss']):.9g} and {float(m_b['loss']):.9g}; {len(m_b)} metrics, "
        f"{len(model_b.state_dict())} student and {len(state_b.teacher.state_dict())} teacher tensors (global_q_mm "
        f"among them) and {sum(1 for _ in model_b.parameters())} gradients compared; {len(diffs)} differ; "
        f"launches {seen_a} each")
    if diffs:
        fail(f"17b: the dp=1 mesh step differs from the step without a mesh: {diffs[:8]}")
    ref = {"cfg": cfg, "init": init, "batch": {k: v.cpu() for k, v in batch.items()}, "metrics": m_b,
           "model": model_b, "teacher": state_b.teacher, "logits": ref_logits,
           "lr": float(state_b.optimizer.lr_schedule(0))}
    return {"launches": seen_a, "ref": ref}


def dp_worker(rank: int, tmp: str, port: int):
    """One rank of 17c, in a process of its own: a gloo world of DP_WORLD
    processes on the one card; the flagship's forward_test and one fp32 step
    on this rank's bags, then DP_BF16_STEPS bf16 steps; writes its results
    to ``tmp/rank<rank>.pt``."""
    import datetime

    import torch.distributed as dist

    from mhim_mil_torch.models import build_model
    from mhim_mil_torch.parallel import make_mesh, replicate_tree
    from mhim_mil_torch.parallel.mesh import gather_rows

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1 sets them in the parent
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    cfg, spe = inputs["cfg"], inputs["spe"]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=DP_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    model, _ = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(inputs["init"])
    state = dp_state(cfg, model, spe)
    mesh = make_mesh(DP_WORLD)
    rows = mesh.rows(inputs["batch"]["feats"].shape[0])
    batch = {k: v[rows].to("cuda") for k, v in inputs["batch"].items()}
    replicate_tree(mesh, state)
    out = {"rank": rank, "bags": rows.stop - rows.start}
    with mesh:
        reset_launches()
        with torch.no_grad():
            logits = gather_rows(model.forward_test(batch["feats"], batch["mask"])["logits"].float())
        torch.cuda.synchronize()
        out["fwd_launches"] = expect_launches(f"17c rank {rank} forward_test", **DP_FWD_LAUNCHES)
        step = train_step_for(cfg, spe)
        reset_launches()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        out["fp32_ms"] = (time.perf_counter() - t0) * 1e3
        out["fp32_launches"] = expect_launches(f"17c rank {rank} fp32 step", **TRAIN_LAUNCHES)
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["grad_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
        if rank == 0:
            out["logits"] = logits.cpu()
            out["student"] = {k: v.cpu() for k, v in model.state_dict().items()}
            out["teacher"] = {k: v.cpu() for k, v in state.teacher.state_dict().items()}
            out["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        step16 = train_step_for(cfg.replace(compute_dtype="bfloat16"), spe)
        reset_launches()
        out["bf16_ms"], out["bf16_losses"] = [], []
        for _ in range(DP_BF16_STEPS):
            t0 = time.perf_counter()
            m16 = step16(state, batch)
            torch.cuda.synchronize()
            out["bf16_ms"].append((time.perf_counter() - t0) * 1e3)
            out["bf16_losses"].append(float(m16["loss"]))
        out["bf16_launches"] = expect_launches(f"17c rank {rank} bf16 steps",
                                               **{k: v * DP_BF16_STEPS for k, v in TRAIN_LAUNCHES.items()})
    out["grad_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def dp_two_processes(ref: dict, spe: int) -> dict:
    """17c: DP_WORLD processes of this script share the card in a gloo
    world (NCCL takes one rank a device), each with 2 of 17b's 4 bags: the
    fp32 step against 17b's one-process step (loss rtol 2e-5, keep_num and
    patch_num equal, gradients after the all-reduce within 1e-4 of
    max|g|, student, teacher and global_q_mm within 2·lr), forward_test's
    gathered logits within 1e-4·max|ref|, DP_BF16_STEPS bf16 steps with
    finite losses; each rank's launches, the gradient all-reduce's bytes
    and each rank's step ms."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        torch.save({"cfg": ref["cfg"], "spe": spe, "init": ref["init"], "batch": ref["batch"]},
                   os.path.join(tmp, "inputs.pt"))
        outs = rank_processes("--dp-rank", DP_WORLD, DP_TIMEOUT_S, "17c", tmp)
    r0, lr, m_ref = outs[0], ref["lr"], ref["metrics"]
    d_loss = abs(r0["metrics"]["loss"] - float(m_ref["loss"]))
    g_err = max(((r0["grads"][n] - p.grad.cpu()).abs().max() / p.grad.abs().max().clamp_min(1e-30).cpu()).item()
                for n, p in ref["model"].named_parameters())
    s_ref = {k: v.cpu() for k, v in ref["model"].state_dict().items()}
    p_err = max((r0["student"][k] - v).abs().max().item() for k, v in s_ref.items() if k != "merge.global_q_mm")
    q_err = (r0["student"]["merge.global_q_mm"] - s_ref["merge.global_q_mm"]).abs().max().item()
    t_ref = {k: v.cpu() for k, v in ref["teacher"].state_dict().items()}
    t_err = max((r0["teacher"][k] - v).abs().max().item() for k, v in t_ref.items() if k != "merge.global_q_mm")
    l_ref = ref["logits"].cpu()
    l_err = (r0["logits"] - l_ref).abs().max().item()
    l_tol = 1e-4 * l_ref.abs().max().item()
    same = {k: r0["metrics"][k] == float(m_ref[k]) for k in ("keep_num", "patch_num")}
    log(f"17c {DP_WORLD} processes sharing the one card (gloo), {r0['bags']} of the 4 bags each, against 17b's "
        f"one-process step: loss {r0['metrics']['loss']:.9g} against {float(m_ref['loss']):.9g}, |d| {d_loss:.3e} "
        f"(tolerance 2e-5 * |loss|); keep_num and patch_num equal {same}; gradients after the all-reduce "
        f"max|d|/max|ref| {g_err:.3e} (tolerance 1e-4); student max|d| {p_err:.3e}, teacher {t_err:.3e}, global_q_mm "
        f"{q_err:.3e} (tolerance 2·lr = {2 * lr:.3e}); forward_test logits max|d| {l_err:.3e} (tolerance 1e-4 * "
        f"max|ref| = {l_tol:.3e})")
    if not math.isfinite(d_loss) or d_loss > 2e-5 * abs(float(m_ref["loss"])) or not all(same.values()):
        fail("17c: the dp step's loss or mining disagrees with the one-process step")
    if g_err > 1e-4 or max(p_err, t_err, q_err) > 2 * lr or not l_err <= l_tol:
        fail("17c: the dp step's gradients, update or forward_test disagree with the one-process step")
    for o in outs:
        if not all(math.isfinite(x) for x in o["bf16_losses"]):
            fail(f"17c rank {o['rank']}: a bf16 loss is not finite: {o['bf16_losses']}")
        log(f"17c rank {o['rank']} (one of {DP_WORLD} processes sharing one card; not a scaling figure): fp32 step "
            f"{o['fp32_ms']:.2f} ms, bf16 steps {', '.join(f'{x:.2f}' for x in o['bf16_ms'])} ms (host clock, "
            f"synchronised), bf16 losses {', '.join(f'{x:.4f}' for x in o['bf16_losses'])}; launches: forward_test "
            f"{o['fwd_launches']}, fp32 step {o['fp32_launches']}, bf16 steps {o['bf16_launches']}; gradient "
            f"all-reduce {o['grad_bytes']} bytes a step")
    seen = [{k: o[key][k] for k in KERNELS} for o in outs for key in ("fwd_launches", "fp32_launches", "bf16_launches")]
    return {"launches": seen, "grad_bytes": r0["grad_bytes"], "loss_err": d_loss, "grad_rel_err": g_err,
            "param_err": p_err, "teacher_err": t_err, "global_q_err": q_err, "logits_err": l_err,
            "ranks": [{k: o[k] for k in ("rank", "fp32_ms", "bf16_ms", "bf16_losses")} for o in outs]}


def phase_dp(gen, abmil_ref=None) -> dict:
    """Phase 17: data parallelism over bags (``mhim_mil_torch/parallel``):
    17a the mesh flags in one process (fault 13), 17b an NCCL world of one,
    17c two gloo processes sharing the card."""
    spe = 8
    t0 = time.perf_counter()
    a = dp_abmil_flags(abmil_ref)
    b = dp_world_of_one(gen, spe)
    ref = b.pop("ref")
    c = dp_two_processes(ref, spe)
    secs = time.perf_counter() - t0
    log(f"17 dp: {secs:.1f} s")
    return {"launches": [a["launches"], b["launches"], *c["launches"]], "a": a, "c": c, "seconds": secs,
            "ref": ref}


# ---- phase 18: sequence parallelism over instances ---------------------------------------

SP_WORLD = 2  # processes of 18, sharing the one card: dp 1 x sp 2
SP_TIMEOUT_S = 400
SP_MAX_TOKENS = -(-10241 // SP_WORLD)  # the most tokens a rank's K1, K2, K1b or K2b launch may see
SP_SEEN = ("K1", "K2", "K1b", "K2b")
SP_ATTN_LAUNCHES = dict(K4=1)  # MHIM-attn forward_test, abmil's eval step, abmil's attention: one K4 a rank each


def sp_token_probe(counts: dict):
    """Wrap the wrappers of K1, K2, K1b and K2b so that each call records
    the tokens of its operands in ``counts[kid]``; returns the undo."""
    from mhim_mil_torch.ops import flash_nystrom as fn

    saved = {}
    for kid, name, arg, dim in (("K1", "pass_a", 1, 2), ("K2", "pass_b", 0, 2), ("K1b", "pass_a_backward", 1, 2),
                                ("K2b", "pass_b_backward", 0, 2)):
        orig = saved[name] = getattr(fn, name)

        def probe(*a, _orig=orig, _kid=kid, _arg=arg, _dim=dim, **k):
            counts.setdefault(_kid, []).append(int(a[_arg].shape[_dim]))
            return _orig(*a, **k)

        probe.launches = orig.launches
        setattr(fn, name, probe)

    def undo():
        for name, orig in saved.items():
            orig.launches = getattr(fn, name).launches
            setattr(fn, name, orig)

    return undo


def sp_worker(rank: int, tmp: str, port: int):
    """One rank of phase 18, in a process of its own: a gloo world of
    SP_WORLD processes on the one card, ``make_mesh(dp=1, sp=2)``, each
    rank holding its block of every bag's instances (``shard_batch``). 18a:
    the flagship's ``forward_test`` and one fp32 step, with the tokens each
    K1, K2, K1b and K2b call saw, the step's ms and the sp collectives'
    bytes; 18b: MHIM-attn's ``forward_test`` and abmil's eval step and
    attention, K4 on the rank's block; writes ``tmp/rank<rank>.pt``."""
    import datetime

    import torch.distributed as dist

    from mhim_mil_torch.engine.steps import make_eval_step
    from mhim_mil_torch.models import build_model
    from mhim_mil_torch.parallel import make_mesh, replicate_tree, shard_batch
    from mhim_mil_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    cfg, spe = inputs["cfg"], inputs["spe"]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=SP_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=SP_TIMEOUT_S))
    mesh = make_mesh(dp=1, sp=SP_WORLD)
    batch = {k: v.to("cuda") for k, v in shard_batch(mesh, inputs["batch"]).items()}
    out = {"rank": rank, "tokens": int(batch["feats"].shape[1])}

    def built(c, weights):
        model, family = build_model(c, device="cuda", generator=torch.Generator().manual_seed(0))
        model.load_state_dict(weights)
        return model, family

    model, _ = built(cfg, inputs["init"])
    state = dp_state(cfg, model, spe)
    replicate_tree(mesh, state)
    with mesh:
        reset_launches()
        with torch.no_grad():
            logits = pmesh.gather_rows(model.forward_test(batch["feats"], batch["mask"])["logits"].float())
        torch.cuda.synchronize()
        out["fwd_launches"] = expect_launches(f"18a rank {rank} forward_test", **DP_FWD_LAUNCHES)
        step = train_step_for(cfg, spe)
        seen: dict = {}
        undo = sp_token_probe(seen)
        reset_launches()
        pmesh.SP_BYTES[0] = 0
        try:
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            out["fp32_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            undo()
        out["sp_bytes"] = pmesh.SP_BYTES[0]
        out["fp32_launches"] = expect_launches(f"18a rank {rank} fp32 step", **TRAIN_LAUNCHES)
        out["seen"] = {k: max(v) for k, v in seen.items()}
        out["metrics"] = {k: float(v) for k, v in m.items()}
        out["grad_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
        if rank == 0:
            out["logits"] = logits.cpu()
            out["student"] = {k: v.cpu() for k, v in model.state_dict().items()}
            out["teacher"] = {k: v.cpu() for k, v in state.teacher.state_dict().items()}
            out["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        del state, model, step
        torch.cuda.empty_cache()
        b_out = {}
        for name in ("attn", "abmil"):
            c = inputs[name]["cfg"]
            model, family = built(c, inputs[name]["weights"])
            reset_launches()
            with torch.no_grad():
                if name == "attn":
                    b_out["attn_logits"] = pmesh.gather_rows(model.forward_test(batch["feats"], batch["mask"])["logits"])
                else:
                    b_out["abmil_logits"] = pmesh.gather_rows(make_eval_step(c, model, family)(batch)["logits"])
                    a = model(batch["feats"], batch["mask"], return_attn=True)["attn"]
                    b_out["abmil_attn"] = pmesh.gather_rows(pmesh.sp_gather(
                        a.float(), pmesh.seq_layout(a.shape[1], a.device), 1))
            torch.cuda.synchronize()
            want = SP_ATTN_LAUNCHES if name == "attn" else {k: 2 * v for k, v in SP_ATTN_LAUNCHES.items()}
            out[f"{name}_launches"] = expect_launches(f"18b rank {rank} {name}", **want)
        if rank == 0:
            out.update({k: v.cpu() for k, v in b_out.items()})
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def phase_sp(gen, ref: dict, smi: str) -> dict:
    """Phase 18: sequence parallelism over instances: SP_WORLD processes of
    this script share the card in a gloo world, ``make_mesh(dp=1, sp=2)``,
    each holding one block of 5,120 of each bag's 10,240 instances (the cls
    token makes rank 0's 5,121). (a) The fp32 flagship step at 4 × 10,240 ×
    1024 against 17b's one-process kernel step at 17c's tolerances (loss
    rtol 2e-5, keep_num and patch_num equal, gradients after the all-reduce
    within 1e-4 of max|g|, student, teacher and global_q_mm within 2·lr),
    ``forward_test``'s logits within 1e-4·max|ref|; every K1, K2, K1b and K2b
    call of the step saw at most ⌈10,241/2⌉ tokens, each rank launched what
    one process launches (K3p's 192 among them); each rank's step ms and sp
    collectives' bytes. (b) MHIM-attn's ``forward_test`` and abmil's eval
    step, K4 on each rank's block and the blocks merged by their
    log-sum-exp: logits within 1e-4·max|ref| of one process's, abmil's
    attention by ``compare_attention`` at 1e-4."""
    from mhim_mil_torch.engine.steps import make_eval_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    batch = {k: v.to("cuda") for k, v in ref["batch"].items()}
    refs, inputs = {}, {"cfg": ref["cfg"], "spe": 8, "init": ref["init"], "batch": ref["batch"]}
    for name, seed in (("attn", 41), ("abmil", 42)):
        if name == "attn":
            cfg, model, _ = flagship_models(seed, baseline="attn", compute_dtype="float32")
        else:
            cfg, family, model, _ = preset_models(ZOO, seed, model="abmil", compute_dtype="float32")
        inputs[name] = {"cfg": cfg, "weights": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
        with torch.no_grad():
            if name == "attn":
                refs["attn_logits"] = model.forward_test(batch["feats"], batch["mask"])["logits"].cpu()
            else:
                refs["abmil_logits"] = make_eval_step(cfg, model, family)(batch)["logits"].cpu()
                refs["abmil_attn"] = model(batch["feats"], batch["mask"], return_attn=True)["attn"].float().cpu()
        del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as tmp:
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        outs = rank_processes("--sp-rank", SP_WORLD, SP_TIMEOUT_S, "18", tmp)
    r0, lr, m_ref = outs[0], ref["lr"], ref["metrics"]
    d_loss = abs(r0["metrics"]["loss"] - float(m_ref["loss"]))
    g_err = max(((r0["grads"][n] - p.grad.cpu()).abs().max() / p.grad.abs().max().clamp_min(1e-30).cpu()).item()
                for n, p in ref["model"].named_parameters())
    s_ref = {k: v.cpu() for k, v in ref["model"].state_dict().items()}
    p_err = max((r0["student"][k] - v).abs().max().item() for k, v in s_ref.items() if k != "merge.global_q_mm")
    q_err = (r0["student"]["merge.global_q_mm"] - s_ref["merge.global_q_mm"]).abs().max().item()
    t_ref = {k: v.cpu() for k, v in ref["teacher"].state_dict().items()}
    t_err = max((r0["teacher"][k] - v).abs().max().item() for k, v in t_ref.items() if k != "merge.global_q_mm")
    l_ref = ref["logits"].cpu()
    l_err = (r0["logits"] - l_ref).abs().max().item()
    l_tol = 1e-4 * l_ref.abs().max().item()
    same = {k: r0["metrics"][k] == float(m_ref[k]) for k in ("keep_num", "patch_num")}
    log(f"18a {SP_WORLD} processes sharing the one card (gloo), dp 1 x sp 2, instance blocks of "
        f"{[o['tokens'] for o in outs]} of 10,240, against 17b's one-process step: loss {r0['metrics']['loss']:.9g} "
        f"against {float(m_ref['loss']):.9g}, |d| {d_loss:.3e} (tolerance 2e-5 * |loss|); keep_num and patch_num "
        f"equal {same}; gradients after the all-reduce max|d|/max|ref| {g_err:.3e} (tolerance 1e-4); student max|d| "
        f"{p_err:.3e}, teacher {t_err:.3e}, global_q_mm {q_err:.3e} (tolerance 2·lr = {2 * lr:.3e}); forward_test "
        f"logits max|d| {l_err:.3e} (tolerance 1e-4 * max|ref| = {l_tol:.3e})")
    if not math.isfinite(d_loss) or d_loss > 2e-5 * abs(float(m_ref["loss"])) or not all(same.values()):
        fail("18a: the sp step's loss or mining disagrees with the one-process step")
    if g_err > 1e-4 or max(p_err, t_err, q_err) > 2 * lr or not l_err <= l_tol:
        fail("18a: the sp step's gradients, update or forward_test disagree with the one-process step")
    for o in outs:
        if set(o["seen"]) != set(SP_SEEN) or max(o["seen"].values()) > SP_MAX_TOKENS:
            fail(f"18a rank {o['rank']}: the flash-Nystrom calls saw {o['seen']} tokens, want at most {SP_MAX_TOKENS} "
                 f"for each of {SP_SEEN}")
        log(f"18a rank {o['rank']} on {smi} (one of {SP_WORLD} processes sharing one card; not a scaling figure): fp32 "
            f"step {o['fp32_ms']:.2f} ms (host clock, synchronised); sp collectives {o['sp_bytes']} bytes a step, "
            f"gradient all-reduce {o['grad_bytes']} bytes; most tokens a call {o['seen']} (at most {SP_MAX_TOKENS}); "
            f"launches: forward_test {o['fwd_launches']}, fp32 step {o['fp32_launches']}, 18b MHIM-attn "
            f"{o['attn_launches']}, abmil {o['abmil_launches']}")
    errs = {}
    for name in ("attn_logits", "abmil_logits"):
        want = refs[name]
        errs[name] = (r0[name].float() - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        log(f"18b {name.replace('_', ' ')} under sp 2 (K4 on each rank's block, merged by the blocks' log-sum-exp) "
            f"against one process: max|d| {errs[name]:.3e} (tolerance 1e-4 * max|ref| = {tol:.3e})")
        if not torch.isfinite(r0[name]).all() or errs[name] > tol:
            fail(f"18b: the sp {name} disagree with one process's")
    compare_attention("18b abmil attention under sp 2", [("attn", r0["abmil_attn"], refs["abmil_attn"])], 1e-4,
                      what="sp vs one process")
    secs = time.perf_counter() - t0
    log(f"18 sp: {secs:.1f} s")
    seen = [{k: o[key][k] for k in KERNELS} for o in outs
            for key in ("fwd_launches", "fp32_launches", "attn_launches", "abmil_launches")]
    return {"launches": seen, "seconds": secs, "loss_err": d_loss, "grad_rel_err": g_err, "param_err": p_err,
            "teacher_err": t_err, "global_q_err": q_err, "logits_err": l_err, "errs": errs,
            "ranks": [{k: o[k] for k in ("rank", "tokens", "fp32_ms", "sp_bytes", "seen")} for o in outs]}


# ---- phase 19: data parallelism over bags for the rest of the zoo ------------------------------

ZOO_DP_WORLD = 2  # processes of 19, sharing the one card
ZOO_DP_TIMEOUT_S = 400
ZOO_DP_SPE = 8
MHIM_C16 = "config/mhim_c16.yaml"
SURV = "config/feat_surv.yaml"
# name: (preset, config overrides); one fp32 train step each, at the preset's width on input_dim 1024
ZOO_DP = {
    "clam_sb": (ZOO, dict(model="clam_sb", aux_alpha=0.5)),
    "clam_mb": (ZOO, dict(model="clam_mb", aux_alpha=0.5)),
    "dsmil": (ZOO, dict(model="dsmil", aux_alpha=0.5)),
    "dtfd": (ZOO, dict(model="dtfd", aux_alpha=0.5)),
    "ibmil": (ZOO, dict(model="ibmil")),
    "rrtmil": (ZOO, dict(model="rrtmil", rrt_n_layers=2, rrt_n_heads=8, region_num=8, epeg_k=15, crmsa_k=3)),
    **{f"mambamil_{v}": (ZOO, dict(model="mambamil", mambamil_type=t)) for v, t in MAMBAMIL},
    "mhim_dsmil": (MHIM_C16, dict(baseline="dsmil")),
    "mhim_pure_dsmil": (MHIM_C16, dict(model="mhim_pure", baseline="dsmil")),
    "2dmamba": (SURV, dict(model="2dmamba", datasets="surv_blca")),
}
ZOO_DP_AUX = ("clam_sb", "clam_mb", "dsmil", "dtfd", "mhim_dsmil")  # each pays an aux loss over the bags
ZOO_DP_BAG = 20000  # 2dmamba's bags, one a rank
ZOO_DP_SLOTS = 20480


def zoo_dp_state(cfg, init: dict, attrs=None):
    """A fresh model of ``cfg`` on the card with the weights ``init`` and its
    train state (seed 0, as every side of phase 19 makes it); the family.
    ``attrs`` sets attributes after the build, a dotted name on a submodule
    (DTFD's ``distill``, a Nystrom layer's ``parity``)."""
    from mhim_mil_torch.engine.train_state import create_mhim_state, create_train_state
    from mhim_mil_torch.models import build_model

    model, family = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(init)
    for key, value in (attrs or {}).items():
        owner, _, name = key.rpartition(".")
        setattr(model.get_submodule(owner), name, value)
    create = create_mhim_state if family in ("mhim", "mhim_pure") else create_train_state
    return model, family, create(cfg, model, ZOO_DP_SPE, seed=0, device="cuda")


def zoo_dp_step(label: str, cfg, family: str, state, batch, **want) -> tuple:
    """One fp32 train step of ``state`` on ``batch``, synchronised: its
    metrics, host ms and launches (``want``, else the run fails; none for
    phases 19 and 20, whose families train through no kernel)."""
    step = train_step_for(cfg, ZOO_DP_SPE, None if family in ("mhim", "mhim_pure") else family)
    reset_launches()
    t0 = time.perf_counter()
    m = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {k: float(v) for k, v in m.items()}, ms, expect_launches(label, **want)


def zoo_dp_k5_probe(records: list):
    """Wrap 2dmamba's K5 wrapper so that each call records its operands and
    output in ``records``; returns the undo."""
    from mhim_mil_torch.models import mamba

    orig = mamba.selective_scan_2d_fused

    def probe(*args):
        y = orig(*args)
        records.append((args, y))
        return y

    mamba.selective_scan_2d_fused = probe
    return lambda: setattr(mamba, "selective_scan_2d_fused", orig)


def zoo_dp_worker(rank: int, tmp: str, port: int):
    """One rank of phase 19, in a process of its own: a gloo world of
    ZOO_DP_WORLD processes on the one card, ``make_mesh(dp=2)``. For each
    family its fp32 train step on this rank's bags (``shard_batch``) from
    the parent's initial weights, IBMIL's bank overwritten on rank 1 before
    the state is broadcast from rank 0; then 2dmamba's eval step on this
    rank's bag with ``pos`` on the BLCA grid through K5, the logits
    gathered, K5's output held against the plain scan on the same operands.
    Writes ``tmp/rank<rank>.pt``."""
    import datetime

    import torch.distributed as dist

    from mhim_mil_torch.engine.steps import make_eval_step
    from mhim_mil_torch.ops import scan2d
    from mhim_mil_torch.parallel import make_mesh, replicate_tree, shard_batch
    from mhim_mil_torch.parallel.mesh import gather_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=ZOO_DP_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=ZOO_DP_TIMEOUT_S))
    mesh = make_mesh(ZOO_DP_WORLD)
    out = {"rank": rank, "steps": {}}
    for name, case in inputs["cases"].items():
        cfg = case["cfg"]
        model, family, state = zoo_dp_state(cfg, case["init"])
        if rank and name == "ibmil":
            model.confounder_feat.fill_(float(rank))  # replicate_tree must restore rank 0's bank
        batch = {k: v.to("cuda") for k, v in shard_batch(mesh, inputs["batches"][case["batch"]]).items()}
        replicate_tree(mesh, state)
        with mesh:
            m, ms, seen = zoo_dp_step(f"19 rank {rank} {name} fp32 step", cfg, family, state, batch)
        res = {"metrics": m, "ms": ms, "launches": seen, "bags": int(batch["feats"].shape[0])}
        if rank == 0:
            res["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
            res["student"] = {k: v.cpu() for k, v in model.state_dict().items()}
            if state.teacher is not None:
                res["teacher"] = {k: v.cpu() for k, v in state.teacher.state_dict().items()}
        out["steps"][name] = res
        del model, state, batch
        torch.cuda.empty_cache()
    case = inputs["cases"]["2dmamba"]
    model, family, _ = zoo_dp_state(case["cfg"], case["init"])
    batch = {k: v.to("cuda") for k, v in shard_batch(mesh, inputs["batches"]["2dmamba_eval"]).items()}
    records: list = []
    undo = zoo_dp_k5_probe(records)
    try:
        with mesh:
            reset_launches()
            logits = gather_rows(make_eval_step(case["cfg"], model, family)(batch)["logits"])
            torch.cuda.synchronize()
            out["eval_launches"] = expect_launches(f"19 rank {rank} 2dmamba eval step", K5=1)
    finally:
        undo()
    (args, y), = records
    with torch.inference_mode():  # the operands are the eval step's inference tensors
        want = scan2d.scan2d_plain(*args)
    out["k5_err"], out["k5_scale"] = (y - want).abs().max().item(), max(1.0, want.abs().max().item())
    out["k5_shape"] = tuple(y.shape)
    if not torch.isfinite(y).all() or out["k5_err"] > 1e-4 * out["k5_scale"]:
        fail(f"19 rank {rank}: K5's output misses the plain scan by {out['k5_err']:.3e} (tolerance 1e-4 * "
             f"max(1, max|ref|) = {1e-4 * out['k5_scale']:.3e})")
    if rank == 0:
        out["logits"] = logits.cpu()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def zoo_dp_batches(gen, grid) -> dict:
    """Phase 19's host batches: the ragged 4 × 10,240 × 1024 batch of the
    zoo (10,240, 10,240, 8,000 and 6,000 valid) with random labels, and
    2dmamba's 2 bags of 20,000 instances in 20,480 slots with survival
    labels, on the raster grid for the train step and (``2dmamba_eval``)
    at distinct random cells of the ``grid`` (275 × 381 on BLCA) for the
    eval step."""
    feats, mask = flagship_batch(gen, 1024)
    zoo = {"feats": feats, "mask": mask, "bag_valid": torch.ones(4, dtype=torch.bool, device="cuda"),
           "target": torch.tensor([0, 1, 0, 1], device="cuda")}
    h, w = grid
    cells = torch.stack([torch.randperm(h * w, device="cuda", generator=gen)[:ZOO_DP_BAG] for _ in range(2)])
    pos = torch.zeros(2, ZOO_DP_SLOTS, 2, dtype=torch.long, device="cuda")
    pos[:, :ZOO_DP_BAG, 0], pos[:, :ZOO_DP_BAG, 1] = cells % w, cells // w
    surv = {"feats": torch.randn(2, ZOO_DP_SLOTS, 1024, device="cuda", generator=gen),
            "mask": (torch.arange(ZOO_DP_SLOTS, device="cuda") < ZOO_DP_BAG)[None].expand(2, -1).contiguous(),
            "bag_valid": torch.ones(2, dtype=torch.bool, device="cuda"),
            "target": torch.tensor([1, 3], device="cuda"), "censorship": torch.tensor([0, 1], device="cuda"),
            "event": torch.tensor([1.5, 4.0], device="cuda")}
    out = {"zoo": zoo, "2dmamba": surv, "2dmamba_eval": {k: surv[k] for k in ("feats", "mask")} | {"pos": pos}}
    return {name: {k: v.cpu() for k, v in b.items()} for name, b in out.items()}


def zoo_dp_grad_err(got: dict, model) -> float:
    """The largest gradient error of the dp step, each tensor's max|d| over
    its own max|ref|, or over the model's where the tensor's whole gradient
    is within 1e-4 of that of zero (the attention-logit biases: a softmax
    is blind to a shift, their gradient is 0 in exact arithmetic)."""
    top = max(p.grad.abs().max().item() for p in model.parameters())
    err = 0.0
    for n, p in model.named_parameters():
        scale = p.grad.abs().max().item()
        scale = scale if scale > 1e-4 * top else top
        err = max(err, (got[n] - p.grad.cpu()).abs().max().item() / scale)
    return err


def phase_zoo_dp(gen, smi: str) -> dict:
    """Phase 19: data parallelism over bags for the rest of the zoo:
    ZOO_DP_WORLD processes of this script share the card in a gloo world,
    ``make_mesh(dp=2)``, each holding 2 of the 4 bags (2dmamba: 1 of 2).
    Each family of ``ZOO_DP`` (CLAM SB and MB, DSMIL, DTFD, IBMIL with a
    bank of 8 prototypes, RRT-MIL, mambamil's three variants, MHIM and its
    teacher stage with the dsmil baseline, 2dmamba) runs one fp32 train
    step at full width, dropout on, against the one-process step on the
    same batch in this process, at 17c's tolerances (loss rtol 2e-5,
    gradients within 1e-4 of max|g|, student, teacher and global_q_mm
    within 2·lr). 2dmamba trains on 2 bags of 20,000 instances on their
    raster grid (142 × 141) and evaluates them with ``pos`` on the 275 ×
    381 BLCA grid through K5, one bag a rank: the gathered logits within
    1e-4·max|ref| of one process's K5 path, each rank's K5 output within
    1e-4·max(1, max|ref|) of the plain scan on the same operands (phase 7's
    tolerance), one K5 launch a rank. Each
    rank's step ms beside the card's name and power limit."""
    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.engine.steps import make_eval_step
    from mhim_mil_torch.models import build_model

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    surv = load_config(["-c", SURV], **ZOO_DP["2dmamba"][1])
    batches = zoo_dp_batches(gen, (surv.mamba_2d_max_h, surv.mamba_2d_max_w))
    refs, cases = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_dp_") as tmp:
        bank = os.path.join(tmp, "bank.npy")
        ibmil_bank(gen, bank, 60)
        for seed, (name, (preset, kw)) in enumerate(ZOO_DP.items(), start=60):
            extra = {"confounder_path": bank} if name == "ibmil" else {}
            cfg = load_config(["-c", preset], input_dim=1024, compute_dtype="float32", **kw, **extra)
            model, _ = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
            init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            del model
            model, family, state = zoo_dp_state(cfg, init)
            key = "2dmamba" if name == "2dmamba" else "zoo"
            batch = {k: v.to("cuda") for k, v in batches[key].items()}
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            m, ms, _ = zoo_dp_step(f"19 {name} one-process fp32 step", cfg, family, state, batch)
            peak = torch.cuda.max_memory_allocated()
            refs[name] = {"metrics": m, "ms": ms, "lr": float(state.optimizer.lr_schedule(0)), "model": model,
                          "peak_gib": peak / 2**30, "step_gib": (peak - held) / 2**30,
                          "student": {k: v.cpu() for k, v in model.state_dict().items()},
                          "teacher": None if state.teacher is None else
                          {k: v.cpu() for k, v in state.teacher.state_dict().items()}}
            model.cpu()  # the reference's weights and gradients stay, on the host
            cases[name] = {"cfg": cfg, "init": init, "batch": key}
            log(f"19 {name}: {cfg.model}{'-' + cfg.baseline if cfg.model.startswith('mhim') else ''} ({preset}) "
                f"{sum(p.numel() for p in model.parameters())} params, one-process fp32 step {ms:.2f} ms, loss "
                f"{m['loss']:.6g}, aux {m['aux_loss']:.6g}")
            del state, batch
            torch.cuda.empty_cache()
        mcfg = cases["2dmamba"]["cfg"]
        model, family, _ = zoo_dp_state(mcfg, cases["2dmamba"]["init"])
        reset_launches()
        ref_logits = make_eval_step(mcfg, model, family)({k: v.to("cuda") for k, v in
                                                          batches["2dmamba_eval"].items()})["logits"].cpu()
        torch.cuda.synchronize()
        expect_launches("19 2dmamba one-process eval step", K5=1)
        del model
        torch.cuda.empty_cache()
        torch.save({"cases": cases, "batches": batches}, os.path.join(tmp, "inputs.pt"))
        outs = rank_processes("--zoo-dp-rank", ZOO_DP_WORLD, ZOO_DP_TIMEOUT_S, "19", tmp)
    r0 = outs[0]
    readings = {}
    for name, ref in refs.items():
        got = r0["steps"][name]
        readings[name] = zoo_step_check("19", f"{name} under dp 2 ({got['bags']} of {2 * got['bags']} bags a rank)",
                                        ref, got)
        readings[name]["rank_ms"] = [o["steps"][name]["ms"] for o in outs]
        if name in ZOO_DP_AUX and not got["metrics"]["aux_loss"] > 0:
            fail(f"19 {name}: no aux loss was paid")
    l_err = (r0["logits"] - ref_logits).abs().max().item()
    k5_errs, k5_tols = [o["k5_err"] for o in outs], [1e-4 * o["k5_scale"] for o in outs]
    l_tol = 1e-4 * ref_logits.abs().max().item()
    log(f"19 2dmamba eval under dp 2 (one bag of {ZOO_DP_BAG} a rank, pos on the {mcfg.mamba_2d_max_h} x "
        f"{mcfg.mamba_2d_max_w} grid, K5 on each rank's bag) against one process's K5 path: logits max|d| "
        f"{l_err:.3e} (tolerance 1e-4 * max|ref| = "
        f"{l_tol:.3e}); each rank's K5 output {[o['k5_shape'] for o in outs]} against the plain scan on the same "
        f"operands: max|d| {', '.join(f'{e:.3e}' for e in k5_errs)} (tolerance 1e-4 * max(1, max|ref|) = "
        f"{', '.join(f'{t:.3e}' for t in k5_tols)})")
    if not torch.isfinite(r0["logits"]).all() or not l_err <= l_tol:
        fail("19 2dmamba: the dp eval's logits disagree with one process's")
    for o in outs:
        steps = ", ".join(f"{n} {s['ms']:.2f}" for n, s in o["steps"].items())
        log(f"19 rank {o['rank']} on {smi} (one of {ZOO_DP_WORLD} processes sharing one card; not a scaling figure): "
            f"fp32 step ms (host clock, synchronised): {steps}; 2dmamba eval launches {o['eval_launches']}")
    secs = time.perf_counter() - t0
    log(f"19 zoo dp: {secs:.1f} s")
    seen = [o["eval_launches"] for o in outs] + [s["launches"] for o in outs for s in o["steps"].values()]
    sp_ref = {"refs": {name: refs[name] for name in SCAN_SP}, "cases": {name: cases[name] for name in SCAN_SP},
              "batches": {k: batches[k] for k in ("zoo", "2dmamba", "2dmamba_eval")}, "logits": ref_logits}
    return {"launches": seen, "seconds": secs, "readings": readings, "logits_err": l_err,
            "k5_err": k5_errs, "sp_ref": sp_ref, "zoo_batch": batches["zoo"]}


def zoo_step_check(phase: str, label: str, ref: dict, got: dict) -> dict:
    """A rank 0's step (``got``: metrics, gradients after the all-reduce,
    student, teacher) against the one-process step ``ref`` at 17c's
    tolerances (loss rtol 2e-5, gradients within 1e-4 of max|g|, student
    and teacher within 2·lr); logs and returns the errors."""
    m_ref, lr = ref["metrics"], ref["lr"]
    d_loss = abs(got["metrics"]["loss"] - m_ref["loss"])
    g_err = zoo_dp_grad_err(got["grads"], ref["model"])
    p_err = max((got["student"][k] - v).abs().max().item() for k, v in ref["student"].items())
    t_err = 0.0 if ref["teacher"] is None else max((got["teacher"][k] - v).abs().max().item()
                                                   for k, v in ref["teacher"].items() if k != "merge.global_q_mm")
    log(f"{phase} {label} against one process: loss {got['metrics']['loss']:.9g} against {m_ref['loss']:.9g}, |d| "
        f"{d_loss:.3e} (tolerance 2e-5 * |loss|); aux_loss {got['metrics']['aux_loss']:.6g} against "
        f"{m_ref['aux_loss']:.6g}; gradients after the all-reduce max|d|/max|ref| {g_err:.3e} (tolerance 1e-4); "
        f"student (buffers among them) max|d| {p_err:.3e}, teacher {t_err:.3e} (tolerance 2·lr = {2 * lr:.3e})")
    if not math.isfinite(d_loss) or d_loss > 2e-5 * abs(m_ref["loss"]):
        fail(f"{phase} {label}: the step's loss disagrees with the one-process step")
    if g_err > 1e-4 or max(p_err, t_err) > 2 * lr:
        fail(f"{phase} {label}: the step's gradients or update disagree with the one-process step")
    return {"loss_err": d_loss, "grad_rel_err": g_err, "param_err": p_err, "teacher_err": t_err,
            "one_process_ms": ref["ms"]}


# ---- phase 20: sequence parallelism for the scan families ----------------------------------------

SCAN_SP_WORLD = 2  # processes of 20, sharing the one card: dp 1 x sp 2
SCAN_SP_TIMEOUT_S = 400
SCAN_SP = ("2dmamba", *(f"mambamil_{v}" for v, _ in MAMBAMIL))  # phase 19's cases, held to its one-process steps


def scan_sp_k5_probe(records: list):
    """Wrap K5's carried-state wrapper (``ops/scan2d.scan2d_carry``) so that
    each call records its operands (``h0`` among them) and outputs in
    ``records``; returns the undo."""
    from mhim_mil_torch.ops import scan2d

    orig = scan2d.scan2d_carry

    def probe(*args):
        y, last = orig(*args)
        records.append((args, y, last))
        return y, last

    scan2d.scan2d_carry = probe
    return lambda: setattr(scan2d, "scan2d_carry", orig)


def scan_sp_worker(rank: int, tmp: str, port: int):
    """One rank of phase 20, in a process of its own: a gloo world of
    SCAN_SP_WORLD processes on the one card, ``make_mesh(dp=1, sp=2)``,
    each rank holding its block of every bag's instances. 20a: 2dmamba's
    eval step on phase 19's two BLCA bags with ``pos``, this rank's band of
    grid rows through K5 (a second launch from the carried state on the
    band below the first), each K5 call's y and h_last held against the
    plain scan from the same state, then the same step with no state
    carried (the control); 20b and 20c: the fp32 train step of 2dmamba on
    the bags' raster grid and of mambamil's three variants on the ragged
    zoo batch, with the step's ms and peak memory. Writes
    ``tmp/rank<rank>.pt``."""
    import datetime

    import torch.distributed as dist

    from mhim_mil_torch.engine.steps import make_eval_step
    from mhim_mil_torch.ops import scan2d
    from mhim_mil_torch.parallel import make_mesh, replicate_tree, shard_batch
    from mhim_mil_torch.parallel.mesh import gather_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=SCAN_SP_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=SCAN_SP_TIMEOUT_S))
    mesh = make_mesh(dp=1, sp=SCAN_SP_WORLD)
    out = {"rank": rank, "steps": {}}
    case = inputs["cases"]["2dmamba"]
    model, family, _ = zoo_dp_state(case["cfg"], case["init"])
    batch = {k: v.to("cuda") for k, v in shard_batch(mesh, inputs["batches"]["2dmamba_eval"]).items()}
    step = make_eval_step(case["cfg"], model, family)
    records: list = []
    undo = scan_sp_k5_probe(records)
    try:
        with mesh:
            reset_launches()
            t0 = time.perf_counter()
            logits = gather_rows(step(batch)["logits"])
            torch.cuda.synchronize()
            out["eval_ms"] = (time.perf_counter() - t0) * 1e3
            out["eval_launches"] = expect_launches(f"20a rank {rank} 2dmamba eval step", K5=1 if rank == 0 else 2)
    finally:
        undo()
    out["k5"] = []
    for args, y, last in records:
        with torch.inference_mode():  # the operands are the eval step's inference tensors
            want_y, want_last = scan2d.scan2d_carry_plain(*args)
        err = max((y - want_y).abs().max().item(), (last - want_last).abs().max().item())
        scale = max(1.0, want_y.abs().max().item(), want_last.abs().max().item())
        out["k5"].append({"err": err, "scale": scale, "shape": tuple(y.shape),
                          "carried": len(args) > 6 and args[6] is not None})
        if not (torch.isfinite(y).all() and torch.isfinite(last).all()) or err > 1e-4 * scale:
            fail(f"20a rank {rank}: K5's output misses the plain scan from the same state by {err:.3e} (tolerance "
                 f"1e-4 * max(1, max|ref|) = {1e-4 * scale:.3e})")
    del records
    orig = scan2d.sp_carry
    scan2d.sp_carry = lambda decay, state, seq: torch.zeros_like(state)  # the control: every band from zero
    try:
        with mesh:
            control = gather_rows(step(batch)["logits"])
    finally:
        scan2d.sp_carry = orig
    if rank == 0:
        out["logits"], out["control"] = logits.cpu(), control.cpu()
    del model, step, batch
    torch.cuda.empty_cache()
    for name in SCAN_SP:
        case = inputs["cases"][name]
        cfg = case["cfg"]
        model, family, state = zoo_dp_state(cfg, case["init"])
        batch = {k: v.to("cuda") for k, v in shard_batch(mesh, inputs["batches"][case["batch"]]).items()}
        replicate_tree(mesh, state)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with mesh:
            m, ms, seen = zoo_dp_step(f"20 rank {rank} {name} fp32 step", cfg, family, state, batch)
        peak = torch.cuda.max_memory_allocated()
        res = {"metrics": m, "ms": ms, "launches": seen, "tokens": int(batch["feats"].shape[1]),
               "peak_gib": peak / 2**30, "step_gib": (peak - held) / 2**30}
        if rank == 0:
            res["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
            res["student"] = {k: v.cpu() for k, v in model.state_dict().items()}
            res["teacher"] = None
        out["steps"][name] = res
        del model, state, batch
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def phase_scan_sp(sp_ref: dict, smi: str) -> dict:
    """Phase 20: sequence parallelism for the scan families: SCAN_SP_WORLD
    processes of this script share the card in a gloo world,
    ``make_mesh(dp=1, sp=2)``, each holding one block of every bag's
    instances. (a) 2dmamba's eval step on phase 19's two 20,000-instance
    bags with ``pos`` on the 275 × 381 BLCA grid, each rank a band of whole
    rows (138 and 137) through K5, the state entering the second band
    carried from the first (one K5 launch on rank 0, two on rank 1): the
    gathered logits within 1e-4·max|ref| of phase 19's one-process K5 path,
    each K5 call's y and h_last within 1e-4·max(1, max|ref|) of the plain
    scan from the same state, and the control without the carry outside
    the logits' tolerance; (b) 2dmamba's fp32 train step on the two bags'
    raster grid, the plain scan carried across the bands under autograd,
    each rank's peak memory beside one process's; (c) the fp32 train step
    of mambamil's simple, srmamba and bimamba variants on the ragged 4 ×
    10,240 batch. (b) and (c) against phase 19's one-process steps at
    17c's tolerances; each rank's step ms beside the card's name and power
    limit."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scan_sp_") as tmp:
        torch.save({"cases": sp_ref["cases"], "batches": sp_ref["batches"]}, os.path.join(tmp, "inputs.pt"))
        outs = rank_processes("--scan-sp-rank", SCAN_SP_WORLD, SCAN_SP_TIMEOUT_S, "20", tmp)
    r0, ref_logits = outs[0], sp_ref["logits"]
    l_tol = 1e-4 * ref_logits.abs().max().item()
    l_err = (r0["logits"] - ref_logits).abs().max().item()
    c_err = (r0["control"] - ref_logits).abs().max().item()
    k5 = [(o["rank"], k) for o in outs for k in o["k5"]]
    mcfg = sp_ref["cases"]["2dmamba"]["cfg"]
    log(f"20a 2dmamba eval under dp 1 x sp 2 (both bags' bands of the {mcfg.mamba_2d_max_h} x {mcfg.mamba_2d_max_w} "
        f"grid a rank, K5 on each) against phase 19's one-process K5 path: logits max|d| {l_err:.3e} (tolerance "
        f"1e-4 * max|ref| = {l_tol:.3e}); "
        f"without the carry (control) {c_err:.3e}, which must miss; K5 calls (rank, y shape, from a carried state, "
        f"y and h_last max|d| against the plain scan from the same state, tolerance 1e-4 * max(1, max|ref|)): "
        + "; ".join(f"{r}, {k['shape']}, {k['carried']}, {k['err']:.3e} ({1e-4 * k['scale']:.3e})" for r, k in k5))
    if not torch.isfinite(r0["logits"]).all() or not l_err <= l_tol:
        fail("20a: the sp eval's logits disagree with one process's")
    if not c_err > l_tol:
        fail("20a: the control without the carry agrees with one process: the check cannot see the carry")
    readings = {}
    for name in SCAN_SP:
        ref, got = sp_ref["refs"][name], r0["steps"][name]
        readings[name] = zoo_step_check("20", f"{name} under dp 1 x sp 2 ({got['tokens']} instance slots a rank)",
                                        ref, got)
        readings[name].update(rank_ms=[o["steps"][name]["ms"] for o in outs],
                              rank_peak_gib=[o["steps"][name]["peak_gib"] for o in outs],
                              rank_step_gib=[o["steps"][name]["step_gib"] for o in outs],
                              one_process_peak_gib=ref["peak_gib"], one_process_step_gib=ref["step_gib"])
    for o in outs:
        steps = ", ".join(f"{n} {s['ms']:.2f} ms, peak {s['peak_gib']:.2f} GiB ({s['step_gib']:.2f} above what the "
                          f"rank held)" for n, s in o["steps"].items())
        log(f"20 rank {o['rank']} on {smi} (one of {SCAN_SP_WORLD} processes sharing one card; not a scaling figure): "
            f"eval {o['eval_ms']:.2f} ms, launches {o['eval_launches']}; fp32 steps (host clock, synchronised): "
            f"{steps}")
    log("20 one process (phase 19): " + ", ".join(
        f"{n} {sp_ref['refs'][n]['ms']:.2f} ms, peak {sp_ref['refs'][n]['peak_gib']:.2f} GiB "
        f"({sp_ref['refs'][n]['step_gib']:.2f} above what it held)" for n in SCAN_SP))
    secs = time.perf_counter() - t0
    log(f"20 scan sp: {secs:.1f} s")
    seen = [o["eval_launches"] for o in outs] + [s["launches"] for o in outs for s in o["steps"].values()]
    return {"launches": seen, "seconds": secs, "readings": readings, "logits_err": l_err, "control_err": c_err,
            "k5": k5}


# ---- phase 21: sequence parallelism for every family the earlier sp phases do not run --------------

ZOO_SP_WORLD = 2  # processes of 21, sharing the one card: dp 1 x sp 2
ZOO_SP_TIMEOUT_S = 400
ZOO_SP_LOSS = 1e-6  # |loss - one process's loss| at most, beside zoo_step_check's limits
# name: (preset, config overrides); one fp32 train step and one evaluation each, at the preset's width on
# input_dim 1024, on phase 19's ragged 4 x 10,240 batch
ZOO_SP = {
    "transmil": (ZOO, dict(model="transmil")),
    "gabmil": (ZOO, dict(model="gabmil")),
    "meanmil": (ZOO, dict(model="meanmil")),
    "maxmil": (ZOO, dict(model="maxmil")),
    "ibmil": (ZOO, dict(model="ibmil")),
    "clam_sb": (ZOO, dict(model="clam_sb", aux_alpha=0.5)),
    "clam_mb": (ZOO, dict(model="clam_mb", aux_alpha=0.5)),
    "dsmil": (ZOO, dict(model="dsmil", aux_alpha=0.5)),
    "mhim_dsmil": (MHIM_C16, dict(baseline="dsmil")),
    "mhim_peg": (MHIM_C16, dict(pos="peg")),
    "dtfd": (ZOO, dict(model="dtfd", aux_alpha=0.5)),
    "dtfd_maxmins": (ZOO, dict(model="dtfd", aux_alpha=0.5)),
    "rrtmil": ZOO_DP["rrtmil"],
    "transmil_parity": (ZOO, dict(model="transmil")),
}
# attributes set on every model of a case after it is built (zoo_dp_state)
ZOO_SP_ATTRS = {"dtfd_maxmins": {"distill": "MaxMinS"},
                "transmil_parity": {"layer1.attn.parity": True, "layer2.attn.parity": True}}
# the launches of a rank (as of one process) in each case's fp32 step and evaluation; none elsewhere
ZOO_SP_LAUNCHES = {"transmil": (TEACHER_LAUNCHES, DP_FWD_LAUNCHES), "gabmil": ({}, dict(K4=1)),
                   "mhim_peg": (TRAIN_LAUNCHES, DP_FWD_LAUNCHES)}
ZOO_SP_AUX = ("clam_sb", "clam_mb", "dsmil", "mhim_dsmil", "mhim_peg", "dtfd", "dtfd_maxmins")  # each pays an aux loss


def zoo_sp_eval(label: str, cfg, model, family: str, batch, want: dict):
    """The evaluation step's logits on ``batch`` (gathered under a mesh) and
    its launches (``want``, else the run fails)."""
    from mhim_mil_torch.engine.steps import make_eval_step, make_mhim_eval_step
    from mhim_mil_torch.parallel.mesh import gather_rows

    step = make_mhim_eval_step(cfg, model) if family in ("mhim", "mhim_pure") else make_eval_step(cfg, model, family)
    reset_launches()
    logits = gather_rows(step(batch)["logits"])
    torch.cuda.synchronize()
    return logits.cpu(), expect_launches(label, **want)


def zoo_sp_k4_probe(tokens: list):
    """Wrap the pools' K4 wrapper so that each call records its instances in
    ``tokens``; returns the undo."""
    from mhim_mil_torch.models import layers

    orig = layers.fused_abmil_pool

    def probe(x, *a, **k):
        tokens.append(int(x.shape[1]))
        return orig(x, *a, **k)

    layers.fused_abmil_pool = probe
    return lambda: setattr(layers, "fused_abmil_pool", orig)


def zoo_sp_hold(state, scores, rows: slice, errs: list):
    """MHIM's mining held to one decision (ROADMAP fault 14): the teacher
    runs its own forward, its mining scores are held against this rank's
    block ``rows`` of the one-process teacher's ``scores`` (max|d| into
    ``errs``), and the mining reads those; returns the undo."""
    teacher = state.teacher
    own = teacher.forward_teacher

    def held(feats, mask, training=False, gen=None):
        cls, attn = own(feats, mask, training=training, gen=gen)
        ref = scores[:, rows].to(attn.device)
        errs.append((attn - ref).abs().max().item())
        return cls, ref

    teacher.forward_teacher = held
    return lambda: delattr(teacher, "forward_teacher")


def zoo_sp_record(state, out: list):
    """Record the mining scores of the teacher's forward in ``out``; returns the undo."""
    teacher = state.teacher
    own = teacher.forward_teacher

    def recorded(*a, **k):
        cls, attn = own(*a, **k)
        out.append(attn.detach().cpu())
        return cls, attn

    teacher.forward_teacher = recorded
    return lambda: delattr(teacher, "forward_teacher")


def zoo_sp_worker(rank: int, tmp: str, port: int):
    """One rank of phase 21, in a process of its own: a gloo world of
    ZOO_SP_WORLD processes on the one card, ``make_mesh(dp=1, sp=2)``, each
    rank holding its block of every bag's instances. For each family its
    fp32 train step from the parent's initial weights (MHIM's mining held
    to the one-process teacher's scores) and its evaluation step, with the
    tokens each K1, K2, K1b, K2b and K4 call saw and the launches. Writes
    ``tmp/rank<rank>.pt``."""
    import datetime

    import torch.distributed as dist

    from mhim_mil_torch.parallel import make_mesh, replicate_tree, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=ZOO_SP_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=ZOO_SP_TIMEOUT_S))
    mesh = make_mesh(dp=1, sp=ZOO_SP_WORLD)
    batch = {k: v.to("cuda") for k, v in shard_batch(mesh, inputs["batch"]).items()}
    rows = mesh.instances(inputs["batch"]["mask"].shape[1])
    out = {"rank": rank, "tokens": int(batch["feats"].shape[1]), "steps": {}}
    for name, case in inputs["cases"].items():
        cfg = case["cfg"]
        want_step, want_eval = ZOO_SP_LAUNCHES.get(name, ({}, {}))
        attrs = ZOO_SP_ATTRS.get(name)
        model, family, state = zoo_dp_state(cfg, case["init"], attrs)
        replicate_tree(mesh, state)
        seen: dict = {}
        k4: list = []
        errs: list = []
        undo = [sp_token_probe(seen), zoo_sp_k4_probe(k4)]
        if case["scores"] is not None:
            undo.append(zoo_sp_hold(state, case["scores"], rows, errs))
        try:
            with mesh:
                m, ms, c_step = zoo_dp_step(f"21 rank {rank} {name} fp32 step", cfg, family, state, batch, **want_step)
                model_e, _, _ = zoo_dp_state(cfg, case["init"], attrs)
                logits, c_eval = zoo_sp_eval(f"21 rank {rank} {name} eval", cfg, model_e, family, batch, want_eval)
        finally:
            for u in reversed(undo):
                u()
        res = {"metrics": m, "ms": ms, "launches": c_step, "eval_launches": c_eval,
               "seen": {k: max(v) for k, v in seen.items()}, "k4_tokens": k4, "score_err": max(errs, default=None)}
        if rank == 0:
            res["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()}
            res["student"] = {k: v.cpu() for k, v in model.state_dict().items()}
            res["teacher"] = (None if state.teacher is None or family not in ("mhim", "mhim_pure")
                              else {k: v.cpu() for k, v in state.teacher.state_dict().items()})
            res["logits"] = logits
        out["steps"][name] = res
        del model, model_e, state
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def phase_zoo_sp(zoo_batch: dict, gen, smi: str) -> dict:
    """Phase 21: sequence parallelism for every family that phases 18 and
    20 do not run: ZOO_SP_WORLD processes of this script share the card in
    a gloo world, ``make_mesh(dp=1, sp=2)``, each holding one block of
    5,120 of each bag's 10,240 instances of phase 19's ragged batch. For
    each case of ``ZOO_SP`` (transmil with PPEG, gabmil, meanmil, maxmil,
    ibmil with a bank of 8 prototypes, clam_sb, clam_mb, dsmil, MHIM with
    the dsmil baseline and with the selfattn one and PEG, dtfd with AFS and
    with MaxMinS, rrtmil with 8 × 8 regions of 13 × 13 (32 a rank), and
    transmil with both layers on the ``parity`` Nystrom path) at full
    width, fp32, dropout on: one train step against the one-process step in
    this process at 17c's tolerances (loss rtol 2e-5, gradients within 1e-4
    of max|g|, student, teacher and global_q_mm within 2·lr; MHIM's mining
    held to the one-process teacher's scores, the ranks' own within
    1e-4·max|ref| of them) and the loss within ZOO_SP_LOSS, and the
    evaluation step's logits within 1e-4·max|ref|; transmil's and
    MHIM-peg's K1, K2, K1b and K2b calls each see at most ⌈10,241/2⌉ tokens,
    gabmil's K4 runs once a rank on its block; each rank launches what one
    process launches. dtfd, rrtmil (whose pool runs without K4, as in JAX)
    and the parity layers (the materialising op, as in JAX) launch no
    kernel, in one process or on a rank: their steps and evaluations are
    held to that. Each rank's step ms beside the card's name and power
    limit."""
    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.models import build_model

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    batch = {k: v.to("cuda") for k, v in zoo_batch.items()}
    refs, cases = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_sp_") as tmp:
        bank = os.path.join(tmp, "bank.npy")
        ibmil_bank(gen, bank, 70)
        for seed, (name, (preset, kw)) in enumerate(ZOO_SP.items(), start=70):
            extra = {"confounder_path": bank} if name == "ibmil" else {}
            cfg = load_config(["-c", preset], input_dim=1024, compute_dtype="float32", **kw, **extra)
            model, _ = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
            init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            del model
            want_step, want_eval = ZOO_SP_LAUNCHES.get(name, ({}, {}))
            attrs = ZOO_SP_ATTRS.get(name)
            model, family, state = zoo_dp_state(cfg, init, attrs)
            scores: list = []
            undo = zoo_sp_record(state, scores) if family in ("mhim", "mhim_pure") else (lambda: None)
            try:
                m, ms, _ = zoo_dp_step(f"21 {name} one-process fp32 step", cfg, family, state, batch, **want_step)
            finally:
                undo()
            model_e, _, _ = zoo_dp_state(cfg, init, attrs)
            logits, _ = zoo_sp_eval(f"21 {name} one-process eval", cfg, model_e, family, batch, want_eval)
            refs[name] = {"metrics": m, "ms": ms, "lr": float(state.optimizer.lr_schedule(0)), "model": model,
                          "logits": logits, "scores": scores[0] if scores else None,
                          "student": {k: v.cpu() for k, v in model.state_dict().items()},
                          "teacher": None if family not in ("mhim", "mhim_pure") else
                          {k: v.cpu() for k, v in state.teacher.state_dict().items()}}
            model.cpu()  # the reference's weights and gradients stay, on the host
            cases[name] = {"cfg": cfg, "init": init, "scores": refs[name]["scores"]}
            log(f"21 {name}: {cfg.model}{'-' + cfg.baseline if cfg.model.startswith('mhim') else ''} ({preset}) "
                f"{sum(p.numel() for p in model.parameters())} params, one-process fp32 step {ms:.2f} ms, loss "
                f"{m['loss']:.6g}, aux {m['aux_loss']:.6g}")
            del state, model_e
            torch.cuda.empty_cache()
        torch.save({"cases": cases, "batch": zoo_batch}, os.path.join(tmp, "inputs.pt"))
        outs = rank_processes("--zoo-sp-rank", ZOO_SP_WORLD, ZOO_SP_TIMEOUT_S, "21", tmp)
    r0 = outs[0]
    readings = {}
    for name, ref in refs.items():
        got = r0["steps"][name]
        readings[name] = zoo_step_check("21", f"{name} under dp 1 x sp 2 ({r0['tokens']} instance slots a rank)",
                                        ref, got)
        if not readings[name]["loss_err"] <= ZOO_SP_LOSS:
            fail(f"21 {name}: the step's loss misses one process's by {readings[name]['loss_err']:.3e} (limit "
                 f"{ZOO_SP_LOSS})")
        l_err = (got["logits"] - ref["logits"]).abs().max().item()
        l_tol = 1e-4 * ref["logits"].abs().max().item()
        seen = {k: max(o["steps"][name]["seen"].get(k, 0) for o in outs) for k in SP_SEEN}
        k4 = [o["steps"][name]["k4_tokens"] for o in outs]
        s_errs = [o["steps"][name]["score_err"] for o in outs]
        log(f"21 {name} eval under dp 1 x sp 2 against one process: logits max|d| {l_err:.3e} (tolerance 1e-4 * "
            f"max|ref| = {l_tol:.3e}); most tokens a call {seen} (at most {SP_MAX_TOKENS}); K4 calls' tokens a rank "
            f"{k4}" + ("" if ref["scores"] is None else
                       f"; the ranks' teacher mining scores against one process's max|d| {s_errs} (tolerance 1e-4 * "
                       f"max|ref| = {1e-4 * ref['scores'].abs().max().item():.3e})"))
        if not torch.isfinite(got["logits"]).all() or not l_err <= l_tol:
            fail(f"21 {name}: the sp eval's logits disagree with one process's")
        if max(seen.values()) > SP_MAX_TOKENS:
            fail(f"21 {name}: a K1, K2, K1b or K2b call saw more than {SP_MAX_TOKENS} tokens")
        if name in ZOO_SP_LAUNCHES and max(seen.values()) == 0 and name != "gabmil":
            fail(f"21 {name}: no Nystrom kernel saw a token")
        if name == "gabmil" and k4 != [[o["tokens"]] for o in outs]:
            fail(f"21 gabmil: K4 did not run once a rank on the rank's block: {k4}")
        if ref["scores"] is not None and not max(s_errs) <= 1e-4 * ref["scores"].abs().max().item():
            fail(f"21 {name}: the ranks' teacher scores disagree with one process's")
        if name in ZOO_SP_AUX and not got["metrics"]["aux_loss"] > 0:
            fail(f"21 {name}: no aux loss was paid")
        readings[name].update(logits_err=l_err, seen=seen, rank_ms=[o["steps"][name]["ms"] for o in outs])
    log("21 no kernel launched, in one process or on a rank, in the steps and evaluations of "
        + ", ".join(n for n in ZOO_SP if n not in ZOO_SP_LAUNCHES) + " (each held to that); nor in gabmil's step")
    for o in outs:
        steps = ", ".join(f"{n} {s['ms']:.2f}" for n, s in o["steps"].items())
        log(f"21 rank {o['rank']} on {smi} (one of {ZOO_SP_WORLD} processes sharing one card; not a scaling figure): "
            f"fp32 step ms (host clock, synchronised): {steps}")
    log("21 one process: fp32 step ms " + ", ".join(f"{n} {r['ms']:.2f}" for n, r in refs.items()))
    secs = time.perf_counter() - t0
    log(f"21 zoo sp: {secs:.1f} s")
    seen = [c for o in outs for s in o["steps"].values() for c in (s["launches"], s["eval_launches"])]
    return {"launches": seen, "seconds": secs, "readings": readings}


def main():
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    report = phase_nystrom_kernels(gen)
    for phase in (phase_k4, phase_k3, phase_k3p, phase_k2b, phase_k1b, phase_k5, phase_k6):
        report.update(phase(gen))
    log(f"phase 3 (the kernels against their plain versions): {time.perf_counter() - t0:.1f} s")
    counted = {kid: 0 for kid in KERNELS}
    stress = None
    done = {}
    for label, phase in (("4 serving", phase_serving), ("5 train", phase_train), ("5b teacher", phase_teacher),
                         ("6 attn", phase_attn), ("7 2dmamba", phase_mamba), ("9 zoo", phase_zoo),
                         ("10 zoo II", phase_zoo2), ("11a mambamil", phase_mambamil), ("11b streamed", phase_streamed),
                         ("11c heatmaps", phase_heatmaps), ("12 stress", phase_stress), ("13 ablate", phase_ablate),
                         ("14 bundle", phase_bundle), ("8 driver", lambda g: phase_driver()),
                         ("15 features", lambda g: phase_features()),
                         ("16 slides", lambda g: phase_slides(done["15 features"]["encoders"])),
                         ("17 dp", lambda g: phase_dp(g, done["8 driver"]["abmil"])),
                         ("18 sp", lambda g: phase_sp(g, done["17 dp"].pop("ref"), smi)),
                         ("19 zoo dp", lambda g: phase_zoo_dp(g, smi)),
                         ("20 scan sp", lambda g: phase_scan_sp(done["19 zoo dp"].pop("sp_ref"), smi)),
                         ("21 zoo sp", lambda g: phase_zoo_sp(done["19 zoo dp"].pop("zoo_batch"), g, smi))):
        t0 = time.perf_counter()
        res = done[label] = phase(gen)
        for seen in res["launches"]:
            for kid, n in seen.items():
                counted[kid] += n
        stress = res.get("stress", stress)
        log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    log(f"launches on the main paths: {counted}")
    for label in ("long", "long_ragged"):  # each kernel's share of K3 at the teacher stage's length
        for kid, t in report["K3"][label]["by_kernel"].items():
            report[kid].setdefault("k3_long", {})[label] = t
    report["K3"]["stress"] = {"flagship_2x32768": stress["flagship"]}
    for label, row in stress["K3"].items():  # K3 alone at N 32,769 and 16,385, and each kernel's share
        report["K3"]["stress"][label] = {k: v for k, v in row.items() if k != "by_kernel"}
        for kid, t in row["by_kernel"].items():
            report[kid].setdefault("stress", {})[label] = t
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
        "K5": ("scan2d and scan2d_carry (scan2d_cluster_kernel; scan2d_wide_kernel above 1,152 columns; from a "
               "carried state h0, writing h_last, on the sp bands)",
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
                    "empty_launch_device_ms", "long", "long_ragged", "k3_long", "stress", "carry"):
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
    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of phase 17c, started by phase 17
        dp_worker(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    elif sys.argv[1:2] == ["--sp-rank"]:  # one rank of phase 18, started by phase 18
        sp_worker(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    elif sys.argv[1:2] == ["--zoo-dp-rank"]:  # one rank of phase 19, started by phase 19
        zoo_dp_worker(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    elif sys.argv[1:2] == ["--scan-sp-rank"]:  # one rank of phase 20, started by phase 20
        scan_sp_worker(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    elif sys.argv[1:2] == ["--zoo-sp-rank"]:  # one rank of phase 21, started by phase 21
        zoo_sp_worker(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    else:
        main()
