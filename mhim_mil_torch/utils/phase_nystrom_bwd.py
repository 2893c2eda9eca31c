"""Where K2b's and K1b's warps spend their cycles, by ``clock64`` stamps and diagnostic builds.

``python -m mhim_mil_torch.utils.phase_nystrom_bwd``

Builds ``csrc/flash_nystrom_bwd.cu`` (K2b) and ``csrc/flash_nystrom_k1b.cu``
(K1b) three more times each into ``build/phase_nystrom_bwd/`` with
``nvcc``, all six at once: with ``-DNYS_PHASES``, where each warp of a
kernel sums the cycles between its ``PHASE`` marks by phase (:data:`PHASES`:
issuing ``cp.async`` copies; waiting for them and the block's barrier; the
score products; exponentials and other elementwise work; the accumulating
products; stores, ticket and split merge); then the same with
``NYS_FREE_SPLIT`` (operands go to the tensor cores unsplit: the products'
split arithmetic is gone, the ``mma.sync`` count kept); then also with
``NYS_ONE_MMA`` (one ``mma.sync`` a product where 3×TF32 issues three).
``flash_nystrom.cuh`` defines the three switches.

On :func:`time_nystrom.backward_operands` at the student's shape (B 4, H 8,
N 1,027 ragged, dh 64, m 256: K2b without and with the cls term, K1b
without and with s3's cotangent), at dh 128 (B 4, H 4) and at dh 256 (B 4,
H 2), it runs the wrappers on each build and prints, per kernel: the mean
cycles a warp spends in each phase of one launch and their shares, for the
three builds; the time of one call on each build and on the production
build (CUDA events, median of 20) and the production build's device ms by
kernel (profiler); each kernel's registers, spilled bytes, dynamic shared
memory, threads and blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
on the stamped build), beside the card's name, power limit and SM clock.
The rows go to ``build/phase_nystrom_bwd/phases.json`` too. Needs a CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from ..kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, SIGNATURES, _nvcc
from ..ops import flash_nystrom as fn
from .time_nystrom import BACKWARD_SHAPES, backward_operands, k2b_call
from .time_scan2d import event_ms

PHASES = ("stage", "wait", "scores", "elementwise", "accumulate", "epilogue")
BUILDS = {"stamped": ("-DNYS_PHASES",), "free split": ("-DNYS_PHASES", "-DNYS_FREE_SPLIT"),
          "one mma": ("-DNYS_PHASES", "-DNYS_FREE_SPLIT", "-DNYS_ONE_MMA")}
# per source: its wrapper's library getter in ops/flash_nystrom.py and what
# its PHASES_END ids stamp: K2b's two kernels, K1b's two kinds of block
SOURCES = {"flash_nystrom_bwd": ("_bwd_library", ("token", "landmark")),
           "flash_nystrom_k1b": ("_k1b_library", ("key", "landmark"))}
OUT = BUILD_DIR.parent / "phase_nystrom_bwd"


def compile_all():
    """Every (source, build) library, the nvcc processes started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        for build, flags in BUILDS.items():
            so = OUT / f"lib{name}_{build.replace(' ', '_')}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(so), str(CSRC / f"{name}.cu")]
            procs[name, build] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                       text=True))
    libs = {}
    for (name, build), (so, proc) in procs.items():
        log, _ = proc.communicate()
        print(f"---- nvcc {name} [{build}]\n{log}", file=sys.stderr)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} [{build}]")
        lib = ctypes.CDLL(str(so))
        for f, argtypes in SIGNATURES[name].items():
            getattr(lib, f).argtypes = argtypes
            getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f"{name}_set_phases").argtypes = [ctypes.c_void_p]
        getattr(lib, f"{name}_occupancy").argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        libs[name, build] = lib
    return libs


def device_ms_by_kernel(call, iters=10) -> dict:
    """Device ms a call of each kernel whose name holds one of the
    kernels' names, each kernel's mean record times its launches a call."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.count and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key[:60]] = e.self_device_time_total / e.count * max(1, round(e.count / iters)) / 1e3
    return out


def run_case(libs, name, label, dh, with_term, call):
    getter, kernels = SOURCES[name]
    real = getattr(fn, getter)
    row = {"source": name, "case": label, "dh": dh, "term": with_term, "builds": {},
           "production_ms": event_ms(call), "device_ms": device_ms_by_kernel(call)}
    stamps = torch.zeros(len(kernels) * (len(PHASES) + 1), dtype=torch.int64, device="cuda")
    occ = (ctypes.c_int * (5 * len(kernels)))()
    try:
        for build in BUILDS:
            lib = libs[name, build]
            setattr(fn, getter, lambda lib=lib: lib)
            if getattr(lib, f"{name}_set_phases")(stamps.data_ptr()):
                raise RuntimeError("set_phases failed")
            ms = event_ms(call)
            stamps.zero_()
            call()
            torch.cuda.synchronize()
            per = stamps.view(len(kernels), len(PHASES) + 1).double().cpu()
            row["builds"][build] = {"ms": ms, "cycles_per_warp": {
                k: dict(zip(PHASES, (per[i, :-1] / max(1.0, per[i, -1].item())).tolist()))
                for i, k in enumerate(kernels)}, "warps": {k: int(per[i, -1]) for i, k in enumerate(kernels)}}
        if getattr(libs[name, "stamped"], f"{name}_occupancy")(dh, int(with_term), occ):
            raise RuntimeError("occupancy failed")
    finally:
        setattr(fn, getter, real)
    row["kernels"] = {k: dict(zip(("blocks_per_sm", "registers", "spilled_bytes", "smem", "threads"),
                                  occ[5 * i:5 * i + 5])) for i, k in enumerate(kernels)}
    print(f"== {name} {label} dh {dh} {'with' if with_term else 'without'} the cls / s3 term: production "
          f"{row['production_ms']:.4f} ms (events); device ms by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in row["device_ms"].items()), flush=True)
    for k, kinfo in row["kernels"].items():
        print(f"  {k}: {kinfo['registers']} registers, {kinfo['spilled_bytes']} bytes spilled, {kinfo['smem']} "
              f"bytes of shared memory, {kinfo['threads']} threads, {kinfo['blocks_per_sm']} blocks an SM")
    for build, b in row["builds"].items():
        for k, cyc in b["cycles_per_warp"].items():
            total = sum(cyc.values())
            print(f"  [{build}, {b['ms']:.4f} ms] {k} ({b['warps'][k]} warps): {total:.0f} cycles a warp; "
                  + ", ".join(f"{p} {c:.0f} ({c / max(total, 1):.1%})" for p, c in cyc.items()), flush=True)
    return row


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_nystrom_bwd needs a CUDA card")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = compile_all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, b, h, dh in BACKWARD_SHAPES:
        o = backward_operands(gen, b, h, dh)
        a_args = (o["q_l"], o["k"], o["v"], o["mask"], o["attn3v"], o["m3"], o["s3"], o["d_attn3v"])
        for term in ((False, True) if label == "student" else (False,)):
            args, kw = k2b_call(o, o["q"], o["k"], o["d_out"], o["d_cls"] if term else None)
            rows.append(run_case(libs, "flash_nystrom_bwd", label, dh, term,
                                 lambda: fn.pass_b_backward(*args, **kw)))
            s3 = o["d_s3"] if term else None
            rows.append(run_case(libs, "flash_nystrom_k1b", label, dh, term,
                                 lambda: fn.pass_a_backward(*a_args, s3)))
        del o
        torch.cuda.empty_cache()
    print(subprocess.run(smi, capture_output=True, text=True, timeout=60).stdout.strip())
    (OUT / "phases.json").write_text(json.dumps(rows, indent=1))
    print(f"rows written to {OUT / 'phases.json'}")


if __name__ == "__main__":
    main()
