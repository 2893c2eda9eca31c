"""Build the CUDA sources under ``mhim_mil_torch/csrc`` and load them with ctypes.

Each source ``csrc/<name>.cu`` has a plain C interface. On first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source, the headers ``csrc/*.cuh`` and the flags, so
an edited source or header rebuilds and an unchanged one loads at once. Several sources build in parallel, one
``nvcc`` each; a build prints ptxas's report (registers, shared memory,
spills) for each kernel on stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I64, I32, F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float

# argtypes of every C entry, by source
SIGNATURES: Dict[str, Dict[str, list]] = {
    "flash_nystrom": {
        "flash_nystrom_pass_a_rows": [I32],  # DH
        "flash_nystrom_pass_a_keys": [],
        "flash_nystrom_pass_a_resident": [I32],  # DH
        "flash_nystrom_pass_a": [
            P,  # ql
            P, I64, I64, I64,  # k and its batch, head, token strides
            P, I64, I64, I64,  # v
            P,  # mask
            P, P, P,  # scratch: part_m, part_s, part_acc
            P, P, P,  # attn3v, m3, s3
            I32, I32, I32, I32, I32,  # B, H, N, M, DH
            I32, I32,  # n_splits, per_split
            P,  # stream
        ],
        "flash_nystrom_pass_b": [
            P, I64, I64, I64,  # q
            P, I64, I64, I64,  # k
            P,  # mask
            P, P, P, P, P, P,  # kl, lm_mask, mid, ql, r', m3
            P, I64, I64, I64,  # out
            P,  # cls
            I32, I32, I32, I32, I32,  # B, H, N, M, DH
            P,  # stream
        ],
    },
    "flash_nystrom_bwd": {
        "flash_nystrom_bwd_rows": [I32],  # DH
        "flash_nystrom_bwd_keys": [I32],  # DH
        "flash_nystrom_bwd_resident": [I32],  # DH
        "flash_nystrom_bwd_width": [I32, I32],  # DH, with the cls term
        "flash_nystrom_pass_b_bwd": [
            P, I64, I64, I64,  # q
            P, I64, I64, I64,  # k
            P,  # mask
            P, P, P, P, P, P,  # kl, lm_mask, mid, ql, r', m3
            P, I64, I64, I64,  # d_out
            P, I64, I64, I64,  # out, K2's output
            P,  # d_cls, or null
            P, P,  # d_q, d_k (or null)
            P, P, P,  # scratch: lse, D, the partial sums
            P,  # out: d_kl | d_mid | d_ql | d_r'
            P,  # scratch: int32 tickets
            I32, I32, I32, I32, I32,  # B, H, N, M, DH
            I32, I32,  # n_splits, per_split
            P,  # stream
        ],
    },
    "flash_nystrom_k1b": {
        "flash_nystrom_k1b_rows": [I32],  # DH
        "flash_nystrom_k1b_keys": [I32],  # DH
        "flash_nystrom_k1b_resident": [I32],  # DH
        "flash_nystrom_pass_a_bwd": [
            P,  # ql
            P, I64, I64, I64,  # k
            P, I64, I64, I64,  # v
            P, P, P, P,  # mask, attn3v, m3, s3
            P, P,  # d_attn3v, d_s3 (or null)
            P, P, P,  # d_ql, d_k, d_v
            P, P,  # scratch: the partial sums, int32 tickets
            I32, I32, I32, I32, I32,  # B, H, N, M, DH
            I32, I32,  # n_splits, per_split
            P,  # stream
        ],
    },
    "nystrom_pinv": {
        "nystrom_pinv_tiles": [P],  # out: the tiles built, BM·1000 + BN
        "nystrom_pinv_product": [
            P, P, P, P,  # A, B, C (or null), D
            I32, I32,  # G, m
            I32, I32,  # A transposed, B transposed
            F, F, F,  # alpha, diag, beta
            I32, I32,  # the tile: BM, BN
            P,  # stream
        ],
    },
    "abmil_pool": {
        "abmil_pool_limits": [P],  # out: threads a block, tokens a block, chunks a bag
        "abmil_pool": [
            P, I64, I64, I32, I32,  # x, its batch and token strides, x is bf16, its rows are 16-byte aligned
            P, P,  # logits, mask
            P, P,  # scratch: part_ms, part_acc
            P,  # scratch: int32 tickets
            P, P,  # pooled, attn
            I32, I32, I32, I32,  # B, N, D, tokens a block
            P,  # stream
        ],
    },
    "scan2d": {
        "scan2d_scratch": [I32, I32],  # W, N
        "scan2d": [
            P, P,  # x, delta
            P, I64, P, I64,  # B, C and their cell strides
            I32,  # x, delta, B and C are bf16
            P, P,  # A_log, D
            P,  # y
            P,  # scratch for the h of wide rows, or null
            I32, I32, I32, I32, I32,  # Bs, H, W, ED, N
            I32, I32, I32,  # the plan: G, S, P (S = 0: the wide kernel)
            P,  # stream
        ],
    },
    "probe": {
        "probe": [P, P, I64, P],  # x, o, n, stream
        "probe_empty": [P],  # stream
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every source that has no library for its current hash, all
    ``nvcc`` processes started together, and print the compiler's report.
    Returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = []
    for name, so in paths.items():
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
            continue
        print(log, end="", file=sys.stderr)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]
