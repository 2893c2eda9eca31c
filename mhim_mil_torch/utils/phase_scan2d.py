"""Where K5's time goes within a row, by ``clock64`` stamps.

``python -m mhim_mil_torch.utils.phase_scan2d``

Builds a copy of ``csrc/scan2d.cu`` with ``clock64`` stamps at the
numbered steps of ``scan2d_cluster_kernel``'s row loop into
``build/phase_scan2d/`` with ``nvcc``, and runs it at the layout of
``ops/scan2d.scan_plan`` on the operands of ``time_scan2d.operands`` at the
BLCA and serving grids, fp32 and bf16. Each warp sums the cycles of six
phases of a row (``CLUSTER_PHASES``): the row's top (x and Δ converted);
pass 1 with its ``__syncthreads``; the lanes' scan of the runs; the cluster
barrier with the next row's loads issued, the fold of the blocks to the
left, the ``__syncthreads`` after it and the staging of the next row's B
and C; pass 2 with the y stores; and the row's last ``__syncthreads``.
Printed per grid and dtype: the mean cycles of each phase per warp and
row and their shares, the time of one stamped launch (CUDA events, median
of 5) and its largest difference from the plain scan, beside the card's
name and power limit and its SM clock under load; the rows as JSON in
``build/phase_scan2d/``. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch

from ..kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, SIGNATURES, _nvcc
from ..ops import scan2d
from .time_scan2d import operands

CLUSTER_PHASES = ("top", "pass1", "runs", "cluster", "pass2", "sync")
MAX_WARPS = scan2d.MAX_BLOCK // 32  # warps of a cluster block
GRIDS = {"BLCA": (1, 275, 381), "serving": (4, 101, 102)}


def _compile(name: str, source: str) -> ctypes.CDLL:
    d = BUILD_DIR.parent / "phase_scan2d"
    d.mkdir(parents=True, exist_ok=True)
    src, so = d / f"{name}.cu", d / f"lib{name}.so"
    src.write_text(source)
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)], capture_output=True, text=True)
    print(res.stdout + res.stderr, file=sys.stderr)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}")
    return ctypes.CDLL(str(so))


STAMP = "{ const long long t = clock64(); acc[%d] += t - t0; t0 = t; }\n"
SYNC_END = "    __syncthreads();  // the run prefixes and the carry are read; the next row may write them\n"


def cluster_source() -> str:
    """``csrc/scan2d.cu`` with phase stamps in ``scan2d_cluster_kernel`` (at
    its numbered step comments), written by warp to
    ``g_stamps[block][warp][phase]`` when it is set: cycles summed over
    the row loop, divided by the rows."""
    src = (CSRC / "scan2d.cu").read_text()
    edits = [
        ("#include <stdint.h>\n", "#include <stdint.h>\n__device__ long long* g_stamps;\n"
         "extern \"C\" int scan2d_set_stamps(long long* p) {\n"
         "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n"),
        ("  load_row(0);\n", "  long long acc[6] = {0, 0, 0, 0, 0, 0};\n  long long t0 = clock64();\n  load_row(0);\n"),
        *[(f"    // {i + 1}. ", "    " + STAMP % i + f"    // {i + 1}. ") for i in range(4)],
        (SYNC_END, "    " + STAMP % 4 + SYNC_END + "    " + STAMP % 5),
        ("  // no block leaves", "  if (g_stamps && (tid & 31) == 0) {\n"
         "    long long* o = g_stamps + (((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * %d + tid / 32) * 6;\n"
         "    for (int i = 0; i < 6; ++i) o[i] = acc[i];\n  }\n  // no block leaves" % MAX_WARPS),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/scan2d.cu: no single place for the stamp at {old!r}")
        src = src.replace(old, new)
    return src


def run_cluster(lib, name, shape, dtype, gen):
    """The current K5 at the plan's layout, stamped: cycles per warp and row
    of each of :data:`CLUSTER_PHASES`."""
    bs, h, w = shape
    x, delta, a_log, B, C, D = operands(bs, h, w, dtype, gen)
    ed, n = x.shape[-1], a_log.shape[-1]
    plan = scan2d.scan_plan(w, n, x.element_size())
    y = torch.empty(x.shape, device="cuda", dtype=torch.float32)
    blocks = plan.blocks(bs, ed)
    out = torch.zeros(blocks * MAX_WARPS * len(CLUSTER_PHASES), device="cuda", dtype=torch.int64)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(stamps: bool):
        if lib.scan2d_set_stamps(out.data_ptr() if stamps else None):
            raise RuntimeError("scan2d_set_stamps failed")
        err = lib.scan2d(x.data_ptr(), delta.data_ptr(), B.data_ptr(), B.stride(2), C.data_ptr(), C.stride(2),
                         int(dtype == torch.bfloat16), a_log.data_ptr(), D.data_ptr(), y.data_ptr(), None,
                         bs, h, w, ed, n, plan.group, plan.cluster, plan.runs, stream)
        if err:
            raise RuntimeError(f"scan2d: CUDA error {err}")

    stamped_ms = event_ms(lambda: launch(True))
    clock = sm_clock_mhz()
    out.zero_()
    launch(True)
    torch.cuda.synchronize()
    err = (y - scan2d.scan2d_plain(x, delta, a_log, B, C, D)).abs().max().item()
    warps = plan.threads // 32
    cyc = out.view(blocks, MAX_WARPS, len(CLUSTER_PHASES))[:, :warps].double() / h
    mean = cyc.mean(dim=(0, 1)).tolist()
    total = sum(mean)
    row = {"grid": name, "kernel": "cluster", "shape": [bs, h, w, ed], "dtype": str(dtype).split(".")[-1],
           "plan": [plan.group, plan.cluster, plan.runs, plan.run], "cycles_per_warp_row":
           dict(zip(CLUSTER_PHASES, mean)), "cycles_per_row": total, "stamped_ms": stamped_ms,
           "sm_clock": clock, "max_abs_err": err}
    print(f"{name} {tuple(x.shape)} {row['dtype']} G {plan.group} S {plan.cluster} P {plan.runs}: {total:.0f} "
          "cycles a row per warp; " + ", ".join(f"{p} {m:.0f} ({m / total:.1%})" for p, m in
                                                zip(CLUSTER_PHASES, mean))
          + f"; stamped launch {stamped_ms:.4f} ms; max|d| against the plain scan {err:.2e}; SM clock {clock}",
          flush=True)
    return row


def sm_clock_mhz() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def event_ms(fn, iters=5):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_scan2d needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = _compile("scan2d_cluster_phases", cluster_source())
    for fn, argtypes in SIGNATURES["scan2d"].items():
        getattr(lib, fn).argtypes = argtypes
    lib.scan2d_set_stamps.argtypes = [ctypes.c_void_p]
    rows = [run_cluster(lib, name, shape, dtype, gen) for name, shape in GRIDS.items()
            for dtype in (torch.float32, torch.bfloat16)]
    out = BUILD_DIR.parent / "phase_scan2d" / "phase_scan2d_cluster.json"
    out.write_text(json.dumps(rows, indent=1))
    print(f"rows written to {out}")


if __name__ == "__main__":
    main()
