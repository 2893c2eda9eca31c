"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It needs a CUDA card (as many as the cell asks for) and the program
(``mhim_mil_torch``) beside ``benchmark/``; without either it exits with a
code other than 0 and prints no result. Build and kernel caches go under
``build/`` in the checkout, at fixed paths. The last line of standard
output is the result (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared, with its limit); the last lines of standard error
repeat the checks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("--seed must be a non-negative whole number", file=sys.stderr)
        return 2

    from benchmark import cell

    t_start = cell.process_start()
    man = cell.manifest(ROOT)
    wl = next((c for c in man["workloads"] if c["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import mhim_mil_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"the program is not beside the benchmark: {e}", file=sys.stderr)
        return 4
    torch.set_num_threads(4)
    result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                           ROOT, t_start)
    bad = cell.forbidden_modules()
    if bad:
        print(f"the run loaded modules it must not: {bad}", file=sys.stderr)
        return 5
    print(json.dumps(result))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
