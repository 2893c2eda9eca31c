"""A checkout with the benchmark's files and a tiny cell of each kind,
added as new files only, for runs of the harness on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {"bucket_sizes": [64, 128, 256, 512, 1024, 2048]}  # the published widths, short bags
TINY_TRAIN = {"mode": "train", "n_slides": 12, "median": 90, "sigma": 0.6, "min_len": 40, "max_len": 256,
              "sizes_seed": 3, "buckets": [64, 128, 256], "batch_size": 4}
TINY_LONG = dict(TINY_TRAIN, n_slides=12, median=1200, min_len=600, max_len=2048, buckets=[1024, 2048])
REAL = {"tiny_mhim_transmil_c16.tiny_train": "mhim_transmil_c16.train_mix",
        "tiny_transmil_c16.tiny_train": "transmil_c16.train_mix",
        "tiny_mhim_transmil_c16.tiny_serve": "mhim_transmil_c16.serve_cohort",
        "tiny_mhim_transmil_c16.tiny_long": "mhim_transmil_c16.train_mix"}
TINY_SERVE = {"mode": "serve", "n_slides": 6, "median": 90, "sigma": 0.6, "min_len": 40, "max_len": 256, "rate_per_s": 20,
              "sizes_seed": 3, "sample": 3}


def checkout(tmp: Path) -> Path:
    """``tmp`` as a checkout: the repository's ``BENCHMARK.json`` and
    ``benchmark/``, plus both configurations at fp32 on short bags, tiny
    mixes, their cells and tight limits, and a metric that reads the
    window's steps."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    for name in ("mhim_transmil_c16", "transmil_c16"):
        conf = json.loads((bench / "configs" / f"{name}.json").read_text())
        conf["program"].update(TINY, compute_dtype="float32")
        (bench / "configs" / f"tiny_{name}.json").write_text(json.dumps(conf))
        man["configs"].append({"name": f"tiny_{name}", "source": "https://example.org", "reduced": [],
                               "file": f"benchmark/configs/tiny_{name}.json", "why": "a CPU rehearsal"})
    (bench / "traffic" / "tiny_train.json").write_text(json.dumps(TINY_TRAIN))
    (bench / "traffic" / "tiny_serve.json").write_text(json.dumps(TINY_SERVE))
    (bench / "traffic" / "tiny_long.json").write_text(json.dumps(TINY_LONG))
    cells = {"tiny_mhim_transmil_c16.tiny_train": ("tiny_mhim_transmil_c16", "tiny_train"),
             "tiny_transmil_c16.tiny_train": ("tiny_transmil_c16", "tiny_train"),
             "tiny_mhim_transmil_c16.tiny_serve": ("tiny_mhim_transmil_c16", "tiny_serve"),
             "tiny_mhim_transmil_c16.tiny_long": ("tiny_mhim_transmil_c16", "tiny_long")}
    for cell, (cfg, mix) in cells.items():
        man["workloads"].append({"name": cell, "config": cfg, "traffic": mix, "chips": 1, "why": "a CPU rehearsal"})
        lim = {"logits": 1e-4} if mix == "tiny_serve" else {"loss": 1e-4, "grad1": 1e-3, "change3": 1e-2}
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    for m in man["end_to_end"] + man["per_layer"]:  # each tiny cell reports what its real cell reports
        if "workloads" in m:
            m["workloads"] += [c for c in cells if REAL[c] in m["workloads"]]
    man["per_layer"].append({"name": "tiny_steps", "unit": "steps", "better": "higher", "source": "program_counter",
                             "layer": "Device", "moves": "setup_s", "workloads": list(cells)})
    (bench / "metrics" / "tiny_steps.py").write_text(
        '"""Steps or requests in the traced window."""\n\n\ndef read(run):\n'
        '    return sum(run.traced_buckets.values()) or None\n')
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root
