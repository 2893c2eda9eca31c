"""Command line of the port: ``python3 -m mhim_mil_torch.main -c config/mhim_c16.yaml ...``

The flags are those of ``main.py`` (the reference's names; ``-c a.yaml,b.yaml``
merges presets in order, then flags override) on the port's
``load_config``, plus ``--device`` (``cuda``, the default, or ``cpu``),
taken off the arguments before the config is read. ``--debug`` turns on
``torch.autograd.set_detect_anomaly``, as in the reference. The results go
to ``<output_path>/<title>_results.json``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Tuple


def _take_device(argv: List[str]) -> Tuple[str, List[str]]:
    """``--device X`` or ``--device=X`` out of ``argv``; the default is cuda."""
    device, rest, i = "cuda", [], 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device needs a value: cuda or cpu")
            device, i = argv[i + 1], i + 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return device, rest


def main(argv: Optional[List[str]] = None) -> Dict:
    import torch

    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.engine.driver import run_experiment

    device, argv = _take_device(list(sys.argv[1:] if argv is None else argv))
    cfg = load_config(argv)
    if cfg.debug:  # reference engines/base_engine.py:122-123
        torch.autograd.set_detect_anomaly(True)
    results = run_experiment(cfg, device=device)
    if cfg.output_path:
        os.makedirs(cfg.output_path, exist_ok=True)
        path = os.path.join(cfg.output_path, f"{cfg.title}_results.json")
        with open(path, "w") as f:
            json.dump(results, f, indent=2, default=float)
        print(f"results written to {path}")
    return results


if __name__ == "__main__":
    main()
