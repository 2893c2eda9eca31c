"""Command line of the port: ``python3 -m mhim_mil_torch.main -c config/mhim_c16.yaml ...``

The flags are those of ``main.py`` (the reference's names; ``-c a.yaml,b.yaml``
merges presets in order, then flags override) on the port's
``load_config``, plus ``--device`` (``cuda``, the default, or ``cpu``),
taken off the arguments before the config is read. ``--debug`` turns on
``torch.autograd.set_detect_anomaly``, as in the reference. The results go
to ``<output_path>/<title>_results.json``.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the default process group is
initialised from the environment, unless one already is: on the card each
rank takes ``cuda:<LOCAL_RANK mod device count>``, with NCCL when the
node's ranks have a card each and gloo when they share cards (NCCL takes
one rank a device); gloo with ``--device cpu``. ``--mesh_dp`` then splits
each batch's bags over the ranks and ``--mesh_sp`` each bag's instances
(``engine/driver.py`` ``resolve_mesh``)::

    python -m torch.distributed.run --nproc_per_node 2 -m mhim_mil_torch.main --device cpu --mesh_dp 2 ...
    python -m torch.distributed.run --nproc_per_node 4 -m mhim_mil_torch.main --device cpu --mesh_dp 2 --mesh_sp 2 ...

Rank 0 alone writes the results.
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


PG_TIMEOUT_S = 300  # a rank that dies ends the run's collectives within this long


def _init_world(device: str) -> Tuple[str, bool]:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1), the default process group
    from the environment, unless one is already initialised; returns the
    rank's device and whether this call made the group."""
    import datetime

    import torch
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device, False
    timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0')) % cards}"
        torch.cuda.set_device(device)
        shared = int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > cards
        dist.init_process_group("gloo" if shared else "nccl", timeout=timeout)
    else:
        dist.init_process_group("gloo", timeout=timeout)
    return device, True


def main(argv: Optional[List[str]] = None) -> Dict:
    import torch
    import torch.distributed as dist

    from mhim_mil_torch.config import load_config
    from mhim_mil_torch.engine.driver import run_experiment

    device, argv = _take_device(list(sys.argv[1:] if argv is None else argv))
    cfg = load_config(argv)
    if cfg.debug:  # reference engines/base_engine.py:122-123
        torch.autograd.set_detect_anomaly(True)
    device, made = _init_world(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        results = run_experiment(cfg, device=device)
    finally:
        if made:
            dist.destroy_process_group()
    if cfg.output_path and rank == 0:
        os.makedirs(cfg.output_path, exist_ok=True)
        path = os.path.join(cfg.output_path, f"{cfg.title}_results.json")
        with open(path, "w") as f:
            json.dump(results, f, indent=2, default=float)
        print(f"results written to {path}")
    return results


if __name__ == "__main__":
    main()
