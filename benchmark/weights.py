"""The weights of a cell, made on the device from the run's seed.

The reference's ``param_spec`` names every leaf with its shape and its
initialisation (``xavier``: xavier-normal, gain 1; ``normal:<std>``;
``uniform:<a>``: U(−a, a); ``zeros``; ``ones``). All the normal leaves
come from one ``torch.randn`` of their total size and all the uniform ones
from one ``torch.rand``, on a generator of the card, in fp32 (the type the
program keeps its parameters in). The same dict goes to the program and to
the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .reference.common import xavier_std


def make(spec: List[Tuple], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    normal = sum(n for n, (_, _, init) in zip(sizes, spec) if init == "xavier" or init.startswith("normal:"))
    uniform = sum(n for n, (_, _, init) in zip(sizes, spec) if init.startswith("uniform:"))
    z = torch.randn(normal, generator=gen, device=device)
    u = torch.rand(uniform, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    zi = ui = 0
    for (name, shape, init), n in zip(spec, sizes):
        if init == "xavier" or init.startswith("normal:"):
            std = xavier_std(shape) if init == "xavier" else float(init.split(":", 1)[1])
            out[name] = (z[zi:zi + n] * std).view(shape)
            zi += n
        elif init.startswith("uniform:"):
            a = float(init.split(":", 1)[1])
            out[name] = ((u[ui:ui + n] * 2 - 1) * a).view(shape)
            ui += n
        elif init in ("zeros", "ones"):
            out[name] = (torch.zeros if init == "zeros" else torch.ones)(shape, device=device)
        else:
            raise ValueError(f"{name}: unknown initialisation {init!r}")
    return out
