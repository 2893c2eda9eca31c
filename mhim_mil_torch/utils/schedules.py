"""Step-indexed schedules (port of ``mhim_mil_tpu/utils/schedules.py``).

Each schedule is a function of the step count that returns a float32 scalar
tensor on the CPU, computed in float32 as the JAX package computes it, so
that counts derived from it (the mining stage's ``ceil(n·ratio)``) agree
exactly.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_value, final_value, total_steps, warmup_steps=0, warmup_start=0.0) -> Schedule:
    """Linear warmup, then a half cosine from ``base_value`` to ``final_value``
    over ``total_steps - warmup_steps`` steps (reference utils.py:199-210)."""
    total_steps = max(int(total_steps), 1)
    decay_steps = max(total_steps - warmup_steps, 1)

    def fn(step) -> torch.Tensor:
        step = _f32(step)
        warm = warmup_start + (base_value - warmup_start) * step / max(warmup_steps, 1)
        t = ((step - warmup_steps) / decay_steps).clamp(0.0, 1.0)
        cos = final_value + 0.5 * (base_value - final_value) * (1 + torch.cos(_f32(math.pi) * t))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def make_lr_schedule(cfg, steps_per_epoch: int) -> Schedule:
    """The learning rate by step (reference train_utils.py:70-82): ``cosine``
    to 1e-7 with warmup, ``step`` (×0.2 at half the epochs) or ``const``.
    Without ``lr_supi`` the schedule holds still within an epoch."""
    total_iters = cfg.num_epoch * steps_per_epoch
    warmup_iters = cfg.warmup_epochs * steps_per_epoch

    if cfg.lr_sche == "cosine":
        base = cosine_schedule(cfg.lr, 1e-7, total_iters, warmup_iters, cfg.warmup_lr)
    elif cfg.lr_sche == "step":
        half = max(1, (cfg.num_epoch // 2) * steps_per_epoch)

        def base(step):
            return cfg.lr * torch.pow(_f32(0.2), _f32(step) // half)

    elif cfg.lr_sche == "const":
        def base(step):
            return _f32(cfg.lr)

    else:
        raise NotImplementedError(cfg.lr_sche)

    if cfg.lr_supi:
        return base

    def epochwise(step):
        return base((int(step) // steps_per_epoch) * steps_per_epoch)

    return epochwise
