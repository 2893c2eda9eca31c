"""The train states and the optimizer factory (port of
``mhim_mil_tpu/engine/train_state.py`` and ``create_mhim_state`` in
``models/mhim.py``).

optax chains map onto torch optimizers as follows:

- ``adam``: ``add_decayed_weights`` then ``scale_by_adam`` is Adam with the
  decay added to the gradient, which is ``torch.optim.Adam(weight_decay=…)``;
- ``adamw``: decoupled decay, ``torch.optim.AdamW``;
- ``sgd``: coupled decay, ``torch.optim.SGD(weight_decay=…)``;
- ``clip_grad``: a global-norm clip of the raw gradients first, exactly as
  ``optax.clip_by_global_norm``.

The learning rate is the schedule's value at the step count before the
update, as ``optax.scale_by_learning_rate`` reads it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, List, Optional, Union

import torch
from torch import nn

from ..utils.platform import resolve_device
from ..utils.schedules import Schedule, make_lr_schedule


class Optimizer:
    """A torch optimizer driven by a step-indexed learning-rate schedule."""

    def __init__(self, cfg, params: Iterable[torch.nn.Parameter], lr_schedule: Schedule):
        if cfg.accumulation_steps > 1:
            raise NotImplementedError("accumulation_steps > 1 is not ported yet")
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr_schedule = lr_schedule
        self.clip: Optional[float] = cfg.clip_grad
        wd = cfg.weight_decay or 0.0
        if cfg.opt == "adam":
            self.opt = torch.optim.Adam(self.params, lr=0.0, weight_decay=wd, eps=1e-8)
        elif cfg.opt == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr=0.0, weight_decay=wd, eps=1e-8)
        elif cfg.opt == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=0.0, weight_decay=wd)
        else:
            raise NotImplementedError(cfg.opt)

    @torch.no_grad()
    def step(self, step_count: int) -> None:
        """Clip, set the learning rate for ``step_count`` and update in place.
        A parameter that took no gradient counts a zero one, as in optax: the
        coupled weight decay and the moments still move it."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip is not None:
            grads = [p.grad for p in self.params]
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        lr = float(self.lr_schedule(step_count))
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.opt.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd)


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter], lr_schedule: Schedule) -> Optimizer:
    """Optimizer factory (reference train_utils.py:58-69)."""
    return Optimizer(cfg, params, lr_schedule)


@dataclasses.dataclass
class TrainState:
    """What a train step carries from one step to the next: the step count,
    the student (fp32 master weights and, for MHIM, the Merge
    ``global_q_mm`` buffer), the EMA teacher (always for MHIM; for the
    generic step only under ``model_ema``, else None), the optimizer and the
    step's own generator, which draws every random number of a step
    (mining, merge split, dropout) on the model's device."""

    step: int
    model: nn.Module
    teacher: Optional[nn.Module]
    optimizer: Optimizer
    gen: torch.Generator



def create_mhim_state(cfg, model: nn.Module, steps_per_epoch: int, seed: Optional[int] = None,
                      teacher: Optional[nn.Module] = None,
                      device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """The train state of ``model`` on ``device`` (CUDA unless ``"cpu"`` is
    asked for; the model must already be there). The teacher starts as a
    copy of the student unless one is given (a pretrained ``--teacher_init``);
    it takes no gradient. The generator is seeded with ``seed`` (default
    ``cfg.seed``)."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model is on {next(model.parameters()).device}, the state on {device}")
    teacher = copy.deepcopy(model) if teacher is None else teacher
    teacher.requires_grad_(False)
    optimizer = make_optimizer(cfg, model.parameters(), make_lr_schedule(cfg, steps_per_epoch))
    gen = torch.Generator(device=device).manual_seed(cfg.seed if seed is None else seed)
    return TrainState(0, model, teacher, optimizer, gen)


def create_train_state(cfg, model: nn.Module, steps_per_epoch: int, seed: Optional[int] = None,
                       device: Optional[Union[str, torch.device]] = None) -> TrainState:
    """The generic train state (``train_state.py:68-99``) of ``model`` on
    ``device``: an EMA teacher, a copy of the student that takes no
    gradient, only under ``cfg.model_ema``; the generator seeded with
    ``seed`` (default ``cfg.seed``)."""
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model is on {next(model.parameters()).device}, the state on {device}")
    teacher = copy.deepcopy(model).requires_grad_(False) if cfg.model_ema else None
    optimizer = make_optimizer(cfg, model.parameters(), make_lr_schedule(cfg, steps_per_epoch))
    gen = torch.Generator(device=device).manual_seed(cfg.seed if seed is None else seed)
    return TrainState(0, model, teacher, optimizer, gen)
