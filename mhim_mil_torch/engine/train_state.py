"""The train states and the optimizer factory (port of
``mhim_mil_tpu/engine/train_state.py`` and ``create_mhim_state`` in
``models/mhim.py``).

optax chains map onto torch optimizers as follows:

- ``adam``: ``add_decayed_weights`` then ``scale_by_adam`` is Adam with the
  decay added to the gradient, which is ``torch.optim.Adam(weight_decay=…)``;
- ``adamw``: decoupled decay, ``torch.optim.AdamW``;
- ``sgd``: coupled decay, ``torch.optim.SGD(weight_decay=…)``;
- ``clip_grad``: a global-norm clip of the raw gradients first, exactly as
  ``optax.clip_by_global_norm``;
- ``accumulation_steps`` k > 1: ``optax.MultiSteps(tx, k)`` around the
  chain, so the chain (clip included) sees the mean of k micro-steps'
  gradients and the parameters move on every k-th micro-step only.

The learning rate is the schedule's value at the count of updates made
before this one, as ``optax.scale_by_learning_rate`` reads the chain's own
count (which ``MultiSteps`` advances on every k-th micro-step only).
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
    """A torch optimizer driven by a step-indexed learning-rate schedule,
    with ``optax.MultiSteps``' gradient accumulation over
    ``cfg.accumulation_steps`` micro-steps. ``count`` is the number of
    updates made (the chain's count under ``MultiSteps``), ``mini_step`` the
    micro-steps gathered towards the next one."""

    def __init__(self, cfg, params: Iterable[torch.nn.Parameter], lr_schedule: Schedule):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr_schedule = lr_schedule
        self.clip: Optional[float] = cfg.clip_grad
        self.k = int(cfg.accumulation_steps)
        self.count, self.mini_step = 0, 0
        self.acc: Optional[List[torch.Tensor]] = None  # the running mean of the micro-steps' gradients
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
    def step(self) -> bool:
        """Take this micro-step's gradients. Under accumulation they join the
        running mean (``acc + (g − acc)/(n + 1)``, as ``MultiSteps``
        averages), and only the k-th micro-step updates, from that mean.
        An update clips, sets the learning rate for ``count`` and steps the
        optimizer in place. A parameter that took no gradient counts a zero
        one, as in optax: the coupled weight decay and the moments still move
        it. Returns whether the parameters moved."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.k > 1:
            grads = [p.grad for p in self.params]
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            torch._foreach_add_(self.acc, torch._foreach_div(torch._foreach_sub(grads, self.acc),
                                                             float(self.mini_step + 1)))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            for p, a in zip(self.params, self.acc):
                p.grad.copy_(a)
            self.mini_step = 0
            torch._foreach_zero_(self.acc)
        if self.clip is not None:
            grads = [p.grad for p in self.params]
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        lr = float(self.lr_schedule(self.count))
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return True

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The torch optimizer's state, the update count and, under
        accumulation, the micro-step and the running mean, so that a resumed
        run continues mid-accumulation."""
        return {"opt": self.opt.state_dict(), "count": self.count, "mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.detach().cpu() for a in self.acc]}

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd["opt"])
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        self.acc = None if sd["acc"] is None else [a.to(p.device) for a, p in zip(sd["acc"], self.params)]


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
