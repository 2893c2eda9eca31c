"""What the benchmark takes from the program: the system under test.

The program is the PyTorch and CUDA package ``mhim_mil_torch``. From it the
benchmark takes its config loader, its model factory, its train steps and
train states, and its ``Scorer``; nothing else. Every model of the port's
registry goes through the same three calls: the family that ``build_model``
returns picks the MHIM step (``mhim``, ``mhim_pure``) or the generic one,
and serving is the ``Scorer`` of that family.
"""

from __future__ import annotations

from typing import Dict

import torch


def config(fields: Dict):
    """The program's config from a configuration file's ``program`` fields."""
    from mhim_mil_torch.config import load_config

    argv = []
    for k, v in fields.items():
        if isinstance(v, (list, tuple)):
            v = ",".join(str(x) for x in v)
        argv.append(f"--{k}={v}")
    return load_config(argv)


class Program:
    """The model of a configuration, holding the benchmark's weights."""

    def __init__(self, fields: Dict, weights: Dict[str, torch.Tensor], device: torch.device):
        from mhim_mil_torch.models import build_model

        self.cfg = config(fields)
        self.device = device
        # build_model draws its own initialisation on the host; it is overwritten at once
        self.model, self.family = build_model(self.cfg, device=device, generator=torch.Generator().manual_seed(0))
        self.model.load_state_dict(weights, strict=True)

    def train(self, steps_per_epoch: int, seed: int):
        """``(state, step)``: the train state (its generator seeded with
        ``seed``) and the family's train step; ``step(state, batch)``."""
        from mhim_mil_torch.engine import steps, train_state

        if self.family in ("mhim", "mhim_pure"):
            state = train_state.create_mhim_state(self.cfg, self.model, steps_per_epoch, seed=seed, device=self.device)
            return state, steps.make_mhim_train_step(self.cfg, steps_per_epoch, device=self.device)
        state = train_state.create_train_state(self.cfg, self.model, steps_per_epoch, seed=seed, device=self.device)
        return state, steps.make_train_step(self.cfg, self.family, steps_per_epoch, device=self.device)

    def scorer(self):
        """The family's ``Scorer`` over the configuration's buckets."""
        from mhim_mil_torch.utils.serving import Scorer

        return Scorer(self.cfg, self.model, buckets=self.cfg.bucket_sizes, device=self.device, family=self.family)


def adam_first_moments(state) -> Dict[str, torch.Tensor]:
    """Adam's first moment of each student leaf, by name."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    opt = state.optimizer.opt
    return {names[id(p)]: opt.state[p]["exp_avg"].detach().clone()
            for group in opt.param_groups for p in group["params"] if p in opt.state}


def adam_betas(state):
    return state.optimizer.opt.param_groups[0]["betas"]


def snapshot(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copies of the student's parameters and buffers and of the teacher's parameters."""
    out = {"student": {n: t.detach().clone() for n, t in state.model.state_dict().items()}}
    if state.teacher is not None:
        out["teacher"] = {n: p.detach().clone() for n, p in state.teacher.named_parameters()}
    return out
