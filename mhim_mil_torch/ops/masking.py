"""Attention-ranked instance masking, MHIM's hard-instance mining (port of
``mhim_mil_tpu/ops/masking.py``).

The selection is a boolean mask over instances: True = selected for removal.
Every random choice takes its uniform draw as an argument (``u``, shaped like
the bag mask), so the caller owns the generator and a test can hand in the
JAX package's own uniforms. Counts are computed in float32 exactly as there:
``ceil(n·ratio − 1e-4)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .masked import random_subset_mask, topk_mask

Tensor = torch.Tensor


def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def select_mask(
    u: Tensor,
    attn: Tensor,
    valid: Tensor,
    mask_ratio,
    largest: bool,
    random_ratio=1.0,
    prev: Optional[Tensor] = None,
    msa_fusion: str = "vote",
) -> Tensor:
    """Select ``ceil(n_valid · ratio)`` instances by attention rank, then a
    uniform subsample of them drawn from ``u[B, N]`` (``masking.py:30-131``).

    ``attn`` is ``[B, N]`` or ``[B, H, N]`` (heads fused by ``vote`` or
    ``mean``); ``mask_ratio`` and ``random_ratio`` are Python floats or
    float32 scalars; ``prev`` joins an earlier selection by union.
    """
    valid = valid.bool()
    ps = valid.sum(dim=-1).float()

    # Static fast path: the enlarged pool saturates at every valid instance,
    # so the selection is a uniform subsample of ``valid`` (masking.py:80-91).
    if (
        isinstance(mask_ratio, (int, float))
        and isinstance(random_ratio, (int, float))
        and float(mask_ratio) / max(float(random_ratio), 1e-12) >= 1.0
    ):
        k_sub = torch.ceil(ps * min(float(mask_ratio), 1.0) - 1e-4).int()
        sel = random_subset_mask(u, valid, k_sub)
        if prev is not None:
            sel = sel | prev
        return sel & valid

    # The ratios stay 0-d float32 tensors where they are (the schedule's are on
    # the CPU): torch takes a 0-d CPU tensor into a device op as a scalar,
    # with no copy to the device and so no stream sync.
    mask_ratio = _f32(mask_ratio)
    random_ratio = _f32(random_ratio)
    eff = mask_ratio / random_ratio.clamp_min(1e-12)
    sub_ratio = torch.where(eff > 1.0, mask_ratio, random_ratio)
    eff = eff.clamp_max(1.0)
    k = torch.ceil(ps * eff - 1e-4).int()  # [B]

    if attn.dim() == 3:
        h = attn.shape[1]
        if msa_fusion == "vote":
            sel_h = topk_mask(attn, valid[:, None, :], k[:, None], largest=largest)
            votes = sel_h.sum(dim=1).float()
            sel = topk_mask(votes, valid, k, largest=True)
        elif msa_fusion == "mean":
            sel_h = topk_mask(attn, valid[:, None, :], (k // h)[:, None], largest=largest)
            sel = sel_h.any(dim=1)
        else:
            raise ValueError(f"unknown msa_fusion: {msa_fusion}")
    elif attn.dim() == 2:
        sel = topk_mask(attn, valid, k, largest=largest)
    else:
        raise ValueError(f"attn must be [B,N] or [B,H,N], got {tuple(attn.shape)}")

    pool_n = sel.sum(dim=-1).float()
    k_sub = torch.ceil(pool_n * sub_ratio.clamp_max(1.0) - 1e-4).int()
    sel = random_subset_mask(u, sel, k_sub)
    if prev is not None:
        sel = sel | prev
    return sel & valid


@dataclasses.dataclass(frozen=True)
class MaskSchedule:
    """MHIM's masking knobs (reference modules/mhim.py:55-61): ``mask_ratio``
    (random), ``mask_ratio_l`` (low attention), ``mask_ratio_h`` (high
    attention, optionally scheduled) and ``mask_ratio_hr`` (the random pool
    ratio of the high stage)."""

    mask_ratio: float = 0.0
    mask_ratio_l: float = 0.0
    mask_ratio_h: float = 0.0
    mask_ratio_hr: float = 1.0
    msa_fusion: str = "vote"

    def stages(self, scheduled: bool = False) -> tuple:
        """Which of the three stages run: random, low, high. The high stage runs
        when its ratio is positive or a schedule drives it."""
        return (self.mask_ratio > 0.0, self.mask_ratio_l > 0.0, scheduled or self.mask_ratio_h > 0.0)


def layered_mask(
    u: Sequence[Optional[Tensor]],
    attn: Optional[Tensor],
    valid: Tensor,
    sched: MaskSchedule,
    mask_ratio_h_now=None,
) -> Tensor:
    """MHIM's three mask stages composed by union (``masking.py:153-201``):
    random at ``mask_ratio``, low attention at ``mask_ratio_l``, high
    attention at the scheduled ``mask_ratio_h``. ``u`` holds the three
    stages' uniform draws ``[B, N]``, in that order (None for a stage that
    does not run). Returns the removal mask."""
    if attn is None:
        return torch.zeros_like(valid, dtype=torch.bool)
    random_on, low_on, high_on = sched.stages(mask_ratio_h_now is not None)
    removed = None
    if random_on:
        removed = select_mask(u[0], attn, valid, sched.mask_ratio, largest=False,
                              random_ratio=0.001, msa_fusion=sched.msa_fusion)
    if low_on:
        removed = select_mask(u[1], attn, valid, sched.mask_ratio_l, largest=False,
                              prev=removed, msa_fusion=sched.msa_fusion)
    if high_on:
        mrh = sched.mask_ratio_h if mask_ratio_h_now is None else mask_ratio_h_now
        removed = select_mask(u[2], attn, valid, mrh, largest=True,
                              random_ratio=sched.mask_ratio_hr if sched.mask_ratio_hr > 0 else 1.0,
                              prev=removed, msa_fusion=sched.msa_fusion)
    if removed is None:
        removed = torch.zeros_like(valid, dtype=torch.bool)
    return removed
