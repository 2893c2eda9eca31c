"""Loss functions (port of ``mhim_mil_tpu/engine/losses.py``).

All run in fp32 whatever the compute dtype. ``weights`` marks the real bags
of a batch: the zero-padded fake bags of a short final batch count for
nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import active as active_mesh, batch_sum, owner_weight

Tensor = torch.Tensor


def _wmean(per_example: Tensor, weights: Optional[Tensor]) -> Tensor:
    """The weighted mean over the bags. Under an active mesh, this rank's
    weighted sum over the weight sum of the whole batch (``batch_sum``):
    the ranks' terms add up to the one-process mean. Under sp each bag
    counts on one rank of its row (``owner_weight``: the others hold the
    same bag-level values and weigh them 0)."""
    if active_mesh() is not None:
        w = torch.ones_like(per_example) if weights is None else weights.float()
        w = w * owner_weight()
        return (per_example * w).sum() / batch_sum(w.sum()).clamp_min(1.0)
    if weights is None:
        return per_example.mean()
    w = weights.float()
    return (per_example * w).sum() / w.sum().clamp_min(1.0)


def cross_entropy(logits: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Mean CE over the bags; ``labels`` are int class ids."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return _wmean(nll, weights)


def bce_with_logits(logits: Tensor, labels: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """BCE with logits against one-hot labels (reference train_utils.py:42-43)."""
    logits = logits.float()
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    per = logits.clamp_min(0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    return _wmean(per.mean(dim=-1), weights)


def soft_target_ce(student: Tensor, teacher: Tensor, temp_t: float = 1.0, temp_s: float = 1.0,
                   weights: Optional[Tensor] = None) -> Tensor:
    """MHIM consistency loss ``-softmax(teacher/Tt) · log_softmax(student/Ts)``
    over feature vectors (reference mhim_modules/losses.py:26-45). The caller
    passes a teacher without a graph."""
    t = F.softmax(teacher.float() / temp_t, dim=-1)
    ls = F.log_softmax(student.float() / temp_s, dim=-1)
    return _wmean((-t * ls).sum(dim=-1), weights)


def nll_surv_loss(logits: Tensor, y_bin: Tensor, censorship: Tensor, alpha: float = 0.0,
                  eps: float = 1e-7, weights: Optional[Tensor] = None) -> Tensor:
    """Discrete-hazard negative log-likelihood for survival (reference
    train_utils.py:8-37): ``S = cumprod(1 − sigmoid(logits))``; uncensored
    bags pay ``−log S(y−1) − log h(y)``, censored ones ``−log S(y)``."""
    logits = logits.float()
    y = y_bin.long()[:, None]
    c = censorship.float()[:, None]
    hazards = torch.sigmoid(logits)
    s = torch.cumprod(1.0 - hazards, dim=1)
    s_padded = torch.cat([torch.ones_like(c), s], dim=1)
    s_prev = torch.gather(s_padded, 1, y)
    h_y = torch.gather(hazards, 1, y)
    s_y = torch.gather(s_padded, 1, y + 1)
    uncensored = -(1.0 - c) * (torch.log(s_prev.clamp_min(eps)) + torch.log(h_y.clamp_min(eps)))
    censored = -c * torch.log(s_y.clamp_min(eps))
    loss = (1.0 - alpha) * (censored + uncensored) + alpha * uncensored
    return _wmean(loss[:, 0], weights)


def surv_risk(logits: Tensor) -> Tensor:
    """Risk score for the c-index, ``−Σ cumprod(1 − sigmoid(logits))``
    (reference engines/base_engine.py:636-649). fp32."""
    s = torch.cumprod(1.0 - torch.sigmoid(logits.float()), dim=1)
    return -s.sum(dim=1)


def build_criterion(cfg) -> Callable[[Tensor, Dict[str, Tensor]], Tensor]:
    """``fn(logits, batch) -> scalar`` keyed by ``cfg.loss`` (reference train_utils.py:41-48)."""
    if cfg.loss == "ce":
        return lambda logits, batch: cross_entropy(logits, batch["target"], batch.get("bag_valid"))
    if cfg.loss == "bce":
        return lambda logits, batch: bce_with_logits(logits, batch["target"], batch.get("bag_valid"))
    if cfg.loss == "nll_surv":
        return lambda logits, batch: nll_surv_loss(
            logits, batch["target"], batch["censorship"], alpha=0.0, weights=batch.get("bag_valid"))
    raise NotImplementedError(cfg.loss)
