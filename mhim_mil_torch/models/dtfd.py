"""DTFD-MIL, the two-tier distillation over pseudo-bags (port of
``mhim_mil_tpu/models/dtfd.py``).

Reference: modules/dtfd.py:28-273. The bag's valid instances split into
``group`` contiguous pseudo-bags by ``np.array_split`` of their ranks;
tier 1 pools each pseudo-bag with gated attention and classifies it; one
feature per pseudo-bag is distilled (``AFS``: its attention-pooled
feature; ``MaxS``: its instance of the highest last-class CAM
probability; ``MaxMinS``: that one and the lowest); tier 2 pools the
distilled features with gated attention and classifies the bag. As in the
JAX package, tier 1 is supervised by an explicit loss on the pseudo-bag
predictions that the train step adds (the model returns them in
training), and evaluation chunks the bag the same deterministic way.

Under a mesh that splits the instances (``parallel/mesh.py``, ``sp > 1``)
``feats`` and ``mask`` are this rank's block: each instance's pseudo-bag
comes from its rank among the whole bag's valid instances, tier 1's
softmaxes and sums run over the sp row, ``MaxS`` and ``MaxMinS`` pick the
instance of the lowest global index among ties over the whole row and
fetch it from its owner, and tier 2 runs on the ``[B, G(·2), D]``
pseudo-features that every rank of the row holds.

The names are the reference's: ``dimReduction.fc1``, ``attention``
(``attention_V.0``, ``attention_U.0``, ``attention_weights``),
``classifier.fc``, ``UClassifier.attention`` and ``UClassifier.classifier.fc``.
The dropout rate is 0.25 at its three places whatever the config says.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.masked import NEG_INF, masked_softmax
from ..parallel.mesh import Seq, seq_layout, sp_argmax, sp_gather, sp_pick, sp_sum
from .layers import Dropout, dense, get_act

DROPOUT = 0.25


class GatedAttention(nn.Module):
    """tanh × sigmoid gated attention logits ``[..., N]`` (``dtfd.py:30-40``)."""

    def __init__(self, dim: int, attn_dim: int = 128):
        super().__init__()
        self.attention_V = nn.Sequential(dense(dim, attn_dim), nn.Tanh())
        self.attention_U = nn.Sequential(dense(dim, attn_dim), nn.Sigmoid())
        self.attention_weights = dense(attn_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention_weights(self.attention_V(x) * self.attention_U(x))[..., 0]


class DimReduction(nn.Module):
    """The bias-free embed ``fc1``, the activation and dropout."""

    def __init__(self, input_dim: int, inner_dim: int, act: str):
        super().__init__()
        self.fc1 = dense(input_dim, inner_dim, use_bias=False)
        self.act = get_act(act)
        self.drop = Dropout(DROPOUT)

    def forward(self, x, training: bool = False, gen: Optional[torch.Generator] = None, seq: Optional[Seq] = None):
        return self.drop(self.act(self.fc1(x)), training, gen, seq)


class Classifier1fc(nn.Module):
    """Dropout, then the linear head ``fc``."""

    def __init__(self, dim: int, n_classes: int):
        super().__init__()
        self.fc = dense(dim, n_classes)
        self.drop = Dropout(DROPOUT)

    def forward(self, x, training: bool = False, gen: Optional[torch.Generator] = None):
        return self.fc(self.drop(x, training, gen))


def pseudo_bag_ids(mask: torch.Tensor, group: int, seq: Optional[Seq] = None) -> torch.Tensor:
    """The pseudo-bag of each position ``[B, N]`` (int64): its valid rank
    split by ``np.array_split`` into ``group`` chunks, the first
    ``n_valid % group`` one longer (``dtfd.py:62-77``). Masked positions get
    an id too; the caller masks them out. An empty bag counts as one
    instance, so that no division is by zero. Given the layout ``seq`` of
    instances sharded over the active sp row, ``mask`` is this rank's block:
    the valid rank is the whole bag's (the block's own plus the valid
    count of the blocks before it) and ``n_valid`` the whole bag's, from
    the row's gathered block counts; no instance moves."""
    rank = torch.cumsum(mask.long(), dim=-1) - 1
    n_valid = mask.sum(dim=-1, keepdim=True)
    if seq is not None:
        counts = sp_gather(n_valid, Seq((1,) * len(seq.counts), seq.index))  # [B, sp]
        rank = rank + counts[:, :seq.index].sum(dim=-1, keepdim=True)
        n_valid = counts.sum(dim=-1, keepdim=True)
    n_valid = n_valid.clamp_min(1)
    small, rem = n_valid // group, n_valid % group
    boundary = rem * (small + 1)
    gid = torch.where(rank < boundary, rank // (small + 1), rem + (rank - boundary) // small.clamp_min(1))
    return gid.clamp(0, group - 1)


class DTFD(nn.Module):
    """``dtfd`` (``dtfd.py:43-134``); ``distill`` is ``AFS``, ``MaxS`` or ``MaxMinS``."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, inner_dim: int = 512, group: int = 5,
                 distill: str = "AFS", act: str = "relu"):
        super().__init__()
        if distill not in ("AFS", "MaxS", "MaxMinS"):
            raise ValueError(f"distill must be AFS, MaxS or MaxMinS, not {distill!r}")
        self.group, self.distill = group, distill
        self.dimReduction = DimReduction(input_dim, inner_dim, act)
        self.attention = GatedAttention(inner_dim)
        self.classifier = Classifier1fc(inner_dim, n_classes)
        self.UClassifier = nn.Module()  # the tier-2 layers
        self.UClassifier.attention = GatedAttention(inner_dim)
        self.UClassifier.classifier = Classifier1fc(inner_dim, n_classes)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, return_attn: bool = False):
        """``{"logits", "bag_feat"[, "sub_preds" [B,G,C], "sub_preds_mask"
        [B,G] in training][, "attn" [B,N]]}``."""
        mask = mask.bool()
        g = self.group
        seq = seq_layout(feats.shape[1], feats.device)
        x = self.dimReduction(feats, training, gen, seq)
        gid = pseudo_bag_ids(mask, g, seq)
        group_mask = (gid[:, None, :] == torch.arange(g, device=x.device)[None, :, None]) & mask[:, None, :]
        filled = group_mask.any(dim=-1) if seq is None else sp_sum(group_mask.sum(dim=-1)) > 0  # [B,G]

        # tier 1: attention within each pseudo-bag
        attn_logits = self.attention(x)  # [B,N]
        attn = masked_softmax(attn_logits[:, None, :].expand(group_mask.shape), group_mask,
                              sharded=seq is not None)  # [B,G,N]
        att_feat = torch.einsum("bgn,bnd->bgd", attn, torch.where(mask[..., None], x, 0))
        if seq is not None:
            att_feat = sp_sum(att_feat)
        sub_preds = self.classifier(att_feat, training, gen)  # [B,G,C]

        if self.distill == "AFS":
            pseudo, pseudo_mask = att_feat, filled
        else:
            # the CAM (reference get_cam_1d, dtfd.py:28-31): the classifier's
            # weight only, its bias taken off through a zero probe
            fc = self.classifier.fc
            base = fc(x) - fc(torch.zeros((1, 1, x.shape[-1]), dtype=x.dtype, device=x.device))
            prob_last = torch.softmax(attn[..., None] * base[:, None], dim=-1)[..., -1]  # [B,G,N]
            # argmax and argmin take the first global index among ties, as
            # jnp's do; the argmin as the argmax of the negated scores
            top = sp_argmax(torch.where(group_mask, prob_last, NEG_INF), seq, dim=-1)  # [B,G]
            pseudo, pseudo_mask = sp_pick(x, top, seq), filled
            if self.distill == "MaxMinS":
                bottom = sp_argmax(-torch.where(group_mask, prob_last, -NEG_INF), seq, dim=-1)
                pseudo = torch.cat([pseudo, sp_pick(x, bottom, seq)], dim=1)  # [B,2G,D]
                pseudo_mask = filled.repeat(1, 2)

        # tier 2 (reference Attention_with_Classifier, dtfd.py:92-102)
        u = self.UClassifier
        u_attn = masked_softmax(u.attention(pseudo), pseudo_mask)
        u_feat = torch.einsum("bg,bgd->bd", u_attn, pseudo)
        out = {"logits": u.classifier(u_feat, training, gen), "bag_feat": u_feat}
        if training:
            out["sub_preds"], out["sub_preds_mask"] = sub_preds, filled
        if return_attn:
            out["attn"] = attn.sum(dim=1)  # the union of the pseudo-bags' attentions (this block's)
        return out
