"""DSMIL, the dual-stream MIL of Li et al. 2021 (port of
``mhim_mil_tpu/models/dsmil.py``): the ``dsmil`` zoo model and the head of
MHIM's ``dsmil`` baseline.

Reference: modules/dsmil.py:59-172 and modules/mhim_modules/baseline.py:112-194.
The critical-instance argmax and the softmax over the instances count the
valid instances only.

Under a mesh that splits the instances (``parallel/mesh.py``, ``sp > 1``)
the features and mask are this rank's block (layout ``seq``): each class's
critical instance is the whole bag's first argmax (``sp_argmax``), its
features come from the rank that holds it (``sp_pick``), the softmax over
the instances and the bag sum run over the sp row, and the max-pooled
instance logits are the row's max with its ties split over the row
(``masked_max(sharded=True)``). The logits and the ``[B,C,D]`` bag feature
are the whole bag's on every rank; ``attn`` is this block's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import NEG_INF, masked_max, masked_softmax
from ..parallel.mesh import Seq, seq_layout, sp_argmax, sp_pick, sp_sum
from .layers import FeatureEmbed, dense


class BClassifier(nn.Module):
    """The bag head (``dsmil.py:20-82``): the queries of every instance and of
    each class's critical instance, the attention of the instances to them
    (a softmax over the valid instances), the attention-weighted bag feature
    ``[B,C,D]`` and ``fcc``, the reference's ``Conv1d(C, C, kernel_size=D)``
    over it (a dense map of the flattened ``[C·D]``). The names are the
    reference's: ``q.0``, ``q.2`` (``Linear, ReLU, Linear, Tanh``), ``v.1``
    (``Dropout, Linear, ReLU``; its dropout is 0 in every caller, as in
    JAX's) and ``fcc``."""

    def __init__(self, dim: int = 512, n_classes: int = 2, use_bias: bool = True):
        super().__init__()
        self.dim, self.n_classes = dim, n_classes
        self.q = nn.Sequential(dense(dim, 128, use_bias), nn.ReLU(), dense(128, 128), nn.Tanh())
        self.v = nn.Sequential(nn.Identity(), dense(dim, dim, use_bias), nn.ReLU())
        self.fcc = nn.Conv1d(n_classes, n_classes, kernel_size=dim, bias=use_bias)

    @torch.no_grad()
    def init_own(self, generator: torch.Generator):
        """``fcc`` as JAX initialises its dense ``[C·D] → [C]``: xavier-normal
        over those fans, zero bias."""
        c, d = self.n_classes, self.dim
        self.fcc.weight.normal_(0.0, math.sqrt(2.0 / (c * d + c)), generator=generator)
        if self.fcc.bias is not None:
            self.fcc.bias.zero_()

    def forward(self, feats: torch.Tensor, classes: torch.Tensor, mask: torch.Tensor, no_norm: bool = False,
                seq: Optional[Seq] = None):
        """``(logits[B,C], attention[B,N,C], bag[B,C,D])``: the attention
        softmaxed over the instances, or before the softmax with
        ``no_norm`` (the bag feature always takes the softmaxed one).
        ``seq``: the layout of the instances sharded over the active sp
        row (see the module's docstring)."""
        b = feats.shape[0]
        mask = mask.bool()
        v = self.v(feats)
        q = self.q(feats)  # [B,N,128]
        # the critical instance of each class: the first of the valid
        # instances with the largest score, as jnp.argmax breaks ties
        crit = sp_argmax(torch.where(mask[..., None], classes, NEG_INF), seq, 1)  # [B,C]
        m_feats = sp_pick(feats, crit, seq)  # [B,C,D]
        a = torch.einsum("bnq,bcq->bnc", q, self.q(m_feats)) / math.sqrt(128.0)
        a_soft = masked_softmax(a, mask[..., None], dim=1, sharded=seq is not None)
        bag = torch.einsum("bnc,bnd->bcd", a_soft, torch.where(mask[..., None], v, 0))
        if seq is not None:
            bag = sp_sum(bag)
        logits = F.linear(bag.reshape(b, -1), self.fcc.weight.reshape(self.n_classes, -1), self.fcc.bias)
        return logits, (a if no_norm else a_soft), bag


class DSMILHead(nn.Module):
    """MHIM's ``dsmil`` baseline over embedded features (``dsmil.py:85-119``):
    the instance classifier ``i_classifier.0`` and the bag head
    ``b_classifier``. Returns the bag logits, the max-pooled instance
    logits, the ``[B,C,D]`` bag feature and, with ``return_attn``, the
    mining score: each valid instance's largest class logit under
    ``cls_attn``, else its largest attention; 0 at masked instances."""

    def __init__(self, dim: int = 512, n_classes: int = 2, cls_attn: bool = True):
        super().__init__()
        self.cls_attn = cls_attn
        self.i_classifier = nn.Sequential(dense(dim, n_classes))
        self.b_classifier = BClassifier(dim, n_classes)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, return_attn: bool = False,
                training: bool = False, gen: Optional[torch.Generator] = None, no_norm: bool = False,
                seq: Optional[Seq] = None):
        mask = mask.bool()
        classes = self.i_classifier(x)  # [B,N,C]
        bag_logits, a, bag_feat = self.b_classifier(x, classes, mask, no_norm, seq)
        out = {"bag_logits": bag_logits,
               "inst_logits": masked_max(classes, mask[..., None], dim=1, sharded=seq is not None),
               "bag_feat": bag_feat}
        if return_attn:
            src = classes if self.cls_attn else a
            attn = torch.where(mask[..., None], src, NEG_INF).amax(dim=-1)
            out["attn"] = torch.where(mask, attn, 0)
        return out


class DSMIL(nn.Module):
    """The ``dsmil`` zoo model (``dsmil.py:122-162``): ``in_norm`` (with
    ``mil_norm="ln"``), the embed ``feature.0`` + act + dropout, the
    instance classifier ``i_classifier`` and the bag head ``b_classifier``.
    It returns the bag logits as ``logits`` and the max-pooled instance
    logits as ``inst_logits_bag``: the train step adds their loss to
    ``aux_loss``, and evaluation fuses ``0.5·logits + 0.5·inst_logits_bag``
    on the host (the model does not)."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, inner_dim: int = 512,
                 dropout: float = 0.25, act: str = "relu", mil_norm: Optional[str] = None,
                 mil_bias: bool = True):
        super().__init__()
        self.mil_norm = mil_norm
        if mil_norm == "ln":
            self.in_norm = nn.LayerNorm(input_dim, eps=1e-5, bias=mil_bias)
        self.feature = FeatureEmbed(input_dim, inner_dim, act, dropout, mil_bias)
        self.i_classifier = dense(inner_dim, n_classes, mil_bias)
        self.b_classifier = BClassifier(inner_dim, n_classes, use_bias=mil_bias)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, return_attn: bool = False):
        mask = mask.bool()
        seq = seq_layout(feats.shape[1], feats.device)
        x = self.in_norm(feats) if self.mil_norm == "ln" else feats
        x = self.feature(x, training, gen, seq)
        classes = self.i_classifier(x)
        bag_logits, _, bag_feat = self.b_classifier(x, classes, mask, seq=seq)
        out = {"logits": bag_logits,
               "inst_logits_bag": masked_max(classes, mask[..., None], dim=1, sharded=seq is not None),
               "bag_feat": bag_feat.reshape(feats.shape[0], -1)}
        if return_attn:
            attn = torch.where(mask[..., None], classes, NEG_INF).amax(dim=-1)
            out["attn"] = torch.where(mask, attn, 0)
        return out
