"""IBMIL, ABMIL deconfounded by a prototype bank (port of
``mhim_mil_tpu/models/ibmil.py``).

Reference: modules/abmil_ibmil.py:43-101. The confounder bank (k-means
prototypes of bag features, ``utils/confounders.py``) is a fixed fp32
buffer ``confounder_feat``; the bag feature queries it in a ``joint_dim``
space, softmax over the prototypes at scale ``1/sqrt(joint_dim)``, and the
attended prototype summary is concatenated to the bag feature before the
head. The names are the reference's: ``embedding.embed.0``,
``attention.{0,2}``, ``W_q``, ``W_k``, ``head``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.masked import masked_softmax
from ..parallel.mesh import seq_layout, sp_sum
from .layers import FeatureEmbed, dense, promoted_linear


class IBMIL(nn.Module):
    """``ibmil`` (``ibmil.py:23-57``): embed, the tanh attention pool of
    width ``attn_dim``, then, with a bank ``confounders [K, inner_dim]``,
    the deconfounding summary, and the linear head."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, inner_dim: int = 512, attn_dim: int = 128,
                 dropout: float = 0.25, act: str = "relu", confounders: Optional[np.ndarray] = None,
                 joint_dim: int = 128):
        super().__init__()
        self.joint_dim = joint_dim
        self.embedding = nn.Module()  # the reference's wrapper of the feature MLP ``embed``
        self.embedding.embed = FeatureEmbed(input_dim, inner_dim, act, dropout)
        self.attention = nn.Sequential(dense(inner_dim, attn_dim), nn.Tanh(), dense(attn_dim, 1))
        head_dim = inner_dim
        if confounders is not None:
            bank = torch.as_tensor(np.asarray(confounders, np.float32))
            self.register_buffer("confounder_feat", bank)
            self.W_q = dense(inner_dim, joint_dim)
            self.W_k = dense(bank.shape[-1], joint_dim)
            head_dim += bank.shape[-1]
        self.head = dense(head_dim, n_classes)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, return_attn: bool = False):
        """``{"logits", "bag_feat"[, "attn" [B,N]]}``. Under a mesh that
        splits the instances (``parallel/mesh.py``, ``sp > 1``) ``feats`` and
        ``mask`` are this rank's block: the attention's softmax and the
        weighted sum run over the sp row, the bag feature and logits are the
        whole bag's on every rank and ``attn`` is this block's; the
        confounder attention is bag-level."""
        mask = mask.bool()
        seq = seq_layout(feats.shape[1], feats.device)
        x = self.embedding.embed(feats, training, gen, seq)
        attn = masked_softmax(self.attention(x)[..., 0], mask, sharded=seq is not None)
        bag = torch.einsum("bn,bnd->bd", attn, torch.where(mask[..., None], x, 0))
        if seq is not None:
            bag = sp_sum(bag)
        if hasattr(self, "confounder_feat"):
            conf = self.confounder_feat.float()
            q = self.W_q(bag)  # [B,J]
            k = promoted_linear(self.W_k, conf)  # [K,J]
            da = torch.softmax(torch.einsum("kj,bj->bk", k, q.to(k.dtype)) / math.sqrt(float(self.joint_dim)),
                               dim=-1)
            bag = torch.cat([bag.to(da.dtype), torch.einsum("bk,kd->bd", da, conf)], dim=-1)
        out = {"logits": promoted_linear(self.head, bag), "bag_feat": bag}
        if return_attn:
            out["attn"] = attn
        return out
