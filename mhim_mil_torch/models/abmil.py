"""The ABMIL zoo models ``abmil`` and ``gabmil`` (port of
``mhim_mil_tpu/models/abmil.py``).

Reference: modules/abmil.py:145-259 (DAttention) and :51-143
(AttentionGated), over ``(feats[B,N,D], mask[B,N])``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.mesh import seq_layout
from .layers import (FeatureEmbed, add_gated_attention, add_tanh_attention, dense, gated_attention,
                     tanh_attention)
from .positional import SINCOS


class ABMIL(nn.Module):
    """Embed → attention pool → linear head (``abmil.py:17-72``).

    ``gated=False`` is ``abmil``: the tanh pool of width 128 (``attention.0``,
    ``attention.2``); ``gated=True`` is ``gabmil``: the gated pool of width
    384 (``attention_a/_b/_c``). The embed's dropout is 0.25 whenever
    ``dropout`` is set. ``mil_norm="ln"`` (any other value is no norm)
    adds a LayerNorm ``norm`` on the raw features (``embed_norm_pos`` 0) or
    after the embed (1), and ``norm1`` on the pooled feature.
    ``pos="sincos"`` adds the 2D sin-cos embedding of ``coords`` (the
    row-major grid without them) after the embed. The pool runs through K4
    where JAX's runs its kernel: eval, with ``use_flash``; training pools on
    the differentiable plain path. Under a mesh that splits the instances
    (``parallel/mesh.py``, ``sp > 1``) ``feats``, ``mask`` and ``coords`` are
    this rank's block: the pool's softmax and sum run over the sp row, the
    logits are the whole bag's on every rank and ``attn`` is this block's.
    """

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, inner_dim: int = 512,
                 dropout: float = 0.25, act: str = "relu", mil_norm: Optional[str] = None,
                 embed_norm_pos: int = 0, mil_bias: bool = True,
                 gated: bool = False, pos: Optional[str] = None, use_flash: bool = True):
        super().__init__()
        if pos not in ("sincos", "none", None):
            raise ValueError(f"ABMIL takes pos sincos or none, not {pos!r}")
        self.gated, self.pos, self.mil_norm, self.embed_norm_pos = gated, pos, mil_norm, embed_norm_pos
        if mil_norm == "ln":
            self.norm = nn.LayerNorm(input_dim if embed_norm_pos == 0 else inner_dim, eps=1e-5, bias=mil_bias)
        self.feature = FeatureEmbed(input_dim, inner_dim, act, 0.25 if dropout else 0.0, mil_bias)
        if pos == "sincos":
            self.pos_embedding = SINCOS(inner_dim)
        if gated:  # reference abmil.py:55: D = 384
            add_gated_attention(self, inner_dim, 384, 1, "tanh", mil_bias, 0.0, use_flash)
        else:
            add_tanh_attention(self, inner_dim, 128, 1, "tanh", mil_bias, 0.0, use_flash)
        if mil_norm == "ln":
            self.norm1 = nn.LayerNorm(inner_dim, eps=1e-5, bias=mil_bias)
        self.classifier = dense(inner_dim, n_classes)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, return_attn: bool = False,
                coords: Optional[torch.Tensor] = None):
        """``{"logits", "bag_feat"[, "attn" [B,N]]}``."""
        mask = mask.bool()
        seq = seq_layout(feats.shape[1], feats.device)
        x = feats
        if self.mil_norm == "ln" and self.embed_norm_pos == 0:
            x = self.norm(x)
        x = self.feature(x, training, gen, seq)
        if self.pos == "sincos":
            x = self.pos_embedding(x, mask, coords, seq)
        if self.mil_norm == "ln" and self.embed_norm_pos == 1:
            x = self.norm(x)
        pool = gated_attention if self.gated else tanh_attention
        pooled, attn = pool(self, x, mask, training, gen, False, seq)
        pooled = pooled[:, 0]
        if self.mil_norm == "ln":
            pooled = self.norm1(pooled)
        out = {"logits": self.classifier(pooled), "bag_feat": pooled}
        if return_attn:
            out["attn"] = attn[:, 0]
        return out
