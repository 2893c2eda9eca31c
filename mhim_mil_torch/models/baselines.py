"""MHIM baseline encoders ``selfattn`` (SAttention) and ``attn`` (DAttention)
(port of ``mhim_mil_tpu/models/baselines.py``).

Reference: modules/mhim_modules/baseline.py:8-110 (DAttention) and
:222-288 (SAttention). Each takes embedded ``(x[B,N,D], mask[B,N])`` and
returns a dict with the bag feature ``cls_feat`` and, on request, the mining
attention and the pseudo-score ingredients. Given ``seq``, the layout of
instances sharded over the active sp row, ``x`` and ``mask`` are this
rank's block, ``cls_feat`` is the whole bag's on every rank and the
attention and pseudo-score ingredients are this block's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.mesh import Seq, sp_first
from .layers import TanhAttentionPool
from .positional import make_pos
from .transformer import TransLayer


class DAttentionBaseline(nn.Module):
    """ABMIL attention pooling over the embedded features, attention width
    128, one branch, no biases (port of ``baselines.py:19-43``). Its pool is
    ``attention`` so that the weights are named as in the reference
    (``online_encoder.attention.attention.{0,2}``)."""

    def __init__(self, dim: int = 512, act: str = "gelu", use_flash: bool = True):
        super().__init__()
        self.attention = TanhAttentionPool(dim, attn_dim=128, act=act, use_bias=False, use_flash=use_flash)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, return_attn: bool = False,
                training: bool = False, gen: Optional[torch.Generator] = None,
                no_norm: bool = False, seq: Optional[Seq] = None):
        pooled, attn = self.attention(x, mask, training, gen, no_norm, seq)
        out = {"cls_feat": pooled[:, 0]}
        if return_attn:
            out["attn"] = attn[:, 0]  # [B,N], softmaxed (raw with no_norm)
            out["act"] = x  # the pre-pool activations, for the pseudo-score
        return out


class SAttentionBaseline(nn.Module):
    """cls token + two Nystrom TransLayers with the positional module ``pos``
    between them (``ppeg``, ``sincos`` on the row-major grid, ``peg`` or
    ``none``, kernel ``peg_k``; module ``pos_embedding``, as in
    ``baselines.py:46-108``), then LayerNorm.

    ``attn_layers`` names the layers whose cls attention ``return_attn``
    returns; attn2score mining reads only layer 1's. ``parity`` gives both
    TransLayers the reference's unmasked landmark arithmetic
    (``NystromMSA``).
    """

    def __init__(self, dim: int = 512, heads: int = 8, use_flash: bool = True,
                 attn_layers: tuple = (0, 1), parity: bool = False, pos: str = "ppeg", peg_k: int = 7):
        super().__init__()
        self.attn_layers = attn_layers
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.layer1 = TransLayer(dim, heads, use_flash, parity)
        self.pos_embedding = make_pos(pos, dim, peg_k)
        self.layer2 = TransLayer(dim, heads, use_flash, parity)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, return_attn: bool = False,
                training: bool = False, gen: Optional[torch.Generator] = None,
                no_norm: bool = False, seq: Optional[Seq] = None):
        """``training`` turns the attention dropouts on, with masks from
        ``gen``; ``no_norm`` makes the returned attention unsoftmaxed.
        Given ``seq``, the cls token goes in front of sp rank 0's block."""
        b = x.shape[0]
        mask = mask.bool()
        c = 1 if seq is None or seq.index == 0 else 0  # this rank holds the cls token
        if c:
            x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
            full_mask = torch.cat([mask.new_ones((b, 1)), mask], dim=1)
        else:
            full_mask = mask
        kw = {} if seq is None else {"seq": seq.prepend(1)}
        pos_kw = {} if seq is None else {"seq": seq}

        attns, scored1 = [], None
        if return_attn:
            x, a, _, scored1 = self.layer1(x, full_mask, True, training, gen, no_norm, **kw)
            attns.append(a[:, :, c:])  # drop the cls column
        else:
            x = self.layer1(x, full_mask, False, training, gen, **kw)
        if self.pos_embedding is not None:
            x = torch.cat([x[:, :c], self.pos_embedding(x[:, c:], mask, **pos_kw)], dim=1)
        if return_attn and 1 in self.attn_layers:
            x, a, *_ = self.layer2(x, full_mask, True, training, gen, no_norm, **kw)
            attns.append(a[:, :, c:])
        else:
            x = self.layer2(x, full_mask, False, training, gen, **kw)

        cls = x[:, 0] if seq is None else sp_first(x[:, 0], kw["seq"])
        out = {"cls_feat": self.norm(cls)}  # LayerNorm is per token
        if return_attn:
            out["attns"] = attns  # list of [B,H,N]
            out["attn"] = attns[0]
            out["scored_act"] = scored1  # layer 1's to_out(v ⊙ attn), [B,N,dim]
        return out
