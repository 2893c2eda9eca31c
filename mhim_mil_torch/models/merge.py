"""MHIM Merge module: compress the masked-out instances into k summary tokens
(port of ``mhim_mil_tpu/models/merge.py``).

Reference: modules/mhim_modules/merge.py:14-203. The keep/masked split is a
boolean partition of the visible instances whose uniform draw is an
argument; ``global_q_mm`` is a registered buffer, EMA-updated by the
training forward over the real bags of the batch. Given ``seq``, the layout
of instances sharded over the active sp row, the instances are this rank's
block; the merged tokens are the whole bag's, on every rank.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.masked import masked_softmax, random_subset_mask
from ..parallel.mesh import Seq, active as active_mesh, batch_sum, owner_weight, sp_gather, sp_max, sp_sum
from .layers import Dropout, dense


class MCA(nn.Module):
    """Multi-head cross-attention: queries ``q[B,M,D]`` attend over ``x[B,N,D]``
    restricted to ``kv_mask`` (port of ``merge.py:27-60``), dropout p on the
    attention and on the output."""

    def __init__(self, dim: int = 512, heads: int = 8, dim_head: int = 64, dropout: float = 0.1):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_kv = dense(dim, inner * 2, use_bias=False)
        self.to_q = dense(dim, inner, use_bias=False)
        self.to_out = nn.Sequential(dense(inner, dim))  # the reference's name to_out.0
        self.attn_drop, self.out_drop = Dropout(dropout), Dropout(dropout)

    def forward(self, x: torch.Tensor, q_in: torch.Tensor, kv_mask: torch.Tensor,
                training: bool = False, gen: Optional[torch.Generator] = None,
                seq: Optional[Seq] = None) -> torch.Tensor:
        b, n, _ = x.shape
        m = q_in.shape[1]
        h, dh = self.heads, self.dim_head
        k, v = self.to_kv(x).chunk(2, dim=-1)
        q = self.to_q(q_in)
        k, v, q = (t.reshape(b, t.shape[1], h, dh).transpose(1, 2) for t in (k, v, q))
        dots = (q @ k.transpose(-1, -2)) * dh ** -0.5  # [B,H,M,N]
        attn = masked_softmax(dots, kv_mask[:, None, None, :], sharded=seq is not None)
        attn = self.attn_drop(attn, training, gen, seq, -1)
        out = attn @ v if seq is None else sp_sum(attn @ v)  # [B,H,M,dh]
        out = out.transpose(1, 2).reshape(b, m, h * dh)
        return self.out_drop(self.to_out(out), training, gen)


class Merge(nn.Module):
    """Split the visible instances into keep (``merge_ratio``) and masked, and
    compress the masked ones into ``k`` tokens with MCA against the EMA
    global queries (port of ``merge.py:63-128``; ``mask_type='random'``)."""

    def __init__(self, dim: int = 512, k: int = 1, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.1, g_q_mm: float = 0.9998, merge_ratio: float = 0.2):
        super().__init__()
        self.dim, self.k = dim, k
        self.g_q_mm, self.merge_ratio = g_q_mm, merge_ratio
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MCA(dim, heads, dim_head, dropout)
        self.register_buffer("global_q_mm", torch.zeros(1, k, dim))

    @torch.no_grad()
    def reset_buffers(self, generator: torch.Generator):
        """VPT-style uniform init of the global queries (reference merge.py:104-111)."""
        val = math.sqrt(6.0 / float(3 * 16 * 16 + self.dim))
        self.global_q_mm.uniform_(-val, val, generator=generator)

    def _merge(self, x: torch.Tensor, kv_mask: torch.Tensor, training: bool,
               gen: Optional[torch.Generator], seq: Optional[Seq] = None) -> torch.Tensor:
        """Compress the ``kv_mask`` tokens of x into k tokens; in training,
        move ``global_q_mm`` toward the batch mean of the result over the real
        bags (a bag with no kv token counts for nothing; an all-fake batch
        leaves it as it was). Under an active mesh the mean is over the bags
        of every rank, so ``global_q_mm`` stays the same on each; under sp
        each bag counts on one rank of its row (``owner_weight``)."""
        g_q = self.global_q_mm
        q = g_q.to(x.dtype).expand(x.shape[0], self.k, self.dim)
        z = self.attn(self.norm(x), self.norm(q), kv_mask, training, gen, seq)
        if training and self.g_q_mm != 1.0:
            w = kv_mask.any(dim=-1).float()
            if seq is not None:
                w = sp_max(w) * owner_weight()
            wsum = w.sum()
            zsum = (z[:, :self.k].detach().float() * w[:, None, None]).sum(0, keepdim=True)
            if active_mesh() is not None:  # the sums over every rank's bags, in one all-reduce
                both = batch_sum(torch.cat([wsum.reshape(1), zsum.reshape(-1)]))
                wsum, zsum = both[0], both[1:].view_as(zsum)
            new = zsum / wsum.clamp_min(1.0)
            alpha = (1.0 - self.g_q_mm) * wsum.clamp_max(1.0)
            # Rebound, not updated in place: the old value is still in the graph.
            self.global_q_mm = (1.0 - alpha) * g_q + alpha * new
        return z

    def forward(self, x: torch.Tensor, visible: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None,
                seq: Optional[Seq] = None):
        """Training: ``(keep_sel[B,N], merged[B,k,D])``, keep_sel a uniform
        subset of ``floor(n_visible·merge_ratio)`` visible instances chosen by
        the draw ``u[B,N]``. Inference: ``(visible, merged)`` over the whole bag.
        Given ``seq``, ``u`` is the whole bag's draw, the subset is chosen on
        the gathered ``visible`` and ``keep_sel`` is this rank's block."""
        visible = visible.bool()
        if not training:
            return visible, self._merge(x, visible, False, gen, seq)
        pool = sp_gather(visible, seq)
        n_vis = pool.sum(dim=-1)
        k_keep = (n_vis.float() * self.merge_ratio).int()  # float32, truncated, as in JAX
        keep_sel = random_subset_mask(u, pool, k_keep)
        if seq is not None:
            keep_sel = keep_sel[:, seq.cols]
        return keep_sel, self._merge(x, visible & ~keep_sel, True, gen, seq)
