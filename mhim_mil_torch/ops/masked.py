"""Masked primitives for ragged MIL bags (port of ``mhim_mil_tpu/ops/masked.py``).

Bags are fixed-shape, length-bucketed ``(x[B, N, D], mask[B, N])`` with the
padding at the end; ``mask`` marks valid instances. Counts that depend on the
data stay tensors and selections are boolean masks, so no shape depends on
the data.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.mesh import Seq, sp_amax, sp_gather, sp_max, sp_scatter, sp_sum

# A large-but-finite negative fill: softmax of a fully masked row stays NaN-free.
NEG_INF = -1e30


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype statistics run in: fp32, or fp64 for fp64 input (a
    reference computed in fp64 stays fp64 throughout)."""
    return torch.promote_types(dtype, torch.float32)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1, sharded: bool = False) -> torch.Tensor:
    """Softmax over ``dim`` restricted to positions where ``mask`` is True.

    Fully masked rows return zeros. ``mask`` broadcasts against ``logits``.
    Statistics run in fp32 (:func:`stats_dtype`); the result comes back in the
    input dtype, with the exponentials rounded to it before the fp32
    denominator sum, as in the JAX package. ``sharded``: ``dim`` is an
    instance axis split over the active sp row, whose max and denominator
    are the row's (:func:`sp_max`, :func:`sp_sum`); the result is this
    rank's block.
    """
    out_dtype = logits.dtype
    acc = stats_dtype(out_dtype)
    x = torch.where(mask, logits.to(acc), NEG_INF)
    mx = x.amax(dim=dim, keepdim=True).detach()
    if sharded:
        mx = sp_max(mx)
    unnorm = (torch.exp(x - mx) * mask).to(out_dtype)
    denom = unnorm.sum(dim=dim, keepdim=True, dtype=acc)
    if sharded:
        denom = sp_sum(denom)
    return (unnorm / denom.clamp_min(1e-30)).to(out_dtype)


def masked_logsumexp(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``log Σ exp`` over ``dim`` of the positions where ``mask`` is True
    (``masked.py:60-64``); a fully masked row gives ``NEG_INF + log(1e-30)``."""
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=dim, keepdim=True)
    s = (torch.exp(logits - m) * mask).sum(dim=dim)
    return m.squeeze(dim) + torch.log(s.clamp_min(1e-30))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = -2, sharded: bool = False) -> torch.Tensor:
    """Mean of ``x`` over ``dim`` counting only the masked-in positions
    (``masked.py:67-76``); ``mask`` broadcasts to ``x`` (``mask[..., None]``
    against ``x[B, N, D]``). A fully masked row gives 0. ``sharded``: ``dim``
    is an instance axis split over the active sp row, whose sums and counts
    are the row's (:func:`sp_sum`)."""
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    total, count = (x * mask).sum(dim=dim), mask.sum(dim=dim)
    if sharded:
        total, count = sp_sum(total), sp_sum(count)
    return total / count.clamp_min(1.0)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int = -2, sharded: bool = False) -> torch.Tensor:
    """Max of ``x`` over ``dim`` of the masked-in positions (``masked.py:79-81``);
    a fully masked row gives ``NEG_INF``. ``sharded``: ``dim`` is an instance
    axis split over the active sp row, whose max is the row's, its gradient
    split among the row's ties (:func:`sp_amax`)."""
    x = torch.where(torch.broadcast_to(mask, x.shape), x, NEG_INF)
    return sp_amax(x, dim) if sharded else x.amax(dim=dim)


def topk_mask(scores: torch.Tensor, valid: torch.Tensor, k, largest: bool = True) -> torch.Tensor:
    """Boolean mask of the top-``k`` valid positions of ``scores`` on the last axis.

    ``k`` is an int or an integer tensor broadcastable to the leading axes.
    One sort finds the k-th score; positions strictly beyond it are in, and
    ties at the threshold are admitted in index order by a cumulative count,
    as in the JAX package (``masked.py:103-137``).
    """
    s = scores.float()
    key = torch.where(valid, -s if largest else s, -NEG_INF)
    skey = torch.sort(key, dim=-1).values  # ascending: best first
    lead = key.shape[:-1]
    k = torch.as_tensor(k, device=key.device)
    if 0 < k.dim() < len(lead):
        k = k[..., None]
    k = torch.broadcast_to(k, lead).long()
    idx = (k - 1).clamp(0, key.shape[-1] - 1)
    thr = torch.gather(skey, -1, idx[..., None])
    below = (key < thr) & valid
    ties = (key == thr) & valid
    n_below = below.sum(dim=-1, keepdim=True)
    tie_rank = torch.cumsum(ties.int(), dim=-1)  # 1-based
    sel = below | (ties & (tie_rank <= (k[..., None] - n_below)))
    return sel & (k[..., None] > 0)


def random_subset_mask(u: torch.Tensor, pool: torch.Tensor, k) -> torch.Tensor:
    """Choose ``k`` of the True positions of ``pool`` uniformly: the top ``k``
    of the uniform draw ``u`` (shape of ``pool``) over the pool. The draw is an
    argument, so a test can hand in the JAX package's own uniforms."""
    if u.shape != pool.shape:
        raise ValueError(f"draw of shape {tuple(u.shape)} for a pool of shape {tuple(pool.shape)}")
    return topk_mask(u, pool, k, largest=True)


def compact(x: torch.Tensor, keep: torch.Tensor, out_len: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move the kept instances of ``x[B, N, D]`` to the front, in index order.

    Returns ``(x_sorted, new_valid, perm)``: ``x_sorted[b, :n_keep_b]`` are
    bag b's kept instances and ``new_valid[b, i] = i < n_keep_b``. ``out_len``
    truncates to a static prefix; the caller guarantees every ``n_keep_b`` fits.
    """
    keep = keep.bool()
    perm = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    if out_len is not None and out_len < keep.shape[-1]:
        perm = perm[..., :out_len]
    x_sorted = torch.gather(x, -2, perm[..., None].expand(*perm.shape, x.shape[-1]))
    n_keep = keep.sum(dim=-1, keepdim=True)
    new_valid = torch.arange(perm.shape[-1], device=x.device)[None, :] < n_keep
    return x_sorted, new_valid, perm


def compact_sharded(x: torch.Tensor, keep: torch.Tensor, out_len: Optional[int], seq: Seq
                    ) -> Tuple[torch.Tensor, torch.Tensor, Seq]:
    """:func:`compact` of a sequence sharded over the active sp row, ``x``
    and ``keep`` this rank's block (layout ``seq``). Each kept instance
    takes its global position, an exclusive prefix over the row's counts
    (from the gathered ``keep``), and goes to the rank whose block of the
    ``out_len`` compacted tokens (``Seq.split``)
    holds it. Returns ``(x_sorted, new_valid, out_seq)``: this rank's block
    of the compacted sequence, zero past each bag's kept count, its
    validity, and its layout."""
    keep = keep.bool()
    full = sp_gather(keep, seq)
    n = seq.total if out_len is None else min(out_len, seq.total)
    out = Seq.split(n, len(seq.counts), seq.index)
    if min(out.counts) < 1:
        raise ValueError(f"compacting to {n} tokens leaves an sp rank empty: {out.counts}")
    pos = (torch.cumsum(full.int(), dim=-1) - 1)[:, seq.cols]
    x_sorted = sp_scatter(x, pos, keep & (pos < n), n, out)
    n_keep = full.sum(dim=-1, keepdim=True)
    new_valid = torch.arange(out.offset, out.offset + out.local, device=x.device)[None, :] < n_keep
    return x_sorted, new_valid, out
