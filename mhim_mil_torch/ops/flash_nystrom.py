"""Fused masked Nystrom attention (port of ``mhim_mil_tpu/ops/pallas_nystrom.py``).

Two streaming passes over the bag keep every ``[B,H,N,m]`` intermediate out
of device memory:

- **K1** ``pass_a``: per landmark row, the online softmax of
  ``sim3 = Q_l·Kᵀ`` over the valid keys and ``attn3@V``, with the final row
  max ``m3`` and sum ``s3``.
- the glue, plain tensor code on ``[B,H,m,·]``: landmark means, ``attn2`` and
  its pseudo-inverse, ``mid = pinv @ attn3v`` and the cls-row weights
  ``r' = (attn1[0] @ pinv) / s3``.
- **K2** ``pass_b``: per token, ``out = softmax_m(Q·K_lᵀ) @ mid`` and the cls
  row ``cls[t] = Σ_m r'[m]·exp(q_l[m]·k_t − m3[m])``.

``pass_a`` and ``pass_b`` launch the CUDA kernels of
``csrc/flash_nystrom.cu`` on CUDA tensors and run ``pass_a_plain`` /
``pass_b_plain`` on CPU tensors. Each keeps in ``.launches`` the number of
times it was called on the card (K1's call launches two kernels: the
partials of its key splits, planned by :func:`pass_a_plan`, and their merge;
:func:`pass_a_split_plain` is that arithmetic in plain torch, for tests).
The kernels are built for head dims 16, 32, 64, 128 and 256; on the card
:func:`padded_head_dim` zero-pads any other head dim up to the next of
those, and above 256 the wrappers raise a ``ValueError``. At 256 a block
of K1 or K2 keeps a 128-column accumulator: the grid runs two column halves,
each computing the scores over all 256 columns (:func:`halves`). K1b and K2b
split the head dim across the warps of a block instead, in 64-column
groups, and compute each score once (:func:`bwd_rows`).

The backward of each pass is a kernel too:

- **K2b** :func:`pass_b_backward`, the gradients of ``out`` and the cls row
  with respect to K2's operands (``csrc/flash_nystrom_bwd.cu``);
- **K1b** :func:`pass_a_backward`, the gradients of ``attn3v`` and ``s3``
  with respect to ``q_l``, ``k`` and ``v`` (``csrc/flash_nystrom_k1b.cu``),
  FlashAttention-2's backward with the m landmark rows as queries.

Neither forms ``[B,H,N,m]``; :func:`pass_b_backward_plain` and
:func:`pass_a_backward_plain` run on CPU tensors. K2b's token kernel takes
``D = Σ d_out·out`` from K2's output and walks the landmarks once with an
online softmax, and its landmark kernel splits the tokens
(:func:`pass_b_backward_plan`); K1b runs its landmark and key blocks as one
grid (:func:`pass_a_backward_plan`).
:func:`pass_b_backward_stream_plain` and :func:`pass_a_backward_split_plain`
are that arithmetic in plain torch, for tests.

**K3** :func:`flash_nystrom` is the differentiable form (the port of the
custom VJP at ``pallas_nystrom.py:249-304``): the composition that
:func:`flash_nystrom_infer` runs, with K1 and K2 as autograd functions whose
backwards are K1b and K2b, and the glue differentiated by autograd on
``[B,H,m,·]`` tensors. Its graph is kept from the forward, so the backward
recomputes nothing; ``m3`` is taken as a constant (the composition does not
change when ``m3`` and ``s3`` shift together, so its cotangent cancels
against the one that reaches it through ``s3``). The JAX package's backward
recomputes the plain attention in XLA instead. Its counts are
``flash_nystrom.forward_calls`` and ``flash_nystrom.backward_calls``.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import load_library
from ..kernels.launch import check as _check, check_rows_aligned as _aligned
from ..kernels.launch import H100_SMS, on_cpu as _on_cpu, raise_on as _raise_on, sm_count as _sm_count
from ..kernels.launch import tickets as _tickets
from .masked import NEG_INF, masked_softmax
from ..kernels.launch import rows_aligned as _rows_aligned
from .nystrom import _landmark_mean
from .nystrom_pinv import pseudo_inverse

Tensor = torch.Tensor


def pass_a_plain(ql: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K1's function. ``ql[B,H,m,dh]``, ``k, v[B,H,N,dh]``, ``mask[B,N]``.
    Returns ``attn3v[B,H,m,dh]``, ``m3[B,H,m]``, ``s3[B,H,m]``; values at
    masked keys are ignored."""
    valid = mask[:, None, None, :]
    sim = torch.where(valid, ql @ k.transpose(-1, -2), NEG_INF)  # [B,H,m,N]
    m3 = sim.amax(dim=-1)
    p = torch.where(valid, torch.exp(sim - m3[..., None]), 0.0)
    s3 = p.sum(dim=-1)
    v = torch.where(mask[:, None, :, None], v, 0.0)
    return (p @ v) / s3.clamp_min(1e-30)[..., None], m3, s3


def pass_b_plain(
    q: Tensor, k: Tensor, mask: Tensor, kl: Tensor, lm_mask: Tensor,
    mid: Tensor, ql: Tensor, rp: Tensor, m3: Tensor,
) -> Tuple[Tensor, Tensor]:
    """K2's function. ``q, k[B,H,N,dh]``, ``mask[B,N]``, ``kl, mid, ql[B,H,m,dh]``
    (``kl``/``ql`` zero at empty landmarks), ``lm_mask[B,m]``, ``rp, m3[B,H,m]``.
    Returns ``out[B,H,N,dh]`` and ``cls[B,H,N]``, both zero at masked tokens."""
    lm = lm_mask[:, None, None, :]
    sim1 = torch.where(lm, q @ kl.transpose(-1, -2), NEG_INF)  # [B,H,N,m]
    p1 = torch.where(lm, torch.exp(sim1 - sim1.amax(dim=-1, keepdim=True)), 0.0)
    attn1 = p1 / p1.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.where(mask[:, None, :, None], attn1 @ mid, 0.0)
    sim3 = ql @ k.transpose(-1, -2)  # [B,H,m,N]
    cls = (torch.exp(sim3 - m3[..., None]) * rp[..., None]).sum(dim=-2)
    return out, torch.where(mask[:, None, :], cls, 0.0)


def pass_b_backward_plain(
    q: Tensor, k: Tensor, mask: Tensor, kl: Tensor, lm_mask: Tensor, mid: Tensor, ql: Tensor,
    rp: Tensor, m3: Tensor, d_out: Tensor, d_cls: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """K2b's function: the gradients of :func:`pass_b_plain`'s ``out`` and,
    given ``d_cls``, its ``cls`` under the cotangents ``d_out[B,H,N,dh]`` and
    ``d_cls[B,H,N]``. With ``P1 = softmax_m(q·k_lᵀ)`` over the valid
    landmarks and ``E = exp(q_l·kᵀ − m3)``: ``dP1 = d_out·midᵀ``,
    ``dS1 = P1 ∘ (dP1 − Σ_m P1·dP1)``, ``d_q = dS1·k_l``, ``d_kl = dS1ᵀ·q``,
    ``d_mid = P1ᵀ·d_out``; ``G = r'·E·d_cls``, ``d_k = Gᵀ·q_l``,
    ``d_ql = G·k``, ``d_r' = Σ_N E·d_cls``, ``d_m3 = −r'·d_r'``. Returns
    ``(d_q, d_k, d_kl, d_mid, d_ql, d_rp, d_m3)``, the last four of them and
    ``d_k`` None without ``d_cls``; zero at masked tokens, and ``d_kl``,
    ``d_mid`` zero at empty landmark groups. Values at masked tokens are
    never used."""
    tok = mask[:, None, :, None]
    lm = lm_mask[:, None, None, :]
    q, k, d_out = (torch.where(tok, t, 0.0) for t in (q, k, d_out))
    sim1 = torch.where(lm, q @ kl.transpose(-1, -2), NEG_INF)  # [B,H,N,m]
    p1 = torch.where(lm, torch.exp(sim1 - sim1.amax(dim=-1, keepdim=True)), 0.0)
    p1 = torch.where(tok, p1 / p1.sum(dim=-1, keepdim=True).clamp_min(1e-30), 0.0)
    dp1 = d_out @ mid.transpose(-1, -2)
    ds1 = p1 * (dp1 - (p1 * dp1).sum(dim=-1, keepdim=True))
    d_q, d_kl, d_mid = ds1 @ kl, ds1.transpose(-1, -2) @ q, p1.transpose(-1, -2) @ d_out
    if d_cls is None:
        return d_q, None, d_kl, d_mid, None, None, None
    valid = mask[:, None, None, :]
    e = torch.where(valid, torch.exp(ql @ k.transpose(-1, -2) - m3[..., None]), 0.0)  # [B,H,m,N]
    ec = e * torch.where(valid, d_cls[:, :, None, :], 0.0)
    g = rp[..., None] * ec
    d_rp = ec.sum(dim=-1)
    return d_q, g.transpose(-1, -2) @ ql, d_kl, d_mid, g @ k, d_rp, -rp * d_rp


def pass_a_backward_plain(
    ql: Tensor, k: Tensor, v: Tensor, mask: Tensor, attn3v: Tensor, m3: Tensor, s3: Tensor,
    d_attn3v: Tensor, d_s3: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """K1b's function: the gradients of :func:`pass_a_plain`'s ``attn3v`` and
    ``s3`` under the cotangents ``d_attn3v[B,H,m,dh]`` and ``d_s3[B,H,m]``
    (None: zero), with ``m3`` taken as a constant. With
    ``P = exp(q_l·kᵀ − m3) / s3`` over the valid keys:
    ``D = Σ_dh d_attn3v ∘ attn3v − s3·d_s3`` per landmark row (the second
    term is ``s3``'s cotangent, since ``∂s3/∂S = s3·P``), ``dP = d_attn3v·vᵀ``,
    ``dS = P ∘ (dP − D)``, ``d_ql = dS·k``, ``d_k = dSᵀ·q_l``,
    ``d_v = Pᵀ·d_attn3v``. Returns ``(d_ql, d_k, d_v)``, ``d_k`` and ``d_v``
    zero at masked keys, whose values are never used."""
    tok = mask[:, None, :, None]
    valid = mask[:, None, None, :]
    k, v = (torch.where(tok, t, 0.0) for t in (k, v))
    sim = ql @ k.transpose(-1, -2)  # [B,H,m,N]
    p = torch.where(valid, torch.exp(sim - m3[..., None]), 0.0) / s3.clamp_min(1e-30)[..., None]
    dd = (d_attn3v * attn3v).sum(dim=-1)
    if d_s3 is not None:
        dd = dd - s3 * d_s3
    ds = p * (d_attn3v @ v.transpose(-1, -2) - dd[..., None])
    return ds @ k, ds.transpose(-1, -2) @ ql, p.transpose(-1, -2) @ d_attn3v


HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims K1, K2, K1b and K2b are built for
ACC_COLS = 128  # the widest accumulator a block keeps: wider head dims run in column halves


def kernel_head_dim(dh: int) -> int:
    """The head dim the kernels run ``dh`` at: the next of :data:`HEAD_DIMS`.
    Raises a ``ValueError`` above the largest."""
    for d in HEAD_DIMS:
        if dh <= d:
            return d
    raise ValueError(f"head dim {dh}: the flash-Nystrom kernels take head dims 1 to {HEAD_DIMS[-1]} "
                     f"(zero-padded up to one of {HEAD_DIMS})")


def halves(dh: int) -> int:
    """The column halves the grid of each kernel runs at head dim ``dh``: 2
    at 256, where each block computes its scores over all 256 columns and
    accumulates 128 of the value side, else 1."""
    return max(1, kernel_head_dim(dh) // ACC_COLS)


def padded_head_dim(call, args, pad, sliced):
    """``call(*args)`` at :func:`kernel_head_dim`: the ``[..., dh]`` tensors at
    positions ``pad`` of ``args`` zero-padded on their last axis (new
    contiguous tensors) and the outputs at positions ``sliced`` cut back to
    ``dh`` (views; None stays None). Zero q/k columns leave every product
    unchanged, and zero v, mid and d_out columns give only output columns
    that are cut off. At an instantiated head dim ``args`` pass as they are."""
    dh = args[pad[0]].shape[-1]
    dhp = kernel_head_dim(dh)
    if dhp == dh:
        return call(*args)
    outs = call(*(F.pad(a, (0, dhp - dh)) if i in pad else a for i, a in enumerate(args)))
    return tuple(o[..., :dh] if i in sliced and o is not None else o for i, o in enumerate(outs))


PASS_A_ROWS = 128  # landmark rows of a K1 block up to DH 128; 64 at DH 256 (csrc a_warps)
PASS_A_KEYS = 32  # keys of a K1 tile; a split is a whole number of tiles (csrc COLS)
PASS_A_RESIDENT = {16: 2, 32: 2, 64: 2, 128: 1, 256: 1}  # K1 blocks an SM holds, by head dim (csrc a_resident)
BWD_ROWS = 64  # rows of a K2b or K1b block up to DH 64; 32 above (csrc flash_nystrom_bwd.cuh bwd_rows)
BWD_KEYS = 32  # rows of the tiles it streams up to DH 64; 16 above (bwd_cols): a split is whole tiles
BWD_RESIDENT = {16: 3, 32: 3, 64: 3, 128: 2, 256: 1}  # their blocks an SM (bwd_resident)


def pass_a_rows(dh: int) -> int:
    """Landmark rows of a K1 block at head dim ``dh``."""
    return PASS_A_ROWS if kernel_head_dim(dh) <= ACC_COLS else PASS_A_ROWS // 2


def bwd_rows(dh: int) -> int:
    """Rows (tokens, keys or landmarks) of a K2b or K1b block at head dim
    ``dh``: 4 row groups of 16 up to 64, 2 above, where each row group's
    warps split the head dim in 64-column groups (a block of 4 warps at
    128, 8 at 256)."""
    return BWD_ROWS if kernel_head_dim(dh) <= 64 else BWD_ROWS // 2


def bwd_keys(dh: int) -> int:
    """Rows of the tiles a K2b or K1b block streams at head dim ``dh``."""
    return BWD_KEYS if kernel_head_dim(dh) <= 64 else BWD_KEYS // 2


def _split_plan(row_blocks: int, n: int, resident: int, sms: int, tile: int, waves: int = 2) -> Tuple[int, int]:
    """``(n_splits, per_split)`` of n keys over a grid of ``row_blocks`` row
    blocks per split: aims at ``waves`` full waves of resident blocks
    (``waves·resident·sms``), rounding the split count down so that the last
    wave is not a sliver; ``per_split`` is a whole number of tiles, and no
    split is empty."""
    tiles = max(1, math.ceil(n / tile))
    target = max(1, min(tiles, (waves * resident * sms) // row_blocks))
    per_split = math.ceil(tiles / target) * tile
    return max(1, math.ceil(n / per_split)), per_split


def pass_a_plan(b: int, h: int, n: int, m: int, sms: int = H100_SMS, dh: int = 64) -> Tuple[int, int]:
    """K1's split of the keys: ``(n_splits, per_split)``, split ``s`` taking
    keys ``[s·per_split, min(n, (s + 1)·per_split))``, over the grid's
    ``b·h·⌈m/rows⌉·halves`` landmark blocks per split at the residency of
    head dim ``dh`` (:func:`_split_plan`)."""
    return _split_plan(b * h * math.ceil(m / pass_a_rows(dh)) * halves(dh), n,
                       PASS_A_RESIDENT[kernel_head_dim(dh)], sms, PASS_A_KEYS)


def pass_b_backward_plan(b: int, h: int, n: int, m: int, sms: int = H100_SMS,
                         dh: int = 64) -> Tuple[int, int]:
    """The token split of K2b's landmark kernel: as :func:`pass_a_plan`
    splits K1's keys, over ``b·h·⌈m/rows⌉`` landmark blocks per split
    (:func:`bwd_rows`), in tiles of :func:`bwd_keys` tokens, but aiming at
    one wave: fewer splits to merge, and on the H100 one wave beat two by
    5–15% at every head dim (``PERF.md`` §6)."""
    return _split_plan(b * h * math.ceil(m / bwd_rows(dh)), n, BWD_RESIDENT[kernel_head_dim(dh)], sms,
                       bwd_keys(dh), waves=1)


def pass_a_backward_plan(n: int, m: int, dh: int = 64) -> Tuple[int, int]:
    """The key split of K1b's landmark blocks: ``(n_splits, per_split)``,
    split ``s`` taking keys ``[s·per_split, min(n, (s + 1)·per_split))``.
    One grid holds the landmark blocks and the key blocks, and a key block
    walks all ``m`` landmarks with four products where a landmark block
    walks its split with three: ``⌈n/m⌉`` splits keep each landmark block
    within the time of a key block. ``per_split`` is whole tiles of
    :func:`bwd_keys` keys, and no split is empty."""
    tile = bwd_keys(dh)
    tiles = max(1, math.ceil(n / tile))
    per_split = math.ceil(tiles / max(1, min(tiles, math.ceil(n / max(m, 1))))) * tile
    return max(1, math.ceil(n / per_split)), per_split


def pass_a_split_plain(ql: Tensor, k: Tensor, v: Tensor, mask: Tensor, n_splits: int,
                       per_split: int) -> Tuple[Tensor, Tensor, Tensor]:
    """K1's split-and-merge arithmetic in plain torch (for tests): each split
    of the keys gives its row max, sum and unnormalised ``p @ v``; the merge
    rescales them by ``exp(m_i − m)``. Same function as :func:`pass_a_plain`;
    a split without a valid key adds nothing."""
    parts = []
    for s in range(n_splits):
        keys = slice(s * per_split, min(k.shape[2], (s + 1) * per_split))
        valid = mask[:, None, None, keys]
        sim = torch.where(valid, ql @ k[:, :, keys].transpose(-1, -2), NEG_INF)
        m_s = sim.amax(dim=-1)
        p = torch.where(valid, torch.exp(sim - m_s[..., None]), 0.0)
        vs = torch.where(mask[:, None, keys, None], v[:, :, keys], 0.0)
        parts.append((m_s, p.sum(dim=-1), p @ vs))
    pm, ps, pacc = (torch.stack(x) for x in zip(*parts))
    m3 = pm.amax(dim=0)
    w = torch.exp(pm - m3)
    s3 = (ps * w).sum(dim=0)
    return (pacc * w[..., None]).sum(dim=0) / s3.clamp_min(1e-30)[..., None], m3, s3


def pass_b_backward_stream_plain(
    q: Tensor, k: Tensor, mask: Tensor, kl: Tensor, lm_mask: Tensor, mid: Tensor, ql: Tensor,
    rp: Tensor, m3: Tensor, d_out: Tensor, d_cls: Optional[Tensor], out: Tensor, chunk: int,
    n_splits: int, per_split: int,
) -> Tuple[Tensor, ...]:
    """K2b's arithmetic as its kernels order it, in plain torch (for tests):
    ``D = Σ d_out·out`` from K2's ``out``; per token, one walk over the
    landmarks in chunks of ``chunk`` with the online softmax of ``s1``,
    ``acc = Σ exp(s1 − max)·(dP1 − D)·k_l`` rescaled as the max moves and
    ``d_q = acc / Σ exp(s1 − max)``, which leaves the log-sum-exp; per
    landmark, each token split's ``P1ᵀ = exp(s1ᵀ − lse)`` and
    ``dS1ᵀ = P1ᵀ∘(dP1ᵀ − D)`` give partial ``d_kl``, ``d_mid`` (and ``d_ql``,
    ``d_r'``), added in split order. Same function and outputs as
    :func:`pass_b_backward_plain`."""
    tok = mask[:, None, :, None]
    lm = lm_mask[:, None, None, :]
    q, k, d_out = (torch.where(tok, t, 0.0) for t in (q, k, d_out))
    dd = torch.where(mask[:, None], (d_out * out).sum(dim=-1), 0.0)  # [B,H,N]
    m_run = torch.full(dd.shape, NEG_INF, dtype=q.dtype, device=q.device)
    l_run = torch.zeros_like(dd)
    acc = torch.zeros_like(q)
    for c0 in range(0, kl.shape[2], chunk):
        c = slice(c0, c0 + chunk)
        ok = lm[..., c]
        s1 = torch.where(ok, q @ kl[:, :, c].transpose(-1, -2), NEG_INF)
        m_new = torch.maximum(m_run, s1.amax(dim=-1))
        scale = torch.exp(m_run - m_new)
        p = torch.where(ok, torch.exp(s1 - m_new[..., None]), 0.0)
        dp = d_out @ mid[:, :, c].transpose(-1, -2)
        l_run = l_run * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + (p * (dp - dd[..., None])) @ kl[:, :, c]
        m_run = m_new
    den = l_run.clamp_min(1e-30)
    d_q = torch.where(tok, acc / den[..., None], 0.0)
    lse = m_run + torch.log(den)
    valid = mask[:, None, None, :]
    cls = d_cls is not None
    d_kl = torch.zeros_like(kl)
    d_mid, d_ql = torch.zeros_like(mid), torch.zeros_like(ql)
    d_rp = torch.zeros_like(rp)
    for s in range(n_splits):
        n = slice(s * per_split, min(q.shape[2], (s + 1) * per_split))
        ok = valid[..., n]
        p1t = torch.where(ok, torch.exp(kl @ q[:, :, n].transpose(-1, -2) - lse[:, :, None, n]), 0.0)
        dp1t = mid @ d_out[:, :, n].transpose(-1, -2)
        ds1t = torch.where(ok, p1t * (dp1t - dd[:, :, None, n]), 0.0)
        d_kl = d_kl + ds1t @ q[:, :, n]
        d_mid = d_mid + p1t @ d_out[:, :, n]
        if cls:
            e = torch.where(ok, torch.exp(ql @ k[:, :, n].transpose(-1, -2) - m3[..., None]), 0.0)
            ec = e * torch.where(ok, d_cls[:, :, None, n], 0.0)
            d_ql = d_ql + (rp[..., None] * ec) @ k[:, :, n]
            d_rp = d_rp + ec.sum(dim=-1)
    lmz = lm_mask[:, None, :, None]
    d_kl, d_mid = torch.where(lmz, d_kl, 0.0), torch.where(lmz, d_mid, 0.0)
    if not cls:
        return d_q, None, d_kl, d_mid, None, None, None
    g = rp[..., None] * torch.where(valid, torch.exp(ql @ k.transpose(-1, -2) - m3[..., None]), 0.0) \
        * torch.where(valid, d_cls[:, :, None, :], 0.0)
    return d_q, g.transpose(-1, -2) @ ql, d_kl, d_mid, d_ql, d_rp, -rp * d_rp


def pass_a_backward_split_plain(
    ql: Tensor, k: Tensor, v: Tensor, mask: Tensor, attn3v: Tensor, m3: Tensor, s3: Tensor,
    d_attn3v: Tensor, d_s3: Optional[Tensor], n_splits: int, per_split: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """K1b's arithmetic as its one grid orders it, in plain torch (for
    tests): ``D`` and ``1/s3`` taken where they are used, ``d_k`` and ``d_v``
    over every landmark, ``d_ql`` as the partial sums of the key splits
    added in split order. Same function and outputs as
    :func:`pass_a_backward_plain`."""
    tok = mask[:, None, :, None]
    k, v = (torch.where(tok, t, 0.0) for t in (k, v))
    dd = (d_attn3v * attn3v).sum(dim=-1)
    if d_s3 is not None:
        dd = dd - s3 * d_s3
    inv = 1.0 / s3.clamp_min(1e-30)
    d_ql = torch.zeros_like(ql)
    for s in range(n_splits):
        n = slice(s * per_split, min(k.shape[2], (s + 1) * per_split))
        ok = mask[:, None, None, n]
        p = torch.where(ok, torch.exp(ql @ k[:, :, n].transpose(-1, -2) - m3[..., None]), 0.0) * inv[..., None]
        ds = torch.where(ok, p * (d_attn3v @ v[:, :, n].transpose(-1, -2) - dd[..., None]), 0.0)
        d_ql = d_ql + ds @ k[:, :, n]
    valid = mask[:, None, :, None]
    pt = torch.where(valid, torch.exp(k @ ql.transpose(-1, -2) - m3[:, :, None, :]), 0.0) * inv[:, :, None, :]
    dst = torch.where(valid, pt * (v @ d_attn3v.transpose(-1, -2) - dd[:, :, None, :]), 0.0)
    return d_ql, dst @ ql, pt @ d_attn3v


@functools.lru_cache(maxsize=None)
def _library():
    """K1's and K2's library, once its K1 geometry (rows, keys and, by head
    dim, blocks an SM) is checked against the plan's."""
    lib = load_library("flash_nystrom")
    got = ({d: lib.flash_nystrom_pass_a_rows(d) for d in HEAD_DIMS}, lib.flash_nystrom_pass_a_keys(),
           {d: lib.flash_nystrom_pass_a_resident(d) for d in HEAD_DIMS})
    want = ({d: pass_a_rows(d) for d in HEAD_DIMS}, PASS_A_KEYS, PASS_A_RESIDENT)
    if got != want:
        raise RuntimeError(f"flash_nystrom.cu's K1 geometry {got} differs from pass_a_plan's {want}")
    return lib


def _bwd_geometry_library(name: str):
    """A backward kernel's library, once its geometry (rows, tile rows and
    blocks an SM, by head dim) is checked against the plans'
    (:func:`bwd_rows`, :func:`bwd_keys`, :data:`BWD_RESIDENT`), which K2b and
    K1b share."""
    lib = load_library(name)
    got = ({d: getattr(lib, f"{name}_rows")(d) for d in HEAD_DIMS},
           {d: getattr(lib, f"{name}_keys")(d) for d in HEAD_DIMS},
           {d: getattr(lib, f"{name}_resident")(d) for d in HEAD_DIMS})
    want = ({d: bwd_rows(d) for d in HEAD_DIMS}, {d: bwd_keys(d) for d in HEAD_DIMS}, BWD_RESIDENT)
    if got != want:
        raise RuntimeError(f"{name}.cu's geometry {got} differs from the wrapper's {want}")
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library():
    """K2b's library, its geometry and its row width checked."""
    lib = _bwd_geometry_library("flash_nystrom_bwd")
    got = [lib.flash_nystrom_bwd_width(d, c) for d in HEAD_DIMS for c in (0, 1)]
    if got != [_bwd_width(d, c) for d in HEAD_DIMS for c in (0, 1)]:
        raise RuntimeError(f"flash_nystrom_bwd.cu's row widths {got} differ from the wrapper's")
    return lib


@functools.lru_cache(maxsize=None)
def _k1b_library():
    """K1b's library, its geometry checked."""
    return _bwd_geometry_library("flash_nystrom_k1b")


def _bwd_width(dh: int, cls: bool) -> int:
    """Floats of a landmark row of K2b's output: d_kl | d_mid, and with the
    cls term | d_ql | d_r' | 3 floats of padding."""
    return 3 * dh + 4 if cls else 2 * dh


def pass_a(ql: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: the CUDA kernels on CUDA tensors, :func:`pass_a_plain` on CPU tensors.
    ``k`` and ``v`` may be any strided view with a unit last stride whose
    rows start on 16 bytes; any head dim up to 256 (:func:`padded_head_dim`)."""
    if _on_cpu(ql, k, v, mask):
        return pass_a_plain(ql, k, v, mask)
    out = padded_head_dim(_launch_pass_a, (ql, k, v, mask), (0, 1, 2), (0,))
    pass_a.launches += 1
    return out


def _launch_pass_a(ql: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    b, h, m, dh = ql.shape
    n = k.shape[2]
    dev = ql.device
    _check("ql", ql, (b, h, m, dh), dev, contiguous=True)
    _check("k", k, (b, h, n, dh), dev)
    _check("v", v, (b, h, n, dh), dev)
    _check("mask", mask, (b, n), dev, contiguous=True, dtype=torch.bool)
    for name, t in (("ql", ql), ("k", k), ("v", v)):
        _aligned(name, t)
    lib = _library()
    n_splits, per_split = pass_a_plan(b, h, n, m, _sm_count(dev.index), dh)
    part_m = torch.empty((b * h, n_splits, m), device=dev, dtype=torch.float32)
    part_s = torch.empty_like(part_m)
    part_acc = torch.empty((b * h, n_splits, m, dh), device=dev, dtype=torch.float32)
    attn3v = torch.empty((b, h, m, dh), device=dev, dtype=torch.float32)
    m3 = torch.empty((b, h, m), device=dev, dtype=torch.float32)
    s3 = torch.empty((b, h, m), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.flash_nystrom_pass_a(
            ql.data_ptr(),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            mask.data_ptr(),
            part_m.data_ptr(), part_s.data_ptr(), part_acc.data_ptr(),
            attn3v.data_ptr(), m3.data_ptr(), s3.data_ptr(),
            b, h, n, m, dh, n_splits, per_split, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "flash_nystrom_pass_a")
    return attn3v, m3, s3


pass_a.launches = 0


def pass_b(
    q: Tensor, k: Tensor, mask: Tensor, kl: Tensor, lm_mask: Tensor,
    mid: Tensor, ql: Tensor, rp: Tensor, m3: Tensor,
) -> Tuple[Tensor, Tensor]:
    """K2: the CUDA kernel on CUDA tensors, :func:`pass_b_plain` on CPU tensors.
    ``q`` and ``k`` may be strided views whose rows start on 16 bytes; ``out``
    comes back as a ``[B,H,N,dh]`` view of ``[B,N,H,dh']`` storage, ``dh'``
    the head dim the kernel ran at (:func:`padded_head_dim`), so the caller's
    merge of the heads is free where the two are equal."""
    if _on_cpu(q, k, mask, kl, lm_mask, mid, ql, rp, m3):
        return pass_b_plain(q, k, mask, kl, lm_mask, mid, ql, rp, m3)
    out = padded_head_dim(_launch_pass_b, (q, k, mask, kl, lm_mask, mid, ql, rp, m3), (0, 1, 3, 5, 6), (0,))
    pass_b.launches += 1
    return out


def _launch_pass_b(
    q: Tensor, k: Tensor, mask: Tensor, kl: Tensor, lm_mask: Tensor,
    mid: Tensor, ql: Tensor, rp: Tensor, m3: Tensor,
) -> Tuple[Tensor, Tensor]:
    b, h, n, dh = q.shape
    m = kl.shape[2]
    dev = q.device
    _check("q", q, (b, h, n, dh), dev)
    _check("k", k, (b, h, n, dh), dev)
    _check("mask", mask, (b, n), dev, contiguous=True, dtype=torch.bool)
    for name, t in (("kl", kl), ("mid", mid), ("ql", ql)):
        _check(name, t, (b, h, m, dh), dev, contiguous=True)
    _check("lm_mask", lm_mask, (b, m), dev, contiguous=True, dtype=torch.bool)
    _check("rp", rp, (b, h, m), dev, contiguous=True)
    _check("m3", m3, (b, h, m), dev, contiguous=True)
    for name, t in (("q", q), ("k", k), ("kl", kl), ("mid", mid), ("ql", ql)):
        _aligned(name, t)
    out = torch.empty((b, n, h, dh), device=dev, dtype=torch.float32).transpose(1, 2)
    cls = torch.empty((b, h, n), device=dev, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.flash_nystrom_pass_b(
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            mask.data_ptr(),
            kl.data_ptr(), lm_mask.data_ptr(), mid.data_ptr(), ql.data_ptr(),
            rp.data_ptr(), m3.data_ptr(),
            out.data_ptr(), out.stride(0), out.stride(1), out.stride(2),
            cls.data_ptr(),
            b, h, n, m, dh, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "flash_nystrom_pass_b")
    return out, cls


pass_b.launches = 0


def pass_b_backward(
    q: Tensor, k: Tensor, mask: Tensor, kl: Tensor, lm_mask: Tensor, mid: Tensor, ql: Tensor,
    rp: Tensor, m3: Tensor, d_out: Tensor, d_cls: Optional[Tensor] = None, *, out: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """K2b: the CUDA kernels on CUDA tensors, :func:`pass_b_backward_plain`
    (same arguments and fp32 outputs) on CPU tensors. ``q``, ``k``, ``d_out``
    and ``out`` may be strided views (``d_out`` and ``out`` in any layout:
    one whose rows do not start on 16 bytes is copied); any head dim up to
    256. Without ``d_cls`` the cls term is skipped and its four gradients
    are None. ``out`` is K2's output for these operands, which the kernels
    take ``D = Σ d_out·out`` from (:class:`PassB` saves it); without it the
    card branch runs :func:`pass_b` (K2, counted) for it first."""
    if _on_cpu(q, k, mask, kl, lm_mask, mid, ql, rp, m3, d_out, *(() if d_cls is None else (d_cls,))):
        return pass_b_backward_plain(q, k, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_cls)
    if out is None:
        out = pass_b(q, k, mask, kl, lm_mask, mid, ql, rp, m3)[0]
    d_out, out = (t if _rows_aligned(t) else t.contiguous() for t in (d_out, out))
    args = (q, k, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_cls, out)
    grads = padded_head_dim(_launch_pass_b_backward, args, (0, 1, 3, 5, 6, 9, 11), (0, 1, 2, 3, 4))
    pass_b_backward.launches += 1
    return grads


def _launch_pass_b_backward(
    q: Tensor, k: Tensor, mask: Tensor, kl: Tensor, lm_mask: Tensor, mid: Tensor, ql: Tensor,
    rp: Tensor, m3: Tensor, d_out: Tensor, d_cls: Optional[Tensor], out: Tensor,
) -> Tuple[Tensor, ...]:
    b, h, n, dh = q.shape
    m = kl.shape[2]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("d_out", d_out), ("out", out)):
        _check(name, t, (b, h, n, dh), dev)
    _check("mask", mask, (b, n), dev, contiguous=True, dtype=torch.bool)
    for name, t in (("kl", kl), ("mid", mid), ("ql", ql)):
        _check(name, t, (b, h, m, dh), dev, contiguous=True)
    _check("lm_mask", lm_mask, (b, m), dev, contiguous=True, dtype=torch.bool)
    _check("rp", rp, (b, h, m), dev, contiguous=True)
    _check("m3", m3, (b, h, m), dev, contiguous=True)
    cls = d_cls is not None
    if cls:
        d_cls = d_cls.float().contiguous()
        _check("d_cls", d_cls, (b, h, n), dev, contiguous=True)
    for name, t in (("q", q), ("k", k), ("d_out", d_out), ("out", out), ("kl", kl), ("mid", mid), ("ql", ql)):
        _aligned(name, t)
    lib = _bwd_library()
    n_splits, per_split = pass_b_backward_plan(b, h, n, m, _sm_count(dev.index), dh)
    w = _bwd_width(dh, cls)
    d_q = torch.empty((b, h, n, dh), device=dev, dtype=torch.float32)
    d_k = torch.empty_like(d_q) if cls else None
    lse = torch.empty((b, h, n), device=dev, dtype=torch.float32)
    dd = torch.empty_like(lse)
    rows = torch.empty((b, h, m, w), device=dev, dtype=torch.float32)  # d_kl | d_mid | d_ql | d_r'
    part = rows if n_splits == 1 else torch.empty((b * h, n_splits, m, w), device=dev, dtype=torch.float32)
    tickets = _tickets(dev, b * h * math.ceil(m / bwd_rows(dh)))
    with torch.cuda.device(dev):
        err = lib.flash_nystrom_pass_b_bwd(
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            mask.data_ptr(),
            kl.data_ptr(), lm_mask.data_ptr(), mid.data_ptr(), ql.data_ptr(), rp.data_ptr(), m3.data_ptr(),
            d_out.data_ptr(), d_out.stride(0), d_out.stride(1), d_out.stride(2),
            out.data_ptr(), out.stride(0), out.stride(1), out.stride(2),
            d_cls.data_ptr() if cls else None,
            d_q.data_ptr(), d_k.data_ptr() if cls else None,
            lse.data_ptr(), dd.data_ptr(), part.data_ptr(), rows.data_ptr(), tickets.data_ptr(),
            b, h, n, m, dh, n_splits, per_split, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "flash_nystrom_pass_b_bwd")
    d_kl, d_mid = rows[..., :dh], rows[..., dh:2 * dh]
    if not cls:
        return d_q, None, d_kl, d_mid, None, None, None
    d_rp = rows[..., 3 * dh]
    return d_q, d_k, d_kl, d_mid, rows[..., 2 * dh:3 * dh], d_rp, -rp * d_rp


pass_b_backward.launches = 0


def pass_a_backward(
    ql: Tensor, k: Tensor, v: Tensor, mask: Tensor, attn3v: Tensor, m3: Tensor, s3: Tensor,
    d_attn3v: Tensor, d_s3: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """K1b: the CUDA kernels on CUDA tensors, :func:`pass_a_backward_plain`
    (same arguments and fp32 outputs) on CPU tensors. ``k`` and ``v`` may be
    strided views whose rows start on 16 bytes; any head dim up to 256.
    Returns ``(d_ql, d_k, d_v)``."""
    extra = () if d_s3 is None else (d_s3,)
    if _on_cpu(ql, k, v, mask, attn3v, m3, s3, d_attn3v, *extra):
        return pass_a_backward_plain(ql, k, v, mask, attn3v, m3, s3, d_attn3v, d_s3)
    args = (ql, k, v, mask, attn3v, m3, s3, d_attn3v.contiguous(), d_s3)
    out = padded_head_dim(_launch_pass_a_backward, args, (0, 1, 2, 4, 7), (0, 1, 2))
    pass_a_backward.launches += 1
    return out


def _launch_pass_a_backward(
    ql: Tensor, k: Tensor, v: Tensor, mask: Tensor, attn3v: Tensor, m3: Tensor, s3: Tensor,
    d_attn3v: Tensor, d_s3: Optional[Tensor],
) -> Tuple[Tensor, Tensor, Tensor]:
    b, h, m, dh = ql.shape
    n = k.shape[2]
    dev = ql.device
    for name, t in (("ql", ql), ("attn3v", attn3v), ("d_attn3v", d_attn3v)):
        _check(name, t, (b, h, m, dh), dev, contiguous=True)
    _check("k", k, (b, h, n, dh), dev)
    _check("v", v, (b, h, n, dh), dev)
    _check("mask", mask, (b, n), dev, contiguous=True, dtype=torch.bool)
    if d_s3 is not None:
        d_s3 = d_s3.float().contiguous()
    for name, t in (("m3", m3), ("s3", s3)) + ((("d_s3", d_s3),) if d_s3 is not None else ()):
        _check(name, t, (b, h, m), dev, contiguous=True)
    for name, t in (("ql", ql), ("k", k), ("v", v), ("attn3v", attn3v), ("d_attn3v", d_attn3v)):
        _aligned(name, t)
    lib = _k1b_library()
    n_splits, per_split = pass_a_backward_plan(n, m, dh)
    d_ql = torch.empty((b, h, m, dh), device=dev, dtype=torch.float32)
    d_k = torch.empty((b, h, n, dh), device=dev, dtype=torch.float32)
    d_v = torch.empty_like(d_k)
    part = d_ql if n_splits == 1 else torch.empty((b * h, n_splits, m, dh), device=dev, dtype=torch.float32)
    tickets = _tickets(dev, b * h * math.ceil(m / bwd_rows(dh)))
    with torch.cuda.device(dev):
        err = lib.flash_nystrom_pass_a_bwd(
            ql.data_ptr(),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            mask.data_ptr(), attn3v.data_ptr(), m3.data_ptr(), s3.data_ptr(),
            d_attn3v.data_ptr(), d_s3.data_ptr() if d_s3 is not None else None,
            d_ql.data_ptr(), d_k.data_ptr(), d_v.data_ptr(),
            part.data_ptr(), tickets.data_ptr(),
            b, h, n, m, dh, n_splits, per_split, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "flash_nystrom_pass_a_bwd")
    return d_ql, d_k, d_v


pass_a_backward.launches = 0


class PassA(torch.autograd.Function):
    """K1 with K1b as its backward: ``(attn3v, m3, s3)`` of
    :func:`pass_a`, ``m3`` without a gradient (see the module's note)."""

    @staticmethod
    def forward(ctx, ql, k, v, mask):
        attn3v, m3, s3 = pass_a(ql, k, v, mask)
        ctx.save_for_backward(ql, k, v, mask, attn3v, m3, s3)
        ctx.mark_non_differentiable(m3)
        ctx.set_materialize_grads(False)
        return attn3v, m3, s3

    @staticmethod
    def backward(ctx, d_attn3v, _d_m3, d_s3):
        # attn3v always has a cotangent: it reaches out through mid
        flash_nystrom.backward_calls += 1
        ql, k, v, mask, attn3v, m3, s3 = ctx.saved_tensors
        return (*pass_a_backward(ql, k, v, mask, attn3v, m3, s3, d_attn3v, d_s3), None)


class PassB(torch.autograd.Function):
    """K2 with K2b as its backward: ``(out, cls)`` of :func:`pass_b`. The cls
    term of K2b runs only when ``cls`` has a cotangent."""

    @staticmethod
    def forward(ctx, q, k, mask, kl, lm_mask, mid, ql, rp, m3):
        out, cls = pass_b(q, k, mask, kl, lm_mask, mid, ql, rp, m3)
        ctx.save_for_backward(q, k, mask, kl, lm_mask, mid, ql, rp, m3, out)
        ctx.set_materialize_grads(False)
        return out, cls

    @staticmethod
    def backward(ctx, d_out, d_cls):
        q, k, mask, kl, lm_mask, mid, ql, rp, m3, out = ctx.saved_tensors
        if d_out is None:
            d_out = torch.zeros_like(q)
        d_q, d_k, d_kl, d_mid, d_ql, d_rp, _ = pass_b_backward(q, k, mask, kl, lm_mask, mid, ql, rp, m3,
                                                               d_out, d_cls, out=out)
        return d_q, d_k, None, d_kl, None, d_mid, d_ql, d_rp, None


def _nystrom_passes(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_landmarks: int,
                    pinv_iters: int) -> Tuple[Tensor, Tensor]:
    """The composition of K1, the glue and K2 on fp32 q, k, v and a bool
    mask, differentiable through :class:`PassA` and :class:`PassB`."""
    q_l, k_l, lm_mask, pinv = landmarks(q, k, mask, num_landmarks, pinv_iters)
    attn3v, m3, s3 = PassA.apply(q_l, k, v, mask)
    mid, rp = pass_b_operands(q, k_l, mask, lm_mask, pinv, attn3v, s3)
    return PassB.apply(q, k, mask, k_l, lm_mask, mid, q_l, rp, m3)


def flash_nystrom_infer(
    q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_landmarks: int, pinv_iters: int = 6,
) -> Tuple[Tensor, Tensor]:
    """Masked Nystrom attention forward without gradients, through K1 and K2.

    Same semantics as :func:`ops.nystrom.nystrom_attention` with
    ``return_attn=True``: ``q, k, v[B,H,N,dh]`` (q pre-scaled; any strides
    with a unit last stride; values at masked tokens are ignored),
    ``mask[B,N]``. Runs in fp32 whatever the input dtype and returns
    ``(out[B,H,N,dh], cls_attn[B,H,N])`` in fp32.

    The kernels' outputs carry no graph, so on CUDA this raises when grad
    mode is on and q, k or v require grad: use :func:`flash_nystrom` there.
    """
    if (torch.is_grad_enabled() and q.device.type == "cuda"
            and any(t.requires_grad for t in (q, k, v))):
        raise RuntimeError("flash_nystrom_infer has no gradient; call flash_nystrom under grad")
    with torch.no_grad():
        return _nystrom_passes(*(t.float() for t in (q, k, v)), mask.bool().contiguous(), num_landmarks,
                               pinv_iters)


def flash_nystrom(
    q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_landmarks: int, pinv_iters: int = 6,
) -> Tuple[Tensor, Tensor]:
    """Differentiable masked Nystrom attention (K3): the composition of
    :func:`flash_nystrom_infer` under autograd, so its gradients for q, k and
    v run through K2b, the glue's autograd and K1b, and the backward
    recomputes nothing. An unused output (the student never reads attn)
    gets no cotangent, and K2b then leaves the cls term out. Same arguments
    and fp32 outputs as :func:`flash_nystrom_infer`. ``forward_calls`` and
    ``backward_calls`` count the calls of each (the latter in
    :class:`PassA`'s backward, which every backward of K3 reaches)."""
    flash_nystrom.forward_calls += 1
    return _nystrom_passes(*(t.float() for t in (q, k, v)), mask.bool().contiguous(), num_landmarks,
                           pinv_iters)


flash_nystrom.forward_calls = 0
flash_nystrom.backward_calls = 0


def landmarks(q: Tensor, k: Tensor, mask: Tensor, num_landmarks: int, pinv_iters: int = 6):
    """Glue before K1: the landmark means ``q_l, k_l[B,H,m,dh]`` of the valid
    tokens (zero rows at empty groups, as the kernels expect), ``lm_mask[B,m]``
    and the pseudo-inverse of ``attn2 = softmax(Q_l·K_lᵀ)``, ``[B,H,m,m]``
    (K3p's :func:`~.nystrom_pinv.pseudo_inverse` on the card)."""
    mvalid = mask[:, None, :, None]
    q_l, lm_mask = _landmark_mean(torch.where(mvalid, q, 0.0), mask, num_landmarks)
    k_l, _ = _landmark_mean(torch.where(mvalid, k, 0.0), mask, num_landmarks)
    attn2 = masked_softmax(q_l @ k_l.transpose(-1, -2), lm_mask[:, None, None, :])
    return q_l, k_l, lm_mask, pseudo_inverse(attn2, pinv_iters)


def pass_b_operands(q: Tensor, k_l: Tensor, mask: Tensor, lm_mask: Tensor,
                    pinv: Tensor, attn3v: Tensor, s3: Tensor) -> Tuple[Tensor, Tensor]:
    """Glue between K1 and K2: ``mid = pinv @ attn3v`` and the cls-row weights
    ``r' = (attn1[token 0] @ pinv) / s3``, with the pass-A denominator folded in."""
    mid = (pinv @ attn3v).contiguous()
    q0 = torch.where(mask[:, None, :1, None], q[:, :, :1], 0.0)
    attn1_0 = masked_softmax(q0 @ k_l.transpose(-1, -2), lm_mask[:, None, None, :])
    r = (attn1_0 @ pinv)[:, :, 0]  # [B,H,m]
    return mid, (r / s3.clamp_min(1e-30)).contiguous()
