"""Masked Nystrom attention, the plain reference (port of ``mhim_mil_tpu/ops/nystrom.py``).

Eq. 15 of Xiong et al. 2021: ``softmax(Q·K_l)·pinv(softmax(Q_l·K_l))·
softmax(Q_l·K)·V``, with landmark means over groups of consecutive valid
tokens and the pseudo-inverse from 6 Newton–Schulz iterations.
:func:`nystrom_attention` materialises the ``[B,H,N,m]`` similarity tensors;
:func:`nystrom_attention_streamed` computes the same function in two passes
over windows of the bag and never does; the fused two-pass kernels that the
model runs on the card are ``ops/flash_nystrom.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import Seq, active as active_mesh, batch_max, sp_first, sp_max, sp_sum
from .masked import NEG_INF, masked_softmax, stats_dtype


def pinv_start(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` in fp32 (fp64 for fp64 input) and the Newton–Schulz start
    ``z0 = xᵀ / (max(row sums) · max(col sums))`` of its |x|. The scale is a
    max over ALL leading axes (batch and heads), as in the reference: the
    bags of one batch are coupled through it. Under an active mesh the two
    maxes are taken over the whole batch of every rank (``batch_max``), so
    that a rank's bags start from the scale of the one-process batch."""
    x = x.to(stats_dtype(x.dtype))
    abs_x = x.abs()
    col = abs_x.sum(dim=-1)
    row = abs_x.sum(dim=-2)
    if active_mesh() is None:
        denom = (col.max() * row.max()).clamp_min(1e-12)
    else:
        both = batch_max(torch.stack([col.max(), row.max()]))
        denom = (both[0] * both[1]).clamp_min(1e-12)
    return x, x.transpose(-1, -2) / denom


def newton_schulz_plain(x: torch.Tensor, z: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Newton–Schulz iterations for the pseudo-inverse of ``x``
    from ``z``."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Newton–Schulz pseudo-inverse of the trailing square matrices, in fp32
    (fp64 for fp64 input), from :func:`pinv_start`."""
    return newton_schulz_plain(*pinv_start(x), iters)


def _landmark_block(t: torch.Tensor, mask: torch.Tensor, m: int, seq: Seq, dim: int, parity: bool = False):
    """A block's part of the landmark means along ``dim`` of ``t``: the
    groups of :func:`_landmark_mean` over the global length ``seq.total``,
    token ``i`` of the block (global ``seq.offset + i``) in group
    ``(offset + i + pad) // l``. The block's group sums (in fp32, by one
    reshape of the block padded to whole groups) and counts are summed over
    the sp row (:func:`sp_sum`). Returns ``(sums`` with ``m`` along ``dim``,
    ``counts[B, m])``; with ``parity`` (a sequence already front-padded to
    ``m·l`` tokens) the sums and ``None``: every group counts ``l``."""
    n_tot, n = seq.total, seq.local
    l = -(-n_tot // m)
    start = seq.offset + m * l - n_tot
    g0, shift = divmod(start, l)
    g = -(-(shift + n) // l)
    f32 = stats_dtype(t.dtype)

    def groups(x: torch.Tensor, d: int) -> torch.Tensor:
        shape = list(x.shape)
        x = torch.cat([x.new_zeros(shape[:d] + [shift] + shape[d + 1:]), x,
                       x.new_zeros(shape[:d] + [g * l - shift - n] + shape[d + 1:])], dim=d)
        x = x.reshape(shape[:d] + [g, l] + shape[d + 1:]).sum(dim=d + 1, dtype=f32)
        return torch.cat([x.new_zeros(shape[:d] + [g0] + shape[d + 1:]), x,
                          x.new_zeros(shape[:d] + [m - g0 - g] + shape[d + 1:])], dim=d)

    return sp_sum(groups(t, dim)), None if parity else sp_sum(groups(mask.to(f32), 1))


def _landmark_mean(
    t: torch.Tensor, mask: torch.Tensor, m: int, parity: bool = False, seq: Optional[Seq] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked segment means of ``t[B,H,N,d]`` (zero at masked tokens) into
    ``m`` landmark groups: token i joins group ``(i + pad) // l`` with
    ``l = ceil(N/m)`` and ``pad = m·l − N``, so the first groups may be empty.

    Returns ``(means[B,H,m,d]`` in t's dtype, ``lm_mask[B,m])``; a group with
    no valid token is masked out and its mean is 0. ``parity`` reproduces the
    reference's unmasked full-bag path (JAX ``_landmark_mean(parity=True)``)
    on ``t`` already front-padded to ``m·l`` tokens (:func:`nystrom_attention`
    pads it): every group divided by ``l`` and every landmark valid.

    Given ``seq``, ``t`` and ``mask`` hold this rank's block of a sharded
    sequence (with ``parity``, of the front-padded one) and the means are
    those of the whole one, on every rank of the sp row
    (:func:`_landmark_block`).
    """
    b, h, n, d = t.shape
    if seq is not None:
        grp, cnt = _landmark_block(t, mask, m, seq, 2, parity)
        if parity:
            return (grp / (seq.total // m)).to(t.dtype), mask.new_ones((b, m), dtype=torch.bool)
        return (grp / cnt.clamp_min(1.0)[:, None, :, None]).to(t.dtype), cnt > 0
    l = -(-n // m)
    f32 = stats_dtype(t.dtype)
    if parity:
        grp = t.reshape(b, h, m, l, d).sum(dim=3, dtype=f32)
        return (grp / l).to(t.dtype), mask.new_ones((b, m), dtype=torch.bool)
    # The first `empty` groups hold no token, the next one `first` tokens,
    # and the rest `l` each: one read of t, no padded copy.
    empty, short = divmod(m * l - n, l)
    first = l - short
    full = m - empty - 1
    grp = torch.cat([
        t.new_zeros((b, h, empty, d), dtype=f32),
        t[:, :, :first].sum(dim=2, keepdim=True, dtype=f32),
        t[:, :, first:].reshape(b, h, full, l, d).sum(dim=3, dtype=f32),
    ], dim=2)
    mask = mask.to(f32)
    cnt = torch.cat([
        mask.new_zeros((b, empty)),
        mask[:, :first].sum(dim=1, keepdim=True),
        mask[:, first:].reshape(b, full, l).sum(dim=2),
    ], dim=1)
    lm_mask = cnt > 0
    grp = grp / cnt.clamp_min(1.0)[:, None, :, None]
    return grp.to(t.dtype), lm_mask


def nystrom_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    num_landmarks: int,
    pinv_iters: int = 6,
    return_attn: bool = False,
    no_norm: bool = False,
    parity: bool = False,
    seq: Optional[Seq] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Masked Nystrom attention.

    Args:
      q, k, v: ``[B, H, N, dh]``, q pre-scaled by ``dh**-0.5``.
      mask: ``[B, N]`` validity.
      return_attn: also return the cls row (token 0) of the attention.
      no_norm: the returned attention from the unsoftmaxed similarities and
        the pseudo-inverse of the raw ``sim2`` (the reference's ``no_norm``
        path, nystrom_attention.py:131-134); ``out`` is unchanged.
      parity: the reference's unmasked full-bag arithmetic (JAX
        ``nystrom_attention(parity=True)``): q, k and v front-padded to a
        multiple of ``num_landmarks`` tokens, the padding then counted as
        valid keys (its zeros enter attn3's softmax), landmark means over
        the whole group; right only for unpadded bags.
      seq: the layout of a sequence sharded over the active sp row: q, k,
        v and mask hold this rank's block; the landmarks and ``attn3``'s
        softmax and ``attn3 @ v`` are the whole sequence's, the cls row
        comes from the rank that holds token 0, and the outputs are this
        block's. With ``parity`` the front padding of the whole sequence
        (``m·ceil(N/m) − N`` tokens, N = ``seq.total``) goes in front of sp
        rank 0's block, which holds the cls row and drops the padding from
        its outputs.

    The big ``[B,H,N,m]`` tensors take q's dtype; softmax statistics and the
    pseudo-inverse run in fp32 (all of it in fp64 for fp64 input).

    Returns ``out[B,H,N,dh]`` (zero at masked tokens) and, when
    ``return_attn``, ``cls_attn[B,H,N]`` in fp32 (fp64 for fp64 input).
    """
    mask = mask.bool()
    m = num_landmarks
    front_pad = 0  # the padding in front of this block
    if parity:
        n0 = q.shape[2] if seq is None else seq.total
        pad = m * -(-n0 // m) - n0
        if seq is not None:
            front_pad, seq = (pad if seq.index == 0 else 0), seq.prepend(pad)
        else:
            front_pad = pad
        if front_pad:
            q, k, v = (F.pad(t, (0, 0, front_pad, 0)) for t in (q, k, v))
        if pad:
            mask = mask.new_ones((q.shape[0], q.shape[2]))
    mvalid = mask[:, None, :, None]
    q, k, v = (torch.where(mvalid, t, 0) for t in (q, k, v))
    q_l, lm_mask = _landmark_mean(q, mask, m, parity, seq)
    k_l, _ = _landmark_mean(k, mask, m, parity, seq)

    sim1 = q @ k_l.transpose(-1, -2)  # [B,H,N,m]
    sim2 = q_l @ k_l.transpose(-1, -2)  # [B,H,m,m]
    sim3 = q_l @ k.transpose(-1, -2)  # [B,H,m,N]

    lm_b = lm_mask[:, None, None, :]
    attn1 = masked_softmax(sim1, lm_b)
    attn2 = masked_softmax(sim2, lm_b)
    attn3 = masked_softmax(sim3, mask[:, None, None, :], sharded=seq is not None)
    pinv = moore_penrose_pinv(attn2, pinv_iters).to(q.dtype)

    # attn1 @ (pinv @ (attn3 @ v)): the small factors first
    attn3v = attn3 @ v if seq is None else sp_sum(attn3 @ v)
    out = torch.where(mvalid, attn1 @ (pinv @ attn3v), 0)[:, :, front_pad:]
    if not return_attn:
        return out, None
    if no_norm:
        a1, a2, a3 = sim1, moore_penrose_pinv(sim2, pinv_iters).to(q.dtype), sim3
    else:
        a1, a2, a3 = attn1, pinv, attn3
    f32 = stats_dtype(q.dtype)
    a1_0 = a1[:, :, front_pad:front_pad + 1]
    if seq is not None:
        a1_0 = sp_first(a1_0, seq)
    cls_row = a1_0.to(f32) @ a2.to(f32)  # [B,H,1,m]
    cls_attn = (cls_row @ a3.to(f32))[:, :, 0, front_pad:]  # [B,H,N]
    return out, cls_attn


def _landmark_mean_seq(t: torch.Tensor, mask: torch.Tensor, m: int,
                       seq: Optional[Seq] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_landmark_mean` of sequence-major ``t[B,N,H,d]`` (zero at
    masked tokens; ``nystrom.py:211-223``): the same groups, token i in
    group ``(i + pad) // l``. Returns ``(means[B,H,m,d]`` in t's dtype,
    summed in fp32, ``lm_mask[B,m])``; given ``seq``, those of the whole
    sharded sequence (:func:`_landmark_block`)."""
    b, n, h, d = t.shape
    if seq is not None:
        grp, cnt = _landmark_block(t, mask, m, seq, 1)
        return (grp.transpose(1, 2) / cnt.clamp_min(1.0)[:, None, :, None]).to(t.dtype), cnt > 0
    l = -(-n // m)
    f32 = stats_dtype(t.dtype)
    empty, short = divmod(m * l - n, l)
    first = l - short
    full = m - empty - 1
    grp = torch.cat([
        t.new_zeros((b, empty, h, d), dtype=f32),
        t[:, :first].sum(dim=1, keepdim=True, dtype=f32),
        t[:, first:].reshape(b, full, l, h, d).sum(dim=2, dtype=f32),
    ], dim=1).transpose(1, 2)  # [B,H,m,d]
    mask = mask.to(f32)
    cnt = torch.cat([
        mask.new_zeros((b, empty)),
        mask[:, :first].sum(dim=1, keepdim=True),
        mask[:, first:].reshape(b, full, l).sum(dim=2),
    ], dim=1)
    grp = grp / cnt.clamp_min(1.0)[:, None, :, None]
    return grp.to(t.dtype), cnt > 0


def _f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` accumulated and returned in fp32 (JAX's ``einsum_f32``)."""
    return torch.einsum(eq, a.float(), b.float())


def nystrom_attention_streamed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    num_landmarks: int,
    pinv_iters: int = 6,
    return_attn: bool = False,
    chunk: int = 1024,
    compute_dtype: Optional[torch.dtype] = None,
    pre_masked: bool = False,
    seq: Optional[Seq] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Masked Nystrom attention streamed over windows of the bag
    (``nystrom.py:226-401``): the function of :func:`nystrom_attention`
    (without its ``no_norm`` and ``parity`` modes), with no ``[B,H,N,m]``
    tensor built. Plain torch, a Python loop over the windows, differentiable.

    Args:
      q, k, v: **sequence-major** ``[B, N, H, dh]`` (the qkv projection's
        layout), q pre-scaled by ``dh**-0.5``.
      mask: ``[B, N]`` validity.
      chunk: tokens a window; window i starts at ``min(i·chunk, N − chunk)``,
        so the last one is clamped and overlaps the one before.
      compute_dtype: the dtype q, k, v are cast to (default q's); ``attn1``
        is cast to it before ``@ z``.
      pre_masked: q, k and v are already zero at masked tokens.
      seq: the layout of a sequence sharded over the active sp row: q, k,
        v and mask hold this rank's block. The landmarks are the whole
        sequence's, the windows this block's, phase 1's row maxes, sums
        and ``attn3@V`` are merged over the row before ``z``, and the cls
        row comes from the rank that holds token 0. ``out`` and
        ``cls_attn`` are this block's.

    Phase 1 runs the online softmax of ``attn3 = softmax_N(Q_l·Kᵀ)`` for
    each landmark row, accumulating ``attn3@V`` in fp32; keys that a clamped
    window covers again are masked out of it. Then ``z = pinv(attn2) @
    attn3v``. Phase 2 computes each window's ``out = softmax_m(Q·K_lᵀ) @ z``
    (and the cls row's part), keeping only the tail window's fresh rows.

    Returns ``out[B, N, H·dh]`` (zero at masked tokens) and, with
    ``return_attn``, the cls row ``cls_attn[B, H, N]`` in fp32.
    """
    mask = mask.bool()
    cd = compute_dtype or q.dtype
    b, n, h, dh = q.shape
    m = num_landmarks
    if pre_masked:
        q, k, v = (t.to(cd) for t in (q, k, v))
    else:
        mvalid = mask[:, :, None, None]
        q, k, v = (torch.where(mvalid, t, 0).to(cd) for t in (q, k, v))
    q_l, lm_mask = _landmark_mean_seq(q, mask, m, seq)  # [B,H,m,dh], [B,m]
    k_l, _ = _landmark_mean_seq(k, mask, m, seq)
    lm_b = lm_mask[:, None, None, :]
    pinv = moore_penrose_pinv(masked_softmax(q_l @ k_l.transpose(-1, -2), lm_b), pinv_iters)  # fp32

    chunk = min(chunk, n)
    windows = [(min(i * chunk, n - chunk), i * chunk) for i in range(-(-n // chunk))] if n else []  # (start, fresh)
    pos = torch.arange(chunk, device=q.device)

    def sim3(off: int, fresh: int):
        """A window's ``Q_l·Kᵀ [B,H,m,chunk]`` in fp32, NEG_INF at masked and
        already covered keys, and its key mask ``[B,1,1,chunk]``."""
        m_c = (mask[:, off:off + chunk] & (off + pos >= fresh)[None, :])[:, None, None, :]
        s = _f32("bhmd,bnhd->bhmn", q_l, k[:, off:off + chunk])
        return torch.where(m_c, s, NEG_INF), m_c

    # phase 1: the online softmax over the keys, attn3 @ V in fp32
    run_max = q.new_full((b, h, m), NEG_INF, dtype=torch.float32)
    run_sum = q.new_zeros((b, h, m), dtype=torch.float32)
    acc = q.new_zeros((b, h, m, dh), dtype=torch.float32)
    for off, fresh in windows:
        s, m_c = sim3(off, fresh)
        new_max = torch.maximum(run_max, s.amax(dim=-1)).detach()  # the softmax does not move with it
        scale = torch.exp(run_max - new_max)
        p = torch.exp(s - new_max[..., None]) * m_c
        acc = acc * scale[..., None] + _f32("bhmn,bnhd->bhmd", p.to(cd), v[:, off:off + chunk])
        run_sum = run_sum * scale + p.sum(dim=-1)
        run_max = new_max
    if seq is not None:  # the blocks' online softmaxes merged over the sp row
        new_max = sp_max(run_max)
        scale = torch.exp(run_max - new_max)
        acc, run_sum, run_max = sp_sum(acc * scale[..., None]), sp_sum(run_sum * scale), new_max
    run_sum = run_sum.clamp_min(1e-30)
    z = (pinv @ (acc / run_sum[..., None])).to(cd)  # [B,H,m,dh]
    if return_attn:  # the cls row of attn1 (token 0) @ pinv: [B,H,1,m]
        q0 = q[:, :1] if seq is None else sp_first(q[:, :1], seq)
        r = (masked_softmax(_f32("bnhd,bhmd->bhnm", q0, k_l), lm_b) @ pinv).to(cd)

    # phase 2: out = softmax_m(Q·K_lᵀ) @ z and the cls row, window by window
    outs, cls = [], []
    for off, fresh in windows:
        attn1 = masked_softmax(_f32("bnhd,bhmd->bhnm", q[:, off:off + chunk], k_l), lm_b).to(cd)
        out_c = torch.einsum("bhnm,bhmd->bnhd", attn1, z).reshape(b, chunk, h * dh)
        outs.append(torch.where(mask[:, off:off + chunk, None], out_c, 0)[:, fresh - off:])
        if return_attn:
            s, m_c = sim3(off, off)
            attn3 = torch.exp(s - run_max[..., None]) * (m_c * (1.0 / run_sum)[..., None])
            cls.append(_f32("bhom,bhmn->bhon", r, attn3.to(cd))[:, :, 0, fresh - off:])
    if not outs:  # an empty block
        return q.new_zeros((b, 0, h * dh)), (q.new_zeros((b, h, 0), dtype=torch.float32) if return_attn else None)
    return torch.cat(outs, dim=1), (torch.cat(cls, dim=-1) if return_attn else None)
