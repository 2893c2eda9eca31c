"""Masked Nystrom attention, the plain reference (port of ``mhim_mil_tpu/ops/nystrom.py``).

Eq. 15 of Xiong et al. 2021: ``softmax(Q·K_l)·pinv(softmax(Q_l·K_l))·
softmax(Q_l·K)·V``, with landmark means over groups of consecutive valid
tokens and the pseudo-inverse from 6 Newton–Schulz iterations. This
materialises the ``[B,H,N,m]`` similarity tensors; the fused two-pass version
that the model runs is ``ops/flash_nystrom.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .masked import masked_softmax, stats_dtype


def pinv_start(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` in fp32 (fp64 for fp64 input) and the Newton–Schulz start
    ``z0 = xᵀ / (max(row sums) · max(col sums))`` of its |x|. The scale is a
    max over ALL leading axes (batch and heads), as in the reference: the
    bags of one batch are coupled through it."""
    x = x.to(stats_dtype(x.dtype))
    abs_x = x.abs()
    col = abs_x.sum(dim=-1)
    row = abs_x.sum(dim=-2)
    denom = (col.max() * row.max()).clamp_min(1e-12)
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


def _landmark_mean(
    t: torch.Tensor, mask: torch.Tensor, m: int, parity: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked segment means of ``t[B,H,N,d]`` (zero at masked tokens) into
    ``m`` landmark groups: token i joins group ``(i + pad) // l`` with
    ``l = ceil(N/m)`` and ``pad = m·l − N``, so the first groups may be empty.

    Returns ``(means[B,H,m,d]`` in t's dtype, ``lm_mask[B,m])``; a group with
    no valid token is masked out and its mean is 0. ``parity`` reproduces the
    reference's unmasked full-bag path (JAX ``_landmark_mean(parity=True)``)
    on ``t`` already front-padded to ``m·l`` tokens (:func:`nystrom_attention`
    pads it): every group divided by ``l`` and every landmark valid.
    """
    b, h, n, d = t.shape
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

    The big ``[B,H,N,m]`` tensors take q's dtype; softmax statistics and the
    pseudo-inverse run in fp32 (all of it in fp64 for fp64 input).

    Returns ``out[B,H,N,dh]`` (zero at masked tokens) and, when
    ``return_attn``, ``cls_attn[B,H,N]`` in fp32 (fp64 for fp64 input).
    """
    mask = mask.bool()
    m = num_landmarks
    front_pad = 0
    if parity:
        n0 = q.shape[2]
        front_pad = m * -(-n0 // m) - n0
        if front_pad:
            q, k, v = (F.pad(t, (0, 0, front_pad, 0)) for t in (q, k, v))
            mask = mask.new_ones((q.shape[0], q.shape[2]))
    mvalid = mask[:, None, :, None]
    q, k, v = (torch.where(mvalid, t, 0) for t in (q, k, v))
    q_l, lm_mask = _landmark_mean(q, mask, m, parity)
    k_l, _ = _landmark_mean(k, mask, m, parity)

    sim1 = q @ k_l.transpose(-1, -2)  # [B,H,N,m]
    sim2 = q_l @ k_l.transpose(-1, -2)  # [B,H,m,m]
    sim3 = q_l @ k.transpose(-1, -2)  # [B,H,m,N]

    lm_b = lm_mask[:, None, None, :]
    attn1 = masked_softmax(sim1, lm_b)
    attn2 = masked_softmax(sim2, lm_b)
    attn3 = masked_softmax(sim3, mask[:, None, None, :])
    pinv = moore_penrose_pinv(attn2, pinv_iters).to(q.dtype)

    # attn1 @ (pinv @ (attn3 @ v)): the small factors first
    out = torch.where(mvalid, attn1 @ (pinv @ (attn3 @ v)), 0)[:, :, front_pad:]
    if not return_attn:
        return out, None
    if no_norm:
        a1, a2, a3 = sim1, moore_penrose_pinv(sim2, pinv_iters).to(q.dtype), sim3
    else:
        a1, a2, a3 = attn1, pinv, attn3
    f32 = stats_dtype(q.dtype)
    cls_row = a1[:, :, front_pad:front_pad + 1].to(f32) @ a2.to(f32)  # [B,H,1,m]
    cls_attn = (cls_row @ a3.to(f32))[:, :, 0, front_pad:]  # [B,H,N]
    return out, cls_attn
