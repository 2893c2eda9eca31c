"""Fused masked Nystrom attention for inference (port of ``mhim_mil_tpu/ops/pallas_nystrom.py``).

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

**K3** :func:`flash_nystrom` is the differentiable form (the port of the
custom VJP at ``pallas_nystrom.py:249-304``): its forward is
:func:`flash_nystrom_infer`, its backward recomputes through the plain
:func:`ops.nystrom.nystrom_attention` in fp32 and differentiates that, as
the JAX package's backward does (there it is XLA, not a kernel). Its counts
are ``FlashNystrom.forward_calls`` and ``FlashNystrom.backward_calls``.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from ..kernels import load_library
from ..kernels.launch import check as _check, check_rows_aligned as _aligned
from ..kernels.launch import on_cpu as _on_cpu, raise_on as _raise_on
from .masked import NEG_INF, masked_softmax
from .nystrom import _landmark_mean, moore_penrose_pinv, nystrom_attention

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


PASS_A_ROWS = 128  # landmark rows of a K1 block (csrc A_ROWS)
PASS_A_KEYS = 32  # keys of a K1 tile; a split is a whole number of tiles (csrc COLS)
PASS_A_RESIDENT = 2  # K1 blocks an SM holds (its __launch_bounds__ and shared memory)
H100_SMS = 132


def pass_a_plan(b: int, h: int, n: int, m: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """K1's split of the keys: ``(n_splits, per_split)``, split ``s`` taking
    keys ``[s·per_split, min(n, (s + 1)·per_split))``. Aims at two full waves
    of resident blocks (``2·PASS_A_RESIDENT·sms``) over the grid's
    ``b·h·⌈m/128⌉`` landmark blocks per split, rounding the split count down
    so that the last wave is not a sliver; ``per_split`` is a whole number
    of 32-key tiles, and no split is empty."""
    row_blocks = b * h * math.ceil(m / PASS_A_ROWS)
    tiles = max(1, math.ceil(n / PASS_A_KEYS))
    target = max(1, min(tiles, (2 * PASS_A_RESIDENT * sms) // row_blocks))
    per_split = math.ceil(tiles / target) * PASS_A_KEYS
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library():
    """The kernels' library, once its K1 geometry is checked against the plan's."""
    lib = load_library("flash_nystrom")
    if (lib.flash_nystrom_pass_a_rows(), lib.flash_nystrom_pass_a_keys()) != (PASS_A_ROWS, PASS_A_KEYS):
        raise RuntimeError("flash_nystrom.cu's K1 geometry differs from pass_a_plan's")
    return lib


def pass_a(ql: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K1: the CUDA kernels on CUDA tensors, :func:`pass_a_plain` on CPU tensors.
    ``k`` and ``v`` may be any strided view with a unit last stride whose
    rows start on 16 bytes."""
    if _on_cpu(ql, k, v, mask):
        return pass_a_plain(ql, k, v, mask)
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
    n_splits, per_split = pass_a_plan(b, h, n, m, _sm_count(dev.index))
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
    pass_a.launches += 1
    return attn3v, m3, s3


pass_a.launches = 0


def pass_b(
    q: Tensor, k: Tensor, mask: Tensor, kl: Tensor, lm_mask: Tensor,
    mid: Tensor, ql: Tensor, rp: Tensor, m3: Tensor,
) -> Tuple[Tensor, Tensor]:
    """K2: the CUDA kernel on CUDA tensors, :func:`pass_b_plain` on CPU tensors.
    ``q`` and ``k`` may be strided views whose rows start on 16 bytes; ``out``
    comes back as a ``[B,H,N,dh]`` view of ``[B,N,H,dh]`` storage, so the
    caller's merge of the heads is free."""
    if _on_cpu(q, k, mask, kl, lm_mask, mid, ql, rp, m3):
        return pass_b_plain(q, k, mask, kl, lm_mask, mid, ql, rp, m3)
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
    pass_b.launches += 1
    return out, cls


pass_b.launches = 0


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
    mask = mask.bool().contiguous()
    q, k, v = (t.float() for t in (q, k, v))
    q_l, k_l, lm_mask, pinv = landmarks(q, k, mask, num_landmarks, pinv_iters)
    attn3v, m3, s3 = pass_a(q_l, k, v, mask)
    mid, rp = pass_b_operands(q, k_l, mask, lm_mask, pinv, attn3v, s3)
    return pass_b(q, k, mask, k_l, lm_mask, mid, q_l, rp, m3)


class FlashNystrom(torch.autograd.Function):
    """K3: the forward is :func:`flash_nystrom_infer` (K1 + K2 on the card);
    the backward recomputes :func:`nystrom_attention` in fp32 from the saved
    q, k, v and differentiates it, as the JAX custom VJP does
    (``pallas_nystrom.py:273-301``). ``forward_calls`` and
    ``backward_calls`` count the calls of each."""

    forward_calls = 0
    backward_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, mask, num_landmarks, pinv_iters):
        ctx.save_for_backward(q, k, v, mask)
        ctx.num_landmarks, ctx.pinv_iters = num_landmarks, pinv_iters
        # An unused output (the student never reads attn) gets a None
        # cotangent, and the backward then leaves its products out.
        ctx.set_materialize_grads(False)
        with torch.no_grad():
            out, attn = flash_nystrom_infer(q, k, v, mask, num_landmarks, pinv_iters)
        FlashNystrom.forward_calls += 1
        return out, attn

    @staticmethod
    def backward(ctx, d_out, d_attn):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
            out, attn = nystrom_attention(qf, kf, vf, mask, ctx.num_landmarks, ctx.pinv_iters,
                                          return_attn=d_attn is not None)
            # A missing cotangent counts as zeros: leave its output out.
            outs, cots = [out], [d_out.float() if d_out is not None else torch.zeros_like(out)]
            if d_attn is not None:
                outs.append(attn)
                cots.append(d_attn.float())
            dq, dk, dv = torch.autograd.grad(outs, (qf, kf, vf), cots)
        FlashNystrom.backward_calls += 1
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_nystrom(
    q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_landmarks: int, pinv_iters: int = 6,
) -> Tuple[Tensor, Tensor]:
    """Differentiable masked Nystrom attention (K3): the fused forward of
    :func:`flash_nystrom_infer` with gradients for q, k and v by recompute.
    Same arguments and fp32 outputs as :func:`flash_nystrom_infer`."""
    return FlashNystrom.apply(q, k, v, mask.bool(), num_landmarks, pinv_iters)


def landmarks(q: Tensor, k: Tensor, mask: Tensor, num_landmarks: int, pinv_iters: int = 6):
    """Glue before K1: the landmark means ``q_l, k_l[B,H,m,dh]`` of the valid
    tokens (zero rows at empty groups, as the kernels expect), ``lm_mask[B,m]``
    and the pseudo-inverse of ``attn2 = softmax(Q_l·K_lᵀ)``, ``[B,H,m,m]``."""
    mvalid = mask[:, None, :, None]
    q_l, lm_mask = _landmark_mean(torch.where(mvalid, q, 0.0), mask, num_landmarks)
    k_l, _ = _landmark_mean(torch.where(mvalid, k, 0.0), mask, num_landmarks)
    attn2 = masked_softmax(q_l @ k_l.transpose(-1, -2), lm_mask[:, None, None, :])
    return q_l, k_l, lm_mask, moore_penrose_pinv(attn2, pinv_iters)


def pass_b_operands(q: Tensor, k_l: Tensor, mask: Tensor, lm_mask: Tensor,
                    pinv: Tensor, attn3v: Tensor, s3: Tensor) -> Tuple[Tensor, Tensor]:
    """Glue between K1 and K2: ``mid = pinv @ attn3v`` and the cls-row weights
    ``r' = (attn1[token 0] @ pinv) / s3``, with the pass-A denominator folded in."""
    mid = (pinv @ attn3v).contiguous()
    q0 = torch.where(mask[:, None, :1, None], q[:, :, :1], 0.0)
    attn1_0 = masked_softmax(q0 @ k_l.transpose(-1, -2), lm_mask[:, None, None, :])
    r = (attn1_0 @ pinv)[:, :, 0]  # [B,H,m]
    return mid, (r / s3.clamp_min(1e-30)).contiguous()
