"""Fused masked ABMIL attention pooling (port of ``mhim_mil_tpu/ops/pallas_abmil.py``).

**K4** :func:`fused_abmil_pool`: the masked softmax of the attention logits
over a bag's instances and the attention-weighted sum of the instances, in
one pass over ``x[B, N, D]`` with an online softmax. It launches the CUDA
kernel of ``csrc/abmil_pool.cu`` on CUDA tensors and runs
:func:`abmil_pool_plain` on CPU tensors; ``fused_abmil_pool.launches``
counts its calls on the card. The kernel takes at most 1,024 columns of x a
launch; :func:`column_groups` takes any width. No gradient: the training path keeps the
differentiable plain ops, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import load_library
from ..kernels.launch import check, on_cpu, raise_on
from .masked import masked_softmax

Tensor = torch.Tensor
COLUMNS = 1024  # widest x a launch takes (csrc THREADS × 8 columns a thread)


def abmil_pool_plain(x: Tensor, attn_logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """K4's function: ``attn = masked_softmax(logits)`` and
    ``pooled = Σ_n attn·x`` with masked instances zeroed. fp32 out."""
    mask = mask.bool()
    attn = masked_softmax(attn_logits.float(), mask)
    x = torch.where(mask[..., None], x.float(), 0.0)
    return torch.einsum("bn,bnd->bd", attn, x), attn


def column_groups(call, x: Tensor, attn_logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """``call(x, attn_logits, mask) -> (pooled, stats)`` over groups of at most
    :data:`COLUMNS` columns of ``x``: each group a view (column slices keep
    the unit last stride), the groups' ``pooled`` concatenated. The softmax
    statistics depend on the logits and the mask only, so every group's are
    the same: they come from the first group."""
    if x.shape[-1] <= COLUMNS:
        return call(x, attn_logits, mask)
    parts = [call(x[..., c:c + COLUMNS], attn_logits, mask) for c in range(0, x.shape[-1], COLUMNS)]
    return torch.cat([p for p, _ in parts], dim=-1), parts[0][1]


def fused_abmil_pool(x: Tensor, attn_logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Masked softmax-attention pooling. ``x[B, N, D]`` (fp32 or bf16, any
    strides with a unit last stride; values at masked instances are
    ignored), ``attn_logits[B, N]``, ``mask[B, N]``, any D ≥ 1
    (:func:`column_groups`: one launch for D ≤ 1,024, ⌈D/1024⌉ above).
    Returns fp32 ``(pooled[B, D], attn[B, N])``; ``attn`` is recomputed from
    the kernel's (denominator, max) stats, as ``pallas_abmil.py:135-143``
    does."""
    if on_cpu(x, attn_logits, mask):
        return abmil_pool_plain(x, attn_logits, mask)
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_abmil_pool has no gradient; use the plain pool under grad")
    b, n, d = x.shape
    dev = x.device
    check("x", x, (b, n, d), dev, dtype=(torch.float32, torch.bfloat16))
    logits = attn_logits.detach().float().contiguous()
    mask = mask.bool().contiguous()
    check("attn_logits", logits, (b, n), dev, contiguous=True)
    check("mask", mask, (b, n), dev, contiguous=True, dtype=torch.bool)
    if n == 0 or d == 0:
        raise ValueError("fused_abmil_pool needs at least one instance slot and one column")
    pooled, stats = column_groups(_launch, x, logits, mask)
    fused_abmil_pool.launches += 1
    denom, m = stats[:, 0:1], stats[:, 1:2]
    attn = torch.where(mask, torch.exp(logits - m) / denom.clamp_min(1e-30), 0.0)
    return pooled, attn


def _launch(x: Tensor, logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    b, n, d = x.shape
    dev = x.device
    lib = load_library("abmil_pool")
    nchunks = -(-n // lib.abmil_pool_chunk())
    part_m = torch.empty((b, nchunks), device=dev, dtype=torch.float32)
    part_s = torch.empty((b, nchunks), device=dev, dtype=torch.float32)
    part_acc = torch.empty((b, nchunks, d), device=dev, dtype=torch.float32)
    pooled = torch.empty((b, d), device=dev, dtype=torch.float32)
    stats = torch.empty((b, 2), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.abmil_pool(
            x.data_ptr(), x.stride(0), x.stride(1), int(x.dtype == torch.bfloat16),
            logits.data_ptr(), mask.data_ptr(),
            part_m.data_ptr(), part_s.data_ptr(), part_acc.data_ptr(),
            pooled.data_ptr(), stats.data_ptr(),
            b, n, d, torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "abmil_pool")
    return pooled, stats


fused_abmil_pool.launches = 0
