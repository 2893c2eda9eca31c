"""Fused masked ABMIL attention pooling (port of ``mhim_mil_tpu/ops/pallas_abmil.py``).

**K4** :func:`fused_abmil_pool`: the masked softmax of the attention logits
over a bag's instances and the attention-weighted sum of the instances, in
one pass over ``x[B, N, D]``. It launches the CUDA kernel of
``csrc/abmil_pool.cu`` on CUDA tensors, one launch a call up to 1,024
columns: blocks over chunks of a bag's tokens (:func:`abmil_plan`), the last
block of a bag merging the chunks in a fixed order and writing pooled and
attn (:func:`abmil_pool_chunked_plain` is that arithmetic in plain torch,
for tests). On CPU tensors it runs :func:`abmil_pool_plain`;
``fused_abmil_pool.launches`` counts its calls on the card. It is the
``torch.library`` op ``torch.ops.mhim_mil_torch.abmil_pool`` (a CPU and a
CUDA kernel and a fake), so that ``torch.export`` traces it.
:func:`column_groups` takes any width. No gradient: the training path keeps
the differentiable plain ops, as in the JAX package.

Under sequence parallelism each rank runs K4 on its block of a bag's
instances and :func:`merge_blocks` merges the blocks' ``(pooled, attn)``
over the sp row by each block's log-sum-exp of its logits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from ..kernels import load_library
from ..kernels.launch import H100_SMS, check, on_cpu, raise_on, rows_aligned, sm_count, tickets
from ..parallel.mesh import sp_max, sp_sum
from .masked import NEG_INF, masked_logsumexp, masked_softmax

Tensor = torch.Tensor
COLUMNS = 1024  # widest x a launch is given (the kernel takes a 16-byte piece of a row a thread)
THREADS, MAX_CHUNK, MAX_CHUNKS = 512, 1024, 4096  # csrc abmil_pool_limits
MIN_CHUNK = 64  # fewer tokens a block would leave the last block's merge the larger share
BLOCKS_PER_SM = 2


def abmil_pool_plain(x: Tensor, attn_logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """K4's function: ``attn = masked_softmax(logits)`` and
    ``pooled = Σ_n attn·x`` with masked instances zeroed. fp32 out."""
    mask = mask.bool()
    attn = masked_softmax(attn_logits.float(), mask)
    x = torch.where(mask[..., None], x.float(), 0.0)
    return torch.einsum("bn,bnd->bd", attn, x), attn


def merge_blocks(pooled: Tensor, attn: Tensor, attn_logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """K4's results on each rank's block of the instances merged over the
    active sp row: with ``lse`` each block's log-sum-exp of its valid
    logits and ``w = exp(lse − max lse) / Σ exp(lse − max lse)`` over the
    row, ``pooled = Σ w·pooled`` (on every rank) and this block's ``attn·w``.
    A block without a valid instance weighs 0."""
    lse = masked_logsumexp(attn_logits.float(), mask.bool())
    w = torch.exp(lse - sp_max(lse))
    w = torch.where(mask.any(dim=1), w, 0.0)
    both = sp_sum(torch.cat([pooled * w[:, None], w[:, None]], dim=1))
    w = w / both[:, -1].clamp_min(1e-30)
    return both[:, :-1] / both[:, -1:].clamp_min(1e-30), attn * w[:, None]


def abmil_plan(b: int, n: int, sms: int = H100_SMS) -> int:
    """Tokens of a K4 block: about :data:`BLOCKS_PER_SM` blocks an SM over
    the grid of ``b·⌈n/chunk⌉`` blocks, in multiples of 16 tokens, at least
    :data:`MIN_CHUNK`, at most :data:`MAX_CHUNK`, and few enough chunks a
    bag (:data:`MAX_CHUNKS`)."""
    chunk = min(MAX_CHUNK, max(MIN_CHUNK, 16 * math.ceil(b * n / (BLOCKS_PER_SM * sms) / 16)))
    chunk = max(chunk, math.ceil(n / MAX_CHUNKS))
    if chunk > MAX_CHUNK:
        raise ValueError(f"fused_abmil_pool takes at most {MAX_CHUNK * MAX_CHUNKS} instances a bag, got {n}")
    return chunk


def abmil_pool_chunked_plain(x: Tensor, attn_logits: Tensor, mask: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """K4's arithmetic as its one launch orders it, in plain torch (for
    tests): per chunk of ``chunk`` tokens its max ``m_c``, ``s_c = Σ
    exp(l − m_c)`` and ``acc_c = Σ exp(l − m_c)·x`` over the valid tokens
    (masked rows never read); then the chunks merged in chunk order,
    rescaled by ``exp(m_c − m)``, and attn from the bag's ``m`` and
    denominator. Same function and outputs as :func:`abmil_pool_plain`."""
    mask = mask.bool()
    logits = attn_logits.float()
    parts = []
    for t0 in range(0, x.shape[1], chunk):
        ok = mask[:, t0:t0 + chunk]
        m_c = torch.where(ok, logits[:, t0:t0 + chunk], NEG_INF).amax(dim=1)
        p = torch.where(ok, torch.exp(logits[:, t0:t0 + chunk] - m_c[:, None]), 0.0)
        xs = torch.where(ok[..., None], x[:, t0:t0 + chunk].float(), 0.0)
        parts.append((m_c, p.sum(dim=1), torch.einsum("bn,bnd->bd", p, xs)))
    m = torch.stack([m_c for m_c, _, _ in parts], dim=1).amax(dim=1)
    denom, pooled = torch.zeros_like(m), torch.zeros(x.shape[0], x.shape[2])
    for m_c, s_c, acc in parts:
        scale = torch.exp(m_c - m)
        denom = denom + s_c * scale
        pooled = pooled + acc * scale[:, None]
    denom = denom.clamp_min(1e-30)
    attn = torch.where(mask, torch.exp(logits - m[:, None]) / denom[:, None], 0.0)
    return pooled / denom[:, None], attn


def column_groups(call, x: Tensor, attn_logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """``call(x, attn_logits, mask) -> (pooled, attn)`` over groups of at most
    :data:`COLUMNS` columns of ``x``: each group a view (column slices keep
    the unit last stride), the groups' ``pooled`` concatenated. attn depends
    on the logits and the mask only, so every group's is the same: it comes
    from the first group."""
    if x.shape[-1] <= COLUMNS:
        return call(x, attn_logits, mask)
    parts = [call(x[..., c:c + COLUMNS], attn_logits, mask) for c in range(0, x.shape[-1], COLUMNS)]
    return torch.cat([p for p, _ in parts], dim=-1), parts[0][1]


def fused_abmil_pool(x: Tensor, attn_logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Masked softmax-attention pooling, the op
    ``torch.ops.mhim_mil_torch.abmil_pool``. ``x[B, N, D]`` (fp32 or bf16,
    any strides with a unit last stride; values at masked instances are
    ignored), ``attn_logits[B, N]``, ``mask[B, N]``, any D ≥ 1
    (:func:`column_groups`: one launch for D ≤ 1,024, ⌈D/1024⌉ above).
    Returns fp32 ``(pooled[B, D], attn[B, N])``, both from the kernel."""
    if not on_cpu(x, attn_logits, mask) and torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("fused_abmil_pool has no gradient; use the plain pool under grad")
    return torch.ops.mhim_mil_torch.abmil_pool(x, attn_logits, mask)


@torch.library.custom_op("mhim_mil_torch::abmil_pool", mutates_args=(), device_types=("cpu", "cuda"),
                         schema="(Tensor x, Tensor attn_logits, Tensor mask) -> (Tensor, Tensor)")
def _abmil_pool_op(x: Tensor, attn_logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    if on_cpu(x, attn_logits, mask):
        return abmil_pool_plain(x, attn_logits, mask)
    b, n, d = x.shape
    dev = x.device
    check("x", x, (b, n, d), dev, dtype=(torch.float32, torch.bfloat16))
    logits = attn_logits.detach().float().contiguous()
    mask = mask.bool().contiguous()
    check("attn_logits", logits, (b, n), dev, contiguous=True)
    check("mask", mask, (b, n), dev, contiguous=True, dtype=torch.bool)
    if n == 0 or d == 0:
        raise ValueError("fused_abmil_pool needs at least one instance slot and one column")
    out = column_groups(_launch, x, logits, mask)
    fused_abmil_pool.launches += 1
    return out


@_abmil_pool_op.register_fake
def _(x, attn_logits, mask):
    b, n, d = x.shape
    return x.new_empty((b, d), dtype=torch.float32), x.new_empty((b, n), dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _library():
    """K4's library, once its limits are checked against the wrapper's."""
    lib = load_library("abmil_pool")
    out = (ctypes.c_int * 3)()
    lib.abmil_pool_limits(out)
    if tuple(out) != (THREADS, MAX_CHUNK, MAX_CHUNKS):
        raise RuntimeError(f"abmil_pool.cu's limits {tuple(out)} differ from the wrapper's")
    return lib


def _launch(x: Tensor, logits: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    b, n, d = x.shape
    dev = x.device
    lib = _library()
    chunk = abmil_plan(b, n, sm_count(dev.index))
    nchunks = -(-n // chunk)
    part_ms = torch.empty((b, nchunks, 2), device=dev, dtype=torch.float32)
    part_acc = torch.empty((b, nchunks, -(-d // 4) * 4), device=dev, dtype=torch.float32)
    pooled = torch.empty((b, d), device=dev, dtype=torch.float32)
    attn = torch.empty((b, n), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.abmil_pool(
            x.data_ptr(), x.stride(0), x.stride(1), int(x.dtype == torch.bfloat16), int(rows_aligned(x)),
            logits.data_ptr(), mask.data_ptr(), part_ms.data_ptr(), part_acc.data_ptr(),
            tickets(dev, b).data_ptr(), pooled.data_ptr(), attn.data_ptr(),
            b, n, d, chunk, torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "abmil_pool")
    return pooled, attn


fused_abmil_pool.launches = 0
