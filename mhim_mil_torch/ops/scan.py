"""Linear recurrences for the Mamba models (port of ``mhim_mil_tpu/ops/scan.py``).

:func:`linear_scan` is the first-order recurrence ``h[t] = a[t]·h[t-1] + x[t]``
as a log-step doubling scan; :func:`selective_scan_1d` the masked 1D
selective scan of ``mambamil``, streamed in chunks along L; and
:func:`selective_scan_2d` the 2D selective scan over a ``[Bs, H, W, ·]``
grid, streamed row by row. Neither builds its whole ``[Bs, ·, ED, N]``
lattice. These are the plain versions: the training path differentiates
them, and ``ops/scan2d.py`` holds the K5 kernel of the separable 2D variant
against them. The 1D scan has no kernel: JAX computes it in XLA.
:func:`selective_scan_1d_seq` is the sequential recurrence, for tests.

Both scans can start from a given state and return their last one
(``h0``, ``return_state``). Under a mesh that splits the instances
(``parallel/mesh.py``, ``sp > 1``), :func:`selective_scan_1d_sharded` and
:func:`selective_scan_2d_sharded` scan a rank's block of the sequence or
band of grid rows with the state the blocks before it hand on (see the
note above them).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import Seq, sp_carry, sp_join

Tensor = torch.Tensor


def _shift(t: Tensor, d: int, dim: int, fill: float) -> Tensor:
    """``t`` moved ``d`` steps forward along ``dim``, the first ``d`` slots ``fill``."""
    head = torch.full_like(t.narrow(dim, 0, d), fill)
    return torch.cat([head, t.narrow(dim, 0, t.shape[dim] - d)], dim)


def linear_scan(a: Tensor, x: Tensor, dim: int = 0) -> Tensor:
    """All prefix states of ``h[t] = a[t]·h[t-1] + x[t]`` (h[-1] = 0) along ``dim``.

    Hillis–Steele doubling over the monoid ``(a₁, x₁)∘(a₂, x₂) = (a₁a₂,
    a₂x₁ + x₂)``, the one JAX's ``associative_scan`` and the Pallas kernel's
    ``_hillis_steele`` use: ⌈log₂L⌉ steps, no Python loop over the axis. The
    closed form through ``cumprod(a)`` is not used: the product of ā over a
    real row underflows to 0 in fp32 and the division by it gives NaN.
    """
    length = a.shape[dim]
    d = 1
    while d < length:
        x = x + a * _shift(x, d, dim, 0.0)
        if 2 * d < length:  # the last step needs no product
            a = a * _shift(a, d, dim, 1.0)
        d *= 2
    return x


SCAN_CHUNK = 1024  # tokens of the 1D lattice built at a time


def _scan_chunk_1d(x: Tensor, delta: Tensor, B: Tensor, C: Tensor, mask: Optional[Tensor],
                   h0: Optional[Tensor], A: Tensor, D: Tensor):
    """One chunk of :func:`selective_scan_1d` from the state ``h0[Bs, ED, N]``
    before it (None: zero): ``(y[Bs, Lc, ED], h at its last step)``. The
    chunk's lattice ``[Bs, Lc, ED, N]`` is built here from the thin inputs."""
    dA = torch.exp(delta[..., None] * A)  # [Bs, Lc, ED, N]
    dBx = (delta * x)[..., None] * B[..., None, :]
    if mask is not None:
        m = mask[..., None, None]
        dA = torch.where(m, dA, 1.0)
        dBx = torch.where(m, dBx, 0.0)
    if h0 is not None:  # h[0] = ā[0]·h0 + b̄x[0]; the rest of the recurrence is unchanged
        dBx = torch.cat([dBx[:, :1] + dA[:, :1] * h0[:, None], dBx[:, 1:]], 1)
    hs = linear_scan(dA, dBx, dim=1)
    y = torch.einsum("blen,bln->ble", hs, C) + D * x
    if mask is not None:
        y = torch.where(mask[..., None], y, 0.0)
    return y, hs[:, -1]


def selective_scan_1d(x: Tensor, delta: Tensor, A: Tensor, B: Tensor, C: Tensor, D: Tensor,
                      mask: Optional[Tensor] = None, chunk: int = SCAN_CHUNK, h0: Optional[Tensor] = None,
                      return_state: bool = False):
    """1D selective scan (``scan.py:38-67``; reference mamba_simple.py:344-423).

    ``h[t] = ā[t]·h[t−1] + b̄x[t]``, ``y[t] = Σ_n h[t]·C[t] + D·x[t]`` with
    ā = exp(Δ·A), b̄x = Δ·x·B. Args: ``x``, ``delta`` ``[Bs, L, ED]``
    (softplus applied); ``A`` ``[ED, N]`` (negative); ``B``, ``C``
    ``[Bs, L, N]``; ``D`` ``[ED]``; ``mask`` ``[Bs, L]`` validity or None.
    A masked step carries the state through unchanged (ā = 1, b̄x = 0) and
    gives y = 0, so ragged bags and permuted padding scan correctly.

    The inputs are cast to fp32 whatever the policy. The scan runs in
    chunks of ``chunk`` tokens, the state carried from one to the next, so
    at most one chunk's lattice is alive; when a gradient is wanted each
    chunk runs under ``torch.utils.checkpoint``, so the backward keeps only
    the thin inputs and the state at each chunk's start, and rebuilds one
    chunk's lattice at a time. Returns fp32 ``y[Bs, L, ED]``.

    ``h0[Bs, ED, N]`` is the state entering the first step (None: zero);
    with ``return_state`` the result is ``(y, h)``, h the state after the
    last step: what a block of a sequence sharded over ranks hands on
    (:func:`selective_scan_1d_sharded`).
    """
    x, delta, A, B, C, D = (t.float() for t in (x, delta, A, B, C, D))
    if mask is not None:
        mask = mask.bool()
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, delta, A, B, C, D, h0) if t is not None)
    ys, h = [], None if h0 is None else h0.float()
    for s in range(0, x.shape[1], chunk):
        part = [t[:, s:s + chunk] for t in (x, delta, B, C)]
        m = None if mask is None else mask[:, s:s + chunk]
        if grad:
            y, h = checkpoint(_scan_chunk_1d, *part, m, h, A, D, use_reentrant=False)
        else:
            y, h = _scan_chunk_1d(*part, m, h, A, D)
        ys.append(y)
    y = torch.cat(ys, 1)
    return (y, h) if return_state else y


def selective_scan_1d_seq(x: Tensor, delta: Tensor, A: Tensor, B: Tensor, C: Tensor, D: Tensor) -> Tensor:
    """The sequential 1D recurrence (``scan.py:152-166``), one step at a
    time in the inputs' dtype: the tests' reference."""
    dA = torch.exp(delta[..., None] * A)
    dBx = (delta * x)[..., None] * B[..., None, :]
    h = x.new_zeros((x.shape[0], x.shape[2], A.shape[-1]))
    hs = []
    for t in range(x.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        hs.append(h)
    return torch.einsum("blen,bln->ble", torch.stack(hs, 1), C) + D * x


def selective_scan_2d(x: Tensor, delta: Tensor, A: Tensor, B: Tensor, C: Tensor, D: Tensor,
                      variant: str = "separable", h0: Optional[Tensor] = None, return_state: bool = False):
    """2D selective scan over a ``[Bs, H, W, ·]`` grid (``scan.py:70-149``).

    - ``separable`` (the reference's deployed kernel): per row, the
      horizontal scan ``u = Ā·u_left + B̄x`` along W, then one vertical step
      ``h = Ā·h_up + u`` with the same Ā;
    - ``wavefront``: the reference's sequential recurrence
      ``h = Ā·(h_left + h_up) + B̄x``, row by row (it grows with the number
      of lattice paths and is for tiny grids only).

    Ā = exp(Δ·A), B̄x = Δ·x·B. Args: ``x``, ``delta`` ``[Bs, H, W, ED]``;
    ``A`` ``[ED, N]`` (negative); ``B``, ``C`` ``[Bs, H, W, N]``; ``D``
    ``[ED]``. The inputs are cast to fp32 whatever the policy, and the loop
    over the H rows keeps one ``[Bs, W, ED, N]`` state alive. Returns fp32
    ``y[Bs, H, W, ED] = Σ_n h·C + D·x``.

    ``h0[Bs, W, ED, N]`` is the vertical state entering the first row (None:
    zero); with ``return_state`` the result is ``(y, h)``, h the last row's
    state: what a band of rows sharded over ranks hands on
    (:func:`selective_scan_2d_sharded`).
    """
    if variant not in ("separable", "wavefront"):
        raise ValueError(f"unknown variant: {variant}")
    x, delta, A, B, C, D = (t.float() for t in (x, delta, A, B, C, D))
    bs, h, w, ed = x.shape
    h_row = x.new_zeros((bs, w, ed, A.shape[-1])) if h0 is None else h0.float()
    ys = []
    for r in range(h):
        d_r = delta[:, r]
        dA = torch.exp(d_r[..., None] * A)  # [Bs, W, ED, N]
        dBx = (d_r * x[:, r])[..., None] * B[:, r, :, None, :]
        if variant == "separable":
            h_row = dA * h_row + linear_scan(dA, dBx, dim=1)
        else:
            h_row = linear_scan(dA, dA * h_row + dBx, dim=1)
        ys.append(torch.einsum("bwen,bwn->bwe", h_row, C[:, r]))
    y = torch.stack(ys, 1) + D * x
    return (y, h_row) if return_state else y


# ---- scans sharded over an sp row ----------------------------------------------------------
#
# The recurrences are linear in the state that enters a block: a block that
# starts from h_in gives its result from zero plus the response to h_in,
# y_c = Σ_n C·(Πā)·h_in, which decays through the block alone. So each rank
# scans its block from zero, hands on its last state L and the block's
# decay T = Πā = exp(A·ΣΔ) (per channel and state, per column in 2D; a
# masked step has ā = 1), and ``parallel/mesh.sp_carry`` folds the pairs of
# the blocks before it into h_in, in one gather; the ranks stay concurrent.


def block_decay(delta_sum: Tensor, A: Tensor) -> Tensor:
    """Πā over a block from its ``ΣΔ[..., ED]``: ``exp(ΣΔ·A)`` ``[..., ED, N]``."""
    return torch.exp(delta_sum[..., None] * A.float())


def scan_carry_2d(delta: Tensor, A: Tensor, C: Tensor, h0: Tensor) -> Tensor:
    """The response of a separable 2D scan to the state ``h0[Bs, W, ED, N]``
    entering its first row: ``h = ā·h`` down the rows (u = 0: the horizontal
    scan adds nothing) and ``y = Σ_n h·C``, fp32 ``[Bs, H, W, ED]``. One
    ``[Bs, W, ED, N]`` state and ā a row, no row scan: a small part of the
    scan's own cost and memory."""
    A, h = A.float(), h0.float()
    ys = []
    for r in range(delta.shape[1]):
        h = torch.exp(delta[:, r].float()[..., None] * A) * h
        ys.append(torch.einsum("bwen,bwn->bwe", h, C[:, r].float()))
    return torch.stack(ys, 1)


def selective_scan_2d_sharded(x: Tensor, delta: Tensor, A: Tensor, B: Tensor, C: Tensor, D: Tensor,
                              rows: Seq) -> Tensor:
    """:func:`selective_scan_2d` (separable) of a grid whose rows are
    sharded over the active sp row: the arguments are this rank's band of
    whole rows, laid out as ``rows`` (the bands in rank order). The band is
    scanned from zero, the state entering it is folded from the bands above
    (:func:`~mhim_mil_torch.parallel.mesh.sp_carry`) and its response
    (:func:`scan_carry_2d`) added. Differentiable. Returns this band's y."""
    y, last = selective_scan_2d(x, delta, A, B, C, D, return_state=True)
    h_in = sp_carry(block_decay(delta.float().sum(1), A), last, rows)
    if rows.index == 0:
        return sp_join(y, h_in)  # nothing enters the first band; its graph still reaches the gather
    return y + scan_carry_2d(delta, A, C, h_in)


def selective_scan_1d_sharded(x: Tensor, delta: Tensor, A: Tensor, B: Tensor, C: Tensor, D: Tensor,
                              mask: Optional[Tensor], seq: Seq) -> Tensor:
    """:func:`selective_scan_1d` of a sequence sharded over the active sp
    row: the arguments are this rank's block, laid out as ``seq``, whose
    order is the scan's (a reversed ``Seq`` scans from the last rank to the
    first). The block is scanned from zero, the state entering it folded
    from the blocks before it (a block of padding passes it on unchanged)
    and its response added: the scan of ``x = 0`` from that state, which is
    ``Σ_n C·(Πā)·h_in`` and 0 at masked steps. Differentiable. Returns this
    block's y."""
    y, last = selective_scan_1d(x, delta, A, B, C, D, mask, return_state=True)
    dsum = delta.float() if mask is None else torch.where(mask.bool()[..., None], delta.float(), 0.0)
    h_in = sp_carry(block_decay(dsum.sum(1), A), last, seq)
    if seq.index == 0:
        return sp_join(y, h_in)
    return y + selective_scan_1d(torch.zeros_like(x), delta, A, B, C, D, mask, h0=h_in)
