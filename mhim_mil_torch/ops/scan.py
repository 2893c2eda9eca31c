"""Linear recurrences for the 2D Mamba (port of ``mhim_mil_tpu/ops/scan.py``).

:func:`linear_scan` is the first-order recurrence ``h[t] = a[t]·h[t-1] + x[t]``
as a log-step doubling scan; :func:`selective_scan_2d` the 2D selective scan
over a ``[Bs, H, W, ·]`` grid, streamed row by row so that the
``[Bs, H, W, ED, N]`` lattice is never built. These are the plain versions:
the training path differentiates them, and ``ops/scan2d.py`` holds the K5
kernel of the separable variant against them. The 1D scan
(``selective_scan_1d``) is not ported yet.
"""

from __future__ import annotations

import torch

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


def selective_scan_2d(x: Tensor, delta: Tensor, A: Tensor, B: Tensor, C: Tensor, D: Tensor,
                      variant: str = "separable") -> Tensor:
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
    """
    if variant not in ("separable", "wavefront"):
        raise ValueError(f"unknown variant: {variant}")
    x, delta, A, B, C, D = (t.float() for t in (x, delta, A, B, C, D))
    bs, h, w, ed = x.shape
    h_row = x.new_zeros((bs, w, ed, A.shape[-1]))
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
    return torch.stack(ys, 1) + D * x
