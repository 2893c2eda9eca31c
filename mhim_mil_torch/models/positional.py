"""Positional encodings PPEG, PEG and SINCOS (port of
``mhim_mil_tpu/models/positional.py``).

The bag is rasterised row-major into the static ``ceil(sqrt(N))²`` grid with
zeros at masked and filler positions, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import Seq, sp_halo


def _square_grid(x: torch.Tensor, mask: torch.Tensor):
    """``x[B,N,C]`` laid row-major on the ``[B,C,hw,hw]`` square grid
    (``hw = ceil(sqrt(N))``), zero at masked and filler cells
    (``positional.py:25-34``)."""
    b, n, c = x.shape
    hw = int(math.ceil(math.sqrt(n)))
    grid = F.pad(x * mask[..., None].to(x.dtype), (0, 0, 0, hw * hw - n))
    return grid.view(b, hw, hw, c).permute(0, 3, 1, 2)


def _grid_conv_sharded(x: torch.Tensor, mask: torch.Tensor, seq: Seq, k: int, conv) -> torch.Tensor:
    """``_from_grid(conv(_square_grid(x, mask)))`` for a bag sharded over
    the active sp row: ``x[B,n,C]`` is this rank's block (layout ``seq``)
    of the ``hw × hw`` grid of the whole bag (``hw = ceil(sqrt(N))``). The
    block's rows of the grid, with the ``k // 2`` rows above and below read
    from the neighbouring blocks (:func:`~..parallel.mesh.sp_halo`; block
    edges need not fall on rows), go through ``conv``, which pads only the
    columns. Masked tokens keep ``x``."""
    b, n, c = x.shape
    hw, p = int(math.ceil(math.sqrt(seq.total))), k // 2

    def window(off: int, cnt: int):
        """Tokens before and after a block that its rows and their halo rows take."""
        r0, r1 = off // hw, (off + cnt - 1) // hw
        return off - (r0 - p) * hw, (r1 + p + 1) * hw - off - cnt

    wins = [window(off, cnt) for off, cnt in zip(seq.offsets(), seq.counts)]
    left, right = max(w[0] for w in wins), max(w[1] for w in wins)
    lo, ro = window(seq.offset, n)
    win = sp_halo(x * mask[..., None].to(x.dtype), seq, left, right)[:, left - lo:left + n + ro]
    grid = win.reshape(b, (lo + n + ro) // hw, hw, c).permute(0, 3, 1, 2)
    out = conv(grid).permute(0, 2, 3, 1).reshape(b, -1, c)  # from the block's first row
    start = lo - p * hw
    return torch.where(mask[..., None], out[:, start:start + n], x)


def _from_grid(out: torch.Tensor, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The grid's cells back in bag order; masked tokens keep ``x``."""
    b, n, c = x.shape
    out = out.permute(0, 2, 3, 1).reshape(b, -1, c)[:, :n]
    return torch.where(mask[..., None], out, x)


class PPEG(nn.Module):
    """Pyramid positional-encoding generator: depthwise convolutions of size
    k, 5 and 3 on the square token grid, plus identity
    (reference: modules/emb_position.py:85-121).

    The three branches and the identity are linear in the same input, so they
    are folded into one k×k depthwise kernel (the smaller kernels centred by
    zero padding, the identity a centre delta) and run as one convolution.
    Masked tokens keep their input. Given ``seq``, ``x`` is this rank's
    block of a bag sharded over the active sp row, on the whole bag's grid.
    """

    def __init__(self, dim: int = 512, k: int = 7, use_bias: bool = True):
        super().__init__()
        self.k = k
        self.proj = nn.Conv2d(dim, dim, k, padding=k // 2, groups=dim, bias=use_bias)
        self.proj1 = nn.Conv2d(dim, dim, 5, padding=2, groups=dim, bias=use_bias)
        self.proj2 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim, bias=use_bias)

    def folded(self):
        """The folded ``[D,1,k,k]`` kernel and the summed bias (or None)."""
        k = self.k
        p5, p3 = (k - 5) // 2, (k - 3) // 2
        kern = (
            self.proj.weight
            + F.pad(self.proj1.weight, (p5, p5, p5, p5))
            + F.pad(self.proj2.weight, (p3, p3, p3, p3))
        )
        delta = torch.zeros_like(kern[:1])
        delta[..., k // 2, k // 2] = 1.0
        bias = None
        if self.proj.bias is not None:
            bias = self.proj.bias + self.proj1.bias + self.proj2.bias
        return kern + delta, bias

    def forward(self, x: torch.Tensor, mask: torch.Tensor, seq: Optional[Seq] = None) -> torch.Tensor:
        kern, bias = self.folded()
        if seq is not None:
            return _grid_conv_sharded(x, mask, seq, self.k, lambda g: F.conv2d(
                g, kern, bias, padding=(0, self.k // 2), groups=x.shape[-1]))
        grid = _square_grid(x, mask)
        out = F.conv2d(grid, kern, bias, padding=self.k // 2, groups=x.shape[-1])
        return _from_grid(out, x, mask)


class PEG(nn.Module):
    """One depthwise k×k convolution on the square token grid plus identity
    (``positional.py:103-123``; reference modules/rrt.py:602-624). Masked
    tokens keep their input. Given ``seq``, ``x`` is this rank's block of a
    bag sharded over the active sp row, on the whole bag's grid, as in
    :class:`PPEG`."""

    def __init__(self, dim: int = 512, k: int = 7, use_bias: bool = True):
        super().__init__()
        self.k = k
        self.proj = nn.Conv2d(dim, dim, k, padding=k // 2, groups=dim, bias=use_bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, seq: Optional[Seq] = None) -> torch.Tensor:
        if seq is not None:
            p = self.k // 2

            def conv(g):  # the rows' convolution plus the identity of their centre rows
                out = F.conv2d(g, self.proj.weight, self.proj.bias, padding=(0, p), groups=x.shape[-1])
                return g.narrow(2, p, out.shape[2]) + out

            return _grid_conv_sharded(x, mask, seq, self.k, conv)
        grid = _square_grid(x, mask)
        return _from_grid(grid + self.proj(grid), x, mask)


def sincos_2d(coords: torch.Tensor, dim: int) -> torch.Tensor:
    """The 2D sin-cos embedding ``[..., dim]`` of integer grid coordinates
    ``coords[..., 2]`` (x, y) in fp32: ``sin(x·ω), cos(x·ω), sin(y·ω),
    cos(y·ω)`` with ``ω_i = 10000^(-i/(dim/4))`` (``positional.py:126-142``;
    reference modules/emb_position.py:9-56)."""
    quarter = dim // 2 // 2
    omega = 1.0 / 10000.0 ** (torch.arange(quarter, dtype=torch.float32, device=coords.device) / quarter)
    cx = coords[..., 0].float()[..., None] * omega
    cy = coords[..., 1].float()[..., None] * omega
    return torch.cat([torch.sin(cx), torch.cos(cx), torch.sin(cy), torch.cos(cy)], dim=-1)


class SINCOS(nn.Module):
    """Adds the 2D sin-cos embedding of ``coords`` to the valid tokens
    (``positional.py:145-160``). Without coords the bag lies on the
    row-major square grid of side ``ceil(sqrt(N))``. No parameters."""

    def __init__(self, dim: int = 512):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor, mask: torch.Tensor, coords: Optional[torch.Tensor] = None,
                seq: Optional[Seq] = None) -> torch.Tensor:
        """``seq``: ``x`` (and ``coords``) are this rank's block of a bag
        sharded over the active sp row; the grid is the whole bag's."""
        if coords is None:
            n = x.shape[1]
            lo, total = (0, n) if seq is None else (seq.offset, seq.total)
            hw = int(math.ceil(math.sqrt(total)))
            idx = torch.arange(lo, lo + n, device=x.device)
            coords = torch.stack([idx % hw, idx // hw], dim=-1)[None].expand(x.shape[0], n, 2)
        emb = sincos_2d(coords, self.dim).to(x.dtype)
        return torch.where(mask[..., None], x + emb, x)


def make_pos(pos: str, dim: int, k: int = 7, use_bias: bool = True) -> Optional[nn.Module]:
    """The positional module that sits between two TransLayers: ``ppeg``,
    ``sincos``, ``peg``, or None for ``none``."""
    if pos == "ppeg":
        return PPEG(dim, k, use_bias)
    if pos == "peg":
        return PEG(dim, k, use_bias)
    if pos == "sincos":
        return SINCOS(dim)
    if pos in ("none", None):
        return None
    raise ValueError(f"unknown pos {pos!r}: ppeg, sincos, peg or none")
