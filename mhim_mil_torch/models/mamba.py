"""The Mamba MIL aggregators ``2dmamba`` and ``mambamil`` (port of
``mhim_mil_tpu/models/mamba.py``).

``2dmamba``: embed → rasterize the bag onto a grid → ResidualMamba stack
(RMSNorm, the 2D ``MambaBlock``, residual) → LayerNorm → masked attention
pooling over the valid cells → classifier. ``mambamil``: the same stack
over the instance sequence with the masked 1D scan, in three variants
(simple, srmamba, bimamba), then the masked attention pool. Names follow
the reference's modules (``mamba_simple.py``, ``mambamil_2d.py``,
``srmamba.py``, ``bimamba.py``), as listed in
``utils/weights.mamba2d_state_from_flax`` and ``mambamil_state_from_flax``.

On no-grad paths (not training, ``use_flash``) the 2D scan is K5
(``ops/scan2d.selective_scan_2d_fused``); training takes the plain scan of
``ops/scan.py``. The 1D scan has no kernel (JAX runs it in XLA): both ways
it is ``ops/scan.selective_scan_1d``.

Under the bf16 policy the 2D scan's fp32 result is cast back to the compute
type on both paths, as JAX's kernel path does; JAX's plain path lets it
promote the rest of the block to fp32. The linear position embedding is
added in the compute type; JAX promotes it to fp32. The 1D block follows
JAX's promotion: its fp32 scan output makes the gate, ``out_proj``, the
residual and everything after the first layer fp32, as flax's layers
promote an fp32 input against bf16 weights.

Under a mesh that splits the instances (``parallel/mesh.py``, ``sp > 1``)
``feats``, ``mask`` and ``coords`` are this rank's block, and both models
compute what one process computes on the whole bag:

- ``mambamil``: the blocks stay in rank order. The causal convolution reads
  the 3 tokens before the block (``sp_halo``); the scan takes the state the
  blocks before it hand on (``ops/scan.selective_scan_1d_sharded``, the
  parallel form of ``sp_carry``). bimamba's flipped branch is the reverse
  scan of the locally flipped block (``Seq.reversed``: the carry runs from
  the last rank to the first, the halo reads the 3 tokens after the
  block); srmamba's branch moves the tokens to their blocks of the
  stride-permuted sequence and back (``sp_scatter``).
- ``2dmamba``: rank k holds a band of whole grid rows
  (``instance_blocks(H, sp)``). Each instance goes to the band that holds
  its cell (:func:`rasterize_band`; a cell that two valid instances clip to
  takes the one of the larger index in the bag, on any rank). The
  convolution reads the 3 cells before the band in raster order, and the 2D
  scan carries each column's state across the bands (``sp_carry``; K5
  twice on the bands below the first on no-grad paths, the plain scan under
  grad). Without ``coords`` the row-major grid is the whole bag's
  (⌈√N⌉ columns of the global length, the instances at their global
  index).

Either way the attention pool's softmax and sum run over the sp row, the
logits are the whole bag's on every rank, and ``attn`` is this block's
(``mambamil``) or the whole grid's, gathered (``2dmamba``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import masked_softmax
from ..ops.scan import (selective_scan_1d, selective_scan_1d_sharded, selective_scan_2d,
                        selective_scan_2d_sharded)
from ..ops.scan2d import selective_scan_2d_fused, selective_scan_2d_fused_sharded
from ..parallel.mesh import Seq, seq_layout, sp_gather, sp_halo, sp_max, sp_scatter, sp_sum
from .layers import Dropout, dense, promoted_layer_norm, promoted_linear

Tensor = torch.Tensor


class RMSNorm(nn.Module):
    """``x·rsqrt(mean(x²) + eps)·weight`` over the last axis; unit weight."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: Tensor) -> Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * self.weight

    @torch.no_grad()
    def init_own(self, generator: torch.Generator):
        self.weight.fill_(1.0)


class CausalConv1d(nn.Conv1d):
    """Depthwise causal convolution over the raster order, on ``[B, L, C]``:
    the flax ``nn.Conv`` with padding (k−1, 0) and ``feature_group_count=C``
    (flax kernel ``[k, 1, C]`` ↔ torch weight ``[C, 1, k]``), initialised as
    flax's default, LeCun-normal truncated at two deviations, zero bias."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__(channels, channels, kernel_size, groups=channels)

    def forward(self, x: Tensor, seq: Optional[Seq] = None) -> Tensor:
        """In the wider of the input's and the weights' dtypes, as flax's
        ``Conv``. ``seq``: ``x`` is this rank's block of a sequence sharded
        over the active sp row, laid out so; the k−1 tokens before it come
        from the blocks before (``sp_halo``, zeros before the first)."""
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        k = self.kernel_size[0]
        if seq is None:
            x = F.pad(x.transpose(1, 2).to(dtype), (k - 1, 0))
        else:
            x = sp_halo(x.to(dtype), seq, k - 1, 0).transpose(1, 2)
        return F.conv1d(x, self.weight.to(dtype), self.bias.to(dtype), groups=self.groups).transpose(1, 2)

    @torch.no_grad()
    def init_own(self, generator: torch.Generator):
        std = (1.0 / self.kernel_size[0]) ** 0.5 / 0.87962566103423978  # fan_in = k·1
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        self.bias.zero_()


class DtProj(nn.Linear):
    """``dt_proj``: weight U(±dt_rank^−½), bias the softplus inverse of a
    log-uniform Δ in [1e-3, 0.1] floored at 1e-4 (``mamba.py:202-220``,
    reference ``mamba_simple.py:176-191``)."""

    @torch.no_grad()
    def init_own(self, generator: torch.Generator):
        std = self.in_features ** -0.5
        self.weight.uniform_(-std, std, generator=generator)
        u = torch.rand(self.bias.shape, generator=generator)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(u * (hi - lo) + lo).clamp_min(1e-4)
        self.bias.copy_(dt + torch.log(-torch.expm1(-dt)))


class MambaBlock(nn.Module):
    """The Mamba mixer (``mamba.py:90-271``): in_proj → (x, z); causal
    depthwise conv of width 4 over the raster order; SiLU; x_proj → (Δ, B,
    C) with their RMSNorms; Δ = softplus(dt_proj); the selective scan (2D
    on a ``[B, H, W, d_model]`` grid, masked 1D on a ``[B, L, d_model]``
    sequence); gate by SiLU(z); out_proj. ED = 2·d_model, dt_rank =
    ⌈d_model/16⌉, ``A_log`` is log(1..N) per channel and ``D`` one.

    ``variant`` (1D only): ``simple`` is the single branch; ``srmamba`` and
    ``bimamba`` add a second branch with its own parameter set (``conv1d_b``,
    ``x_proj_b``, ``dt_layernorm_b``, ``B_layernorm_b``, ``C_layernorm_b``,
    ``dt_proj_b``, ``A_b_log``, ``D_b``) over the stride-permuted
    (:func:`sr_permute`, stride ``sr_rate``) or the flipped sequence; the
    two branches sum before the gate (``mamba.py:116-168, 251-268``)."""

    def __init__(self, d_model: int = 128, d_state: int = 16, use_flash: bool = True,
                 variant: str = "simple", sr_rate: int = 10):
        super().__init__()
        if variant not in ("simple", "srmamba", "bimamba"):
            raise ValueError(f"unknown mamba variant {variant!r}")
        ed = 2 * d_model
        self.ed, self.d_state = ed, d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.use_flash, self.variant, self.sr_rate = use_flash, variant, sr_rate
        self.in_proj = dense(d_model, 2 * ed, use_bias=False)
        self.branches = ("", "_b") if variant != "simple" else ("",)  # the parameter names' suffixes
        for sfx in self.branches:  # registered in the JAX module's order, branch after branch
            setattr(self, f"conv1d{sfx}", CausalConv1d(ed, 4))
            setattr(self, f"x_proj{sfx}", dense(ed, self.dt_rank + 2 * d_state, use_bias=False))
            setattr(self, f"dt_layernorm{sfx}", RMSNorm(self.dt_rank))
            setattr(self, f"B_layernorm{sfx}", RMSNorm(d_state))
            setattr(self, f"C_layernorm{sfx}", RMSNorm(d_state))
            setattr(self, f"dt_proj{sfx}", DtProj(self.dt_rank, ed))
            setattr(self, f"A{sfx}_log", nn.Parameter(torch.empty(ed, d_state)))
            setattr(self, f"D{sfx}", nn.Parameter(torch.empty(ed)))
        self.out_proj = dense(ed, d_model, use_bias=False)

    @torch.no_grad()
    def init_own(self, generator: torch.Generator):
        for sfx in self.branches:
            a_log, d = getattr(self, f"A{sfx}_log"), getattr(self, f"D{sfx}")
            a_log.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32)).expand_as(a_log))
            d.fill_(1.0)

    def _ssm_inputs(self, xin: Tensor, sfx: str = "", seq: Optional[Seq] = None):
        """The conv → SiLU → x_proj → RMSNorms → softplus(dt_proj) chain of
        one branch: ``(x, Δ, A, B, C, D)`` for the scan, each layer in the
        wider of its input's and its weights' dtypes. ``seq``: the layout of
        the sharded sequence (of cells, in raster order, for a grid band)."""
        shape = xin.shape
        conv = getattr(self, f"conv1d{sfx}")(xin.reshape(shape[0], -1, self.ed), seq)
        xin = F.silu(conv.reshape(*shape[:-1], self.ed))
        dbc = promoted_linear(getattr(self, f"x_proj{sfx}"), xin)
        dt, b_ssm, c_ssm = dbc.split([self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt = getattr(self, f"dt_layernorm{sfx}")(dt)
        b_ssm = getattr(self, f"B_layernorm{sfx}")(b_ssm)
        c_ssm = getattr(self, f"C_layernorm{sfx}")(c_ssm)
        delta = F.softplus(promoted_linear(getattr(self, f"dt_proj{sfx}"), dt))
        return xin, delta, getattr(self, f"A{sfx}_log"), b_ssm, c_ssm, getattr(self, f"D{sfx}")

    def _scan_1d(self, sfx: str, xin_raw: Tensor, mask: Optional[Tensor], seq: Optional[Seq]) -> Tensor:
        """One branch's inputs and its masked 1D scan, sharded under ``seq``."""
        xin, delta, a_log, b_ssm, c_ssm, d = self._ssm_inputs(xin_raw, sfx, seq)
        if seq is None:
            return selective_scan_1d(xin, delta, -torch.exp(a_log), b_ssm, c_ssm, d, mask=mask)
        return selective_scan_1d_sharded(xin, delta, -torch.exp(a_log), b_ssm, c_ssm, d, mask, seq)

    def _branch_1d(self, xin_raw: Tensor, mask: Optional[Tensor], seq: Optional[Seq] = None) -> Tensor:
        """The second branch (``mamba.py:116-168``) on its permuted sequence
        (``seq``: this rank's block of it, laid out so); masked rows are
        zeroed before its conv, since the flip or the permutation puts
        padding upstream of valid tokens."""
        if mask is not None:
            xin_raw = torch.where(mask[..., None], xin_raw, 0)
        return self._scan_1d("_b", xin_raw, mask, seq)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None, training: bool = False,
                seq: Optional[Seq] = None) -> Tensor:
        """``x[B, H, W, d_model]`` (2D; ``mask`` unused: the grid scans its pad
        cells, as in the reference) or ``x[B, L, d_model]`` with ``mask[B, L]``
        (1D) → the same shape. ``seq``: under an sp mesh, the layout of the
        grid's rows over the row's ranks (2D; ``x`` this rank's band) or of
        the sharded sequence (1D; ``x`` this rank's block)."""
        if x.dim() == 4:
            cells = None if seq is None else Seq(tuple(r * x.shape[2] for r in seq.counts), seq.index)
            xin, z = self.in_proj(x).chunk(2, dim=-1)
            xin, delta, a_log, b_ssm, c_ssm, d = self._ssm_inputs(xin, "", cells)
            if self.use_flash and not training:
                y = (selective_scan_2d_fused(xin, delta, a_log, b_ssm, c_ssm, d) if seq is None else
                     selective_scan_2d_fused_sharded(xin, delta, a_log, b_ssm, c_ssm, d, seq))
            elif seq is None:
                y = selective_scan_2d(xin, delta, -torch.exp(a_log), b_ssm, c_ssm, d)
            else:
                y = selective_scan_2d_sharded(xin, delta, -torch.exp(a_log), b_ssm, c_ssm, d, seq)
            return self.out_proj(y.to(xin.dtype) * F.silu(z))
        if mask is not None:
            mask = mask.bool()
        xin_raw, z = promoted_linear(self.in_proj, x).chunk(2, dim=-1)
        y = self._scan_1d("", xin_raw, mask, seq)
        if self.variant == "bimamba":
            mb = None if mask is None else mask.flip(1)
            y = y + self._branch_1d(xin_raw.flip(1), mb, None if seq is None else seq.reversed()).flip(1)
        elif self.variant == "srmamba" and seq is None:
            xb, mb = sr_permute(xin_raw, mask, self.sr_rate)
            y = y + sr_unpermute(self._branch_1d(xb, mb), self.sr_rate, x.shape[1])
        elif self.variant == "srmamba":
            xb, mb, pseq = sr_permute_sharded(xin_raw, mask, self.sr_rate, seq)
            y = y + sr_unpermute_sharded(self._branch_1d(xb, mb, pseq), self.sr_rate, seq, pseq)
        return promoted_linear(self.out_proj, y * F.silu(z))


class ResidualMamba(nn.Module):
    """RMSNorm → MambaBlock → + residual (``mamba.py:274-292``)."""

    def __init__(self, d_model: int = 128, d_state: int = 16, use_flash: bool = True,
                 variant: str = "simple", sr_rate: int = 10):
        super().__init__()
        self.norm = RMSNorm(d_model)
        self.mixer = MambaBlock(d_model, d_state, use_flash, variant, sr_rate)

    def forward(self, x: Tensor, training: bool = False, mask: Optional[Tensor] = None,
                seq: Optional[Seq] = None) -> Tensor:
        return self.mixer(self.norm(x), mask, training, seq) + x


def sr_permute(x: Tensor, mask: Optional[Tensor], rate: int):
    """SRMamba's re-embedding (``mamba.py:60-74``, reference srmamba.py:33-46):
    zero-pad L to a multiple of ``rate`` and reorder ``(k w) → (w k)`` with
    w = ``rate``. Returns ``(x[B, k·rate, C], mask[B, k·rate])``; the
    padded slots are masked."""
    b, l, c = x.shape
    k = -(-l // rate)
    if mask is None:
        mask = torch.ones((b, l), dtype=torch.bool, device=x.device)
    if k * rate > l:
        x = F.pad(x, (0, 0, 0, k * rate - l))
        mask = F.pad(mask, (0, k * rate - l))
    xp = x.reshape(b, k, rate, c).transpose(1, 2).reshape(b, k * rate, c)
    mp = mask.reshape(b, k, rate).transpose(1, 2).reshape(b, k * rate)
    return xp, mp


def sr_unpermute(y: Tensor, rate: int, length: int) -> Tensor:
    """The inverse of :func:`sr_permute`, cut to ``length`` (``mamba.py:77-82``)."""
    b, lp, c = y.shape
    k = lp // rate
    return y.reshape(b, rate, k, c).transpose(1, 2).reshape(b, lp, c)[:, :length]


def sr_permute_sharded(x: Tensor, mask: Optional[Tensor], rate: int, seq: Seq):
    """:func:`sr_permute` of a sequence sharded over the active sp row,
    ``x[B, n, C]`` and ``mask`` this rank's block (layout ``seq``): each
    token moves to its place in the permuted sequence of ⌈L/rate⌉·rate
    tokens (``sp_scatter``), laid out by ``Seq.split``. Returns this rank's
    block of it, its mask (the padded slots masked) and its layout."""
    b, n, _ = x.shape
    k = -(-seq.total // rate)
    pseq = Seq.split(k * rate, len(seq.counts), seq.index)
    t = torch.arange(seq.offset, seq.offset + n, device=x.device).expand(b, n)
    xp = sp_scatter(x, (t % rate) * k + t // rate, torch.ones_like(t, dtype=torch.bool), k * rate, pseq)
    full = torch.ones((b, seq.total), dtype=torch.bool, device=x.device) if mask is None else sp_gather(mask, seq)
    mp = F.pad(full, (0, k * rate - seq.total)).reshape(b, k, rate).transpose(1, 2).reshape(b, k * rate)
    return xp, mp[:, pseq.cols], pseq


def sr_unpermute_sharded(y: Tensor, rate: int, seq: Seq, pseq: Seq) -> Tensor:
    """The inverse of :func:`sr_permute_sharded`: this rank's block (layout
    ``pseq``) of the permuted sequence back to its block of the original
    one (layout ``seq``), the padded slots dropped."""
    k = pseq.total // rate
    p = torch.arange(pseq.offset, pseq.offset + pseq.local, device=y.device).expand(y.shape[0], -1)
    t = (p % k) * rate + p // k
    return sp_scatter(y, t, t < seq.total, seq.total, seq)


def rasterize_grid(feats: Tensor, coords: Tensor, mask: Tensor, h: int, w: int, pad_token: Tensor):
    """Scatter a bag ``feats[B, N, C]`` onto a ``[B, h, w, C]`` grid filled
    with ``pad_token`` (``mamba.py:40-57``). ``coords[..., 0]`` is the
    column and ``coords[..., 1]`` the row, both clipped into the grid;
    invalid instances go to a trash cell at index h·w, which is dropped.
    Two valid instances on one cell leave either (as in JAX). Returns
    ``(grid, grid_mask[B, h, w])``."""
    b, _, c = feats.shape
    coords = coords.long()
    col = coords[..., 0].clamp(0, w - 1)
    row = coords[..., 1].clamp(0, h - 1)
    idx = torch.where(mask, row * w + col, h * w)
    grid = pad_token.to(feats.dtype).expand(b, h * w + 1, c).clone()
    grid.scatter_(1, idx[..., None].expand(-1, -1, c), feats)
    gmask = torch.zeros((b, h * w + 1), dtype=torch.bool, device=feats.device).scatter_(1, idx, mask)
    return grid[:, : h * w].reshape(b, h, w, c), gmask[:, : h * w].reshape(b, h, w)


def rasterize_band(feats: Tensor, coords: Tensor, mask: Tensor, h: int, w: int, pad_token: Tensor, seq: Seq):
    """:func:`rasterize_grid` of a bag sharded over the active sp row:
    ``feats``, ``coords`` and ``mask`` are this rank's block of instances
    (layout ``seq``), and this rank gets its band of whole grid rows
    (``Seq.split(h, sp)``, at least one row a rank). Each valid instance
    moves to the band that holds its cell (``sp_scatter``). A cell that
    several valid instances clip to takes the one with the largest index in
    the bag (their max over the row, ``sp_max``), wherever it lies, so the
    move never sums two instances; one process leaves either. Returns
    ``(band[B, rows, w, C], band_mask[B, rows, w], rows)``, ``rows`` the
    layout of the grid's rows over the sp row."""
    b, n, c = feats.shape
    if h < len(seq.counts):
        raise ValueError(f"a grid of {h} rows over sp={len(seq.counts)} ranks: every rank needs a row")
    rows = Seq.split(h, len(seq.counts), seq.index)
    cells = Seq(tuple(r * w for r in rows.counts), seq.index)
    coords = coords.long()
    col = coords[..., 0].clamp(0, w - 1)
    row = coords[..., 1].clamp(0, h - 1)
    idx = torch.where(mask, row * w + col, h * w)
    gid = torch.arange(seq.offset, seq.offset + n, device=feats.device).expand(b, n)
    winner = torch.full((b, h * w + 1), -1, dtype=torch.int64, device=feats.device)
    winner = sp_max(winner.scatter_reduce_(1, idx, torch.where(mask, gid, -1), "amax"))
    keep = mask & (winner.gather(1, idx) == gid)
    band = sp_scatter(feats, idx, keep, h * w, cells)
    bmask = winner[:, cells.cols] >= 0
    grid = torch.where(bmask[..., None], band, pad_token.to(band.dtype))
    return grid.reshape(b, rows.local, w, c), bmask.reshape(b, rows.local, w), rows


def rowmajor_coords(n: int, w: int, device=None, start: int = 0) -> Tensor:
    """``(column, row)`` of the ``n`` cells from ``start`` of a row-major grid ``w`` wide."""
    idx = torch.arange(start, start + n, device=device)
    return torch.stack([idx % w, idx // w], dim=-1)


class MambaMIL2D(nn.Module):
    """``2dmamba`` (``mamba.py:295-363``). ``forward(feats, mask, coords=None)``:
    with ``coords[B, N, 2]`` (column, row) the bag goes onto the dataset's
    ``max_h × max_w`` grid; without, onto a row-major grid ⌈√N⌉ columns
    wide. Returns ``{"logits", "bag_feat"}`` and ``"attn"`` over the grid's
    cells with ``return_attn``."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, dim: int = 128, n_layers: int = 1,
                 d_state: int = 16, dropout: float = 0.25, max_w: int = 64, max_h: int = 64,
                 pad_token_mode: str = "trainable", pos_emb_type: str = "none",
                 pos_emb_dropout: float = 0.0, use_flash: bool = True):
        super().__init__()
        if pad_token_mode not in ("trainable", "zero") or pos_emb_type not in ("none", "linear"):
            raise ValueError(f"pad_token_mode={pad_token_mode!r}, pos_emb_type={pos_emb_type!r}")
        self.dim, self.max_w, self.max_h = dim, max_w, max_h
        self._fc1 = dense(input_dim, dim)
        self.drop = Dropout(dropout)
        self.pos_embs = dense(2, dim) if pos_emb_type == "linear" else None
        self.pos_drop = Dropout(pos_emb_dropout)
        # the trainable pad cell, U[0, 1) as flax's ``uniform(1.0)``; zeros otherwise
        self.pad_token = nn.Parameter(torch.empty(dim)) if pad_token_mode == "trainable" else None
        self.layers = nn.ModuleList(ResidualMamba(dim, d_state, use_flash) for _ in range(n_layers))
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attention = nn.Sequential(dense(dim, 128), nn.Tanh(), dense(128, 1))
        self.classifier = dense(dim, n_classes)

    @torch.no_grad()
    def init_own(self, generator: torch.Generator):
        if self.pad_token is not None:
            self.pad_token.uniform_(0.0, 1.0, generator=generator)

    def forward(self, feats: Tensor, mask: Tensor, coords: Optional[Tensor] = None, training: bool = False,
                return_attn: bool = False, gen: Optional[torch.Generator] = None):
        b, nseq, _ = feats.shape
        mask = mask.bool()
        seq = seq_layout(nseq, feats.device)
        x = self.drop(F.gelu(self._fc1(feats), approximate="tanh"), training, gen, seq)
        if self.pos_embs is not None and coords is not None:
            x = x + self.pos_drop(self.pos_embs(coords.to(x.dtype)), training, gen, seq)
        if coords is None:
            n = nseq if seq is None else seq.total
            w = math.ceil(math.sqrt(n))
            h = math.ceil(n / w)
            coords = rowmajor_coords(nseq, w, feats.device, 0 if seq is None else seq.offset).expand(b, nseq, 2)
        else:
            h, w = self.max_h, self.max_w
        pad = self.pad_token if self.pad_token is not None else x.new_zeros(self.dim)
        if seq is None:
            (grid, gmask), rows = rasterize_grid(x, coords, mask, h, w, pad), None
        else:
            grid, gmask, rows = rasterize_band(x, coords, mask, h, w, pad, seq)
        for layer in self.layers:
            grid = layer(grid, training, seq=rows)
        cells = grid.shape[1] * w
        hseq = self.norm(grid.reshape(b, cells, self.dim))
        mseq = gmask.reshape(b, cells)
        attn = masked_softmax(self.attention(hseq)[..., 0], mseq, sharded=rows is not None)
        bag = torch.einsum("bl,bld->bd", attn, torch.where(mseq[..., None], hseq, 0))
        if rows is not None:
            bag = sp_sum(bag)
        out = {"logits": self.classifier(bag), "bag_feat": bag}
        if return_attn:
            out["attn"] = attn if rows is None else sp_gather(attn, Seq(tuple(r * w for r in rows.counts),
                                                                        rows.index))
        return out


class MambaMIL1D(nn.Module):
    """``mambamil`` (``mamba.py:366-405``): ``_fc1`` → GELU → dropout →
    ResidualMamba stack over the instance sequence (the masked 1D scan;
    ``variant`` simple, srmamba or bimamba, SRMamba's stride ``sr_rate``)
    → LayerNorm → the masked tanh attention pool (``attention.0`` /
    ``attention.2``, JAX's ``attn_0`` / ``attn_1``) → ``classifier``.
    Returns ``{"logits", "bag_feat"}`` and ``"attn" [B, N]`` with
    ``return_attn``. Under bf16 the layers after the first scan run in fp32,
    as in JAX (see the module's docstring)."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, dim: int = 128, n_layers: int = 1,
                 d_state: int = 16, dropout: float = 0.25, variant: str = "simple", sr_rate: int = 10):
        super().__init__()
        self.variant = variant
        self._fc1 = dense(input_dim, dim)
        self.drop = Dropout(dropout)
        self.layers = nn.ModuleList(ResidualMamba(dim, d_state, False, variant, sr_rate) for _ in range(n_layers))
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attention = nn.Sequential(dense(dim, 128), nn.Tanh(), dense(128, 1))
        self.classifier = dense(dim, n_classes)

    def forward(self, feats: Tensor, mask: Tensor, training: bool = False, return_attn: bool = False,
                gen: Optional[torch.Generator] = None):
        mask = mask.bool()
        seq = seq_layout(feats.shape[1], feats.device)
        x = self.drop(F.gelu(self._fc1(feats), approximate="tanh"), training, gen, seq)
        for layer in self.layers:
            x = layer(x, training, mask, seq)
        x = promoted_layer_norm(self.norm, x)
        a = promoted_linear(self.attention[2], torch.tanh(promoted_linear(self.attention[0], x)))
        attn = masked_softmax(a[..., 0], mask, sharded=seq is not None)
        bag = torch.einsum("bl,bld->bd", attn, torch.where(mask[..., None], x, 0))
        if seq is not None:
            bag = sp_sum(bag)
        out = {"logits": promoted_linear(self.classifier, bag), "bag_feat": bag}
        if return_attn:
            out["attn"] = attn
        return out
