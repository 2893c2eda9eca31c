"""The 2D Mamba MIL aggregator ``2dmamba`` (port of ``mhim_mil_tpu/models/mamba.py``).

Embed → rasterize the bag onto a grid → ResidualMamba stack (RMSNorm, the
2D ``MambaBlock``, residual) → LayerNorm → masked attention pooling over the
valid cells → classifier. Names follow the reference's modules
(``mamba_simple.py``, ``mambamil_2d.py``), as listed in
``utils/weights.mamba2d_state_from_flax``.

On no-grad paths (not training, ``use_flash``) the 2D scan is K5
(``ops/scan2d.selective_scan_2d_fused``); training takes the plain scan of
``ops/scan.py``. The 1D scan and its models (``mambamil``: simple, srmamba,
bimamba) are not ported yet.

Under the bf16 policy the scan's fp32 result is cast back to the compute
type on both paths, as JAX's kernel path does; JAX's plain path lets it
promote the rest of the block to fp32. The linear position embedding is
added in the compute type; JAX promotes it to fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import masked_softmax
from ..ops.scan import selective_scan_2d
from ..ops.scan2d import selective_scan_2d_fused
from .layers import Dropout, dense

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

    def forward(self, x: Tensor) -> Tensor:
        x = F.pad(x.transpose(1, 2), (self.kernel_size[0] - 1, 0))
        return F.conv1d(x, self.weight, self.bias, groups=self.groups).transpose(1, 2)

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
    """The 2D Mamba mixer (``mamba.py:90-271``): in_proj → (x, z); causal
    depthwise conv of width 4 over the raster order; SiLU; x_proj → (Δ, B,
    C) with their RMSNorms; Δ = softplus(dt_proj); the 2D selective scan;
    gate by SiLU(z); out_proj. ED = 2·d_model, dt_rank = ⌈d_model/16⌉,
    ``A_log`` is log(1..N) per channel and ``D`` one."""

    def __init__(self, d_model: int = 128, d_state: int = 16, use_flash: bool = True):
        super().__init__()
        ed = 2 * d_model
        self.ed, self.d_state = ed, d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.use_flash = use_flash
        self.in_proj = dense(d_model, 2 * ed, use_bias=False)
        self.conv1d = CausalConv1d(ed, 4)
        self.x_proj = dense(ed, self.dt_rank + 2 * d_state, use_bias=False)
        self.dt_layernorm = RMSNorm(self.dt_rank)
        self.B_layernorm = RMSNorm(d_state)
        self.C_layernorm = RMSNorm(d_state)
        self.dt_proj = DtProj(self.dt_rank, ed)
        self.A_log = nn.Parameter(torch.empty(ed, d_state))
        self.D = nn.Parameter(torch.empty(ed))
        self.out_proj = dense(ed, d_model, use_bias=False)

    @torch.no_grad()
    def init_own(self, generator: torch.Generator):
        self.A_log.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32)).expand_as(self.A_log))
        self.D.fill_(1.0)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        """``x[B, H, W, d_model]`` → the same shape. The 1D branch is not ported."""
        if x.dim() != 4:
            raise NotImplementedError("only the 2D MambaBlock is ported; the 1D scan is not")
        bs, hh, ww, _ = x.shape
        xin, z = self.in_proj(x).chunk(2, dim=-1)
        xin = F.silu(self.conv1d(xin.reshape(bs, hh * ww, self.ed)).reshape(bs, hh, ww, self.ed))
        dt, b_ssm, c_ssm = self.x_proj(xin).split([self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt, b_ssm, c_ssm = self.dt_layernorm(dt), self.B_layernorm(b_ssm), self.C_layernorm(c_ssm)
        delta = F.softplus(self.dt_proj(dt))
        if self.use_flash and not training:
            y = selective_scan_2d_fused(xin, delta, self.A_log, b_ssm, c_ssm, self.D)
        else:
            y = selective_scan_2d(xin, delta, -torch.exp(self.A_log), b_ssm, c_ssm, self.D)
        return self.out_proj(y.to(xin.dtype) * F.silu(z))


class ResidualMamba(nn.Module):
    """RMSNorm → MambaBlock → + residual (``mamba.py:274-292``)."""

    def __init__(self, d_model: int = 128, d_state: int = 16, use_flash: bool = True):
        super().__init__()
        self.norm = RMSNorm(d_model)
        self.mixer = MambaBlock(d_model, d_state, use_flash)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        return self.mixer(self.norm(x), training) + x


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


def rowmajor_coords(n: int, w: int, device=None) -> Tensor:
    """``(column, row)`` of the first ``n`` cells of a row-major grid ``w`` wide."""
    idx = torch.arange(n, device=device)
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
        x = self.drop(F.gelu(self._fc1(feats), approximate="tanh"), training, gen)
        if self.pos_embs is not None and coords is not None:
            x = x + self.pos_drop(self.pos_embs(coords.to(x.dtype)), training, gen)
        if coords is None:
            w = math.ceil(math.sqrt(nseq))
            h = math.ceil(nseq / w)
            coords = rowmajor_coords(nseq, w, feats.device).expand(b, nseq, 2)
        else:
            h, w = self.max_h, self.max_w
        pad = self.pad_token if self.pad_token is not None else x.new_zeros(self.dim)
        grid, gmask = rasterize_grid(x, coords, mask, h, w, pad)
        for layer in self.layers:
            grid = layer(grid, training)
        hseq = self.norm(grid.reshape(b, h * w, self.dim))
        mseq = gmask.reshape(b, h * w)
        attn = masked_softmax(self.attention(hseq)[..., 0], mseq)
        bag = torch.einsum("bl,bld->bd", attn, torch.where(mseq[..., None], hseq, 0))
        out = {"logits": self.classifier(bag), "bag_feat": bag}
        if return_attn:
            out["attn"] = attn
        return out
