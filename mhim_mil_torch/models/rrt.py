"""RRT-MIL, the region-partitioned re-embedding transformer with ABMIL
pooling (port of ``mhim_mil_tpu/models/rrt.py``).

Reference: modules/rrt.py: ``InnerAttention`` (:72-167, full attention
within a region with the EPEG depthwise convolution on its logits),
``RegionAttntion`` (:169-250), ``CrossRegionAttntion`` (:252-357),
``RRTEncoder`` (:604-688) and ``RRTMIL`` (:690-758).

The bag's bucket length fixes the square grid, the region size and the
region count; ragged bags are masked: the attention within a region
softmaxes over its valid tokens, the attention across regions skips empty
regions, and padded positions are zeroed after every block. One
``region_num`` drives both stages (the reference's CR-MSA keeps its
default 8 whatever ``--region_num`` says; the two agree at 8). The CR-MSA
layer has 8 heads whatever ``n_heads`` says, as in the JAX package. The
pool is the tanh (or, with ``da_gated``, gated) ABMIL pool on its plain
path, as in the JAX package, which builds it without its kernel.

Under a mesh that splits the instances (``parallel/mesh.py``, ``sp > 1``)
``feats`` and ``mask`` are this rank's block. The encoder's entry moves
each instance (:func:`~..parallel.mesh.sp_scatter`) to its place in the
region-major order of the whole bag's H² grid, where each sp rank holds a
contiguous run of whole regions (:func:`region_layout`); R-MSA with its
EPEG convolution, the LayerNorms and the residuals then run on whole
regions and need no halo. CR-MSA gathers only the ``[B, K, R, C]`` region
summaries over the row, attends across all R regions on every rank and
keeps its own regions' rows. The encoder's exit moves the tokens back to
the input's layout, and the ABMIL pool runs on the blocks.

The names are the reference's: ``feature.0``,
``online_encoder.layers.{i}`` (``norm``, ``attn.attn.qkv``, ``.proj``,
``.pe``), ``online_encoder.cr_msa`` (``norm``, ``attn.phi``,
``attn.attn.qkv``, ``.proj``), ``online_encoder.norm``,
``pool_fn.attention.attention.{0,2}`` and ``predictor``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import masked_softmax
from ..parallel.mesh import Seq, instance_blocks, seq_layout, sp_gather, sp_scatter
from .layers import (Dropout, FeatureEmbed, add_gated_attention, add_tanh_attention, dense, gated_attention,
                     tanh_attention)


def _region_grid(n: int, region_num: int):
    """``(H, region_size)``: H = ceil(sqrt(n)) rounded up to a multiple of
    ``region_num`` (``rrt.py:35-40``)."""
    h = int(math.ceil(math.sqrt(n)))
    h += (-h) % region_num
    return h, h // region_num


def region_partition(x: torch.Tensor, mask: torch.Tensor, region_num: int):
    """``x[B,N,C] → (x_r[B,R,P,C], mask_r[B,R,P], geometry)``, R = region_num²
    and P = region_size² (``rrt.py:43-54``): masked tokens zeroed, the bag
    padded to H² and cut into square regions of the row-major grid."""
    b, n, c = x.shape
    h, rs = _region_grid(n, region_num)
    pad = h * h - n
    x = F.pad(x * mask[..., None].to(x.dtype), (0, 0, 0, pad))
    m = torch.cat([mask, mask.new_zeros((b, pad))], dim=1)
    nr = h // rs
    x = x.reshape(b, nr, rs, nr, rs, c).permute(0, 1, 3, 2, 4, 5).reshape(b, nr * nr, rs * rs, c)
    m = m.reshape(b, nr, rs, nr, rs).permute(0, 1, 3, 2, 4).reshape(b, nr * nr, rs * rs)
    return x, m, (h, rs, pad)


def region_reverse(x_r: torch.Tensor, geo, n: int) -> torch.Tensor:
    """The inverse of :func:`region_partition`: ``[B,R,P,C] → [B,n,C]`` (``rrt.py:57-64``)."""
    b, _, _, c = x_r.shape
    h, rs, _ = geo
    nr = h // rs
    return x_r.reshape(b, nr, nr, rs, rs, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h * h, c)[:, :n]


class Regions(NamedTuple):
    """A rank's share of the region-major H² grid of a bag sharded over an
    sp row: ``seq`` counts the regions of each sp rank (a contiguous run of
    whole regions, possibly none), ``size`` is P, the tokens a region."""

    seq: Seq
    size: int

    @property
    def tokens(self) -> Seq:
        """The layout of the region-major tokens: P a region."""
        return Seq(tuple(c * self.size for c in self.seq.counts), self.seq.index)


def region_layout(n: int, region_num: int, sp: int, index: int) -> Regions:
    """The regions of a bag of ``n`` instances over ``sp`` ranks: the R =
    region_num² regions split as :func:`~..parallel.mesh.instance_blocks`
    splits instances (``R // sp`` each, one more on the first ``R % sp``
    ranks), so that a rank past R holds none and still takes part in every
    collective. Built directly, not through ``seq_layout``, which refuses
    an empty block."""
    h, rs = _region_grid(n, region_num)
    return Regions(Seq(instance_blocks((h // rs) ** 2, sp), index), rs * rs)


def region_index(i: torch.Tensor, n: int, region_num: int) -> torch.Tensor:
    """The region-major place ``r·P + p`` of row-major grid index ``i`` (the
    order of :func:`region_partition`)."""
    h, rs = _region_grid(n, region_num)
    nr = h // rs
    row, col = i // h, i % h
    return ((row // rs) * nr + col // rs) * (rs * rs) + (row % rs) * rs + col % rs


def row_major_index(q: torch.Tensor, n: int, region_num: int) -> torch.Tensor:
    """The row-major grid index of region-major place ``q`` (the inverse of
    :func:`region_index`)."""
    h, rs = _region_grid(n, region_num)
    nr = h // rs
    r, p = q // (rs * rs), q % (rs * rs)
    return ((r // nr) * rs + p // rs) * h + (r % nr) * rs + p % rs


def to_regions(x: torch.Tensor, mask: torch.Tensor, seq: Seq, region_num: int):
    """This rank's block ``x[B, n, C]`` (layout ``seq``) moved to the
    region-major order of the whole bag's grid: ``(x_r[B, R_l·P, C]``, zero
    past the bag, ``mask_r[B, R_l·P]``, the :class:`Regions`)``. The mask
    is read from the gathered ``[B, N]`` mask, not moved."""
    n = seq.total
    regions = region_layout(n, region_num, len(seq.counts), seq.index)
    out = regions.tokens
    dev = x.device
    pos = region_index(torch.arange(seq.offset, seq.offset + seq.local, device=dev), n, region_num)
    keep = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
    x_r = sp_scatter(x, pos.expand(x.shape[0], -1), keep, out.total, out)
    src = row_major_index(torch.arange(out.offset, out.offset + out.local, device=dev), n, region_num)
    full = sp_gather(mask, seq)
    m_r = (src < n)[None] & torch.gather(full, 1, src.clamp(max=n - 1).expand(x.shape[0], -1))
    return x_r, m_r, regions


def from_regions(x_r: torch.Tensor, regions: Regions, seq: Seq, region_num: int) -> torch.Tensor:
    """The inverse of :func:`to_regions`: this rank's block of the bag's
    tokens in the layout ``seq`` from its region-major block ``x_r``."""
    out = regions.tokens
    n = seq.total
    src = row_major_index(torch.arange(out.offset, out.offset + out.local, device=x_r.device), n, region_num)
    src = src.expand(x_r.shape[0], -1)
    return sp_scatter(x_r, src, src < n, n, seq)


def _region_drop(drop: nn.Module, t: torch.Tensor, training: bool, gen: Optional[torch.Generator],
                 rows: Optional[Tuple[int, Seq]]) -> torch.Tensor:
    """``drop`` on ``t[G, ...]``; given ``rows = (B, regions)`` (G = B times
    this rank's regions of the sp row's layout ``regions``), the draw is the
    one-process draw in ``[B, R, ...]`` shape, of which this rank keeps its
    regions (the flat ``B·R`` axis is not contiguous a rank when B > 1)."""
    if rows is None or not training:
        return drop(t, training, gen)
    b, seq = rows
    shape = tuple(t.shape[1:])
    return drop(t.reshape((b, seq.local) + shape), training, gen, seq).reshape(t.shape)


class InnerAttention(nn.Module):
    """Full multi-head attention over ``x[G,P,C]`` with ``mask[G,P]``
    (``rrt.py:67-113``): ``qkv``, with ``epeg`` the depthwise
    ``(epeg_k, 1)`` convolution ``pe`` over the query axis of the ``[G, H,
    P, Q]`` logits (one group per head, padded as XLA's SAME) added to
    them, the masked softmax, dropout on the map, ``proj``, dropout on the
    output, padded rows zeroed. ``rows``: see :func:`_region_drop`."""

    def __init__(self, dim: int = 512, num_heads: int = 8, epeg: bool = True, epeg_k: int = 15,
                 qkv_bias: bool = True, dropout: float = 0.1):
        super().__init__()
        self.num_heads, self.epeg_k = num_heads, epeg_k
        self.qkv = dense(dim, 3 * dim, qkv_bias)
        if epeg:
            self.pe = nn.Conv2d(num_heads, num_heads, (epeg_k, 1), groups=num_heads)
        self.proj = dense(dim, dim)
        self.attn_drop, self.proj_drop = Dropout(dropout), Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, rows: Optional[Tuple[int, Seq]] = None) -> torch.Tensor:
        g, p, c = x.shape
        h = self.num_heads
        dh = c // h
        q, k, v = (t.reshape(g, p, h, dh).transpose(1, 2) for t in self.qkv(x).chunk(3, dim=-1))
        attn = torch.einsum("ghpd,ghqd->ghpq", q * dh ** -0.5, k)
        if hasattr(self, "pe"):
            lo = (self.epeg_k - 1) // 2
            attn = attn + self.pe(F.pad(attn, (0, 0, lo, self.epeg_k - 1 - lo)))
        attn = _region_drop(self.attn_drop, masked_softmax(attn, mask[:, None, None, :]), training, gen, rows)
        out = torch.einsum("ghpq,ghqd->ghpd", attn, v).transpose(1, 2).reshape(g, p, c)
        out = _region_drop(self.proj_drop, self.proj(out), training, gen, rows)
        return torch.where(mask[..., None], out, 0)


class RegionAttention(nn.Module):
    """R-MSA: :class:`InnerAttention` within each region of the grid
    (``rrt.py:116-135``); given ``regions``, on this rank's whole regions of
    the region-major block ``x`` (:func:`to_regions`)."""

    def __init__(self, dim: int = 512, num_heads: int = 8, region_num: int = 8, epeg: bool = True,
                 epeg_k: int = 15, dropout: float = 0.1):
        super().__init__()
        self.region_num = region_num
        self.attn = InnerAttention(dim, num_heads, epeg, epeg_k, dropout=dropout)

    def forward(self, x, mask, training: bool = False, gen: Optional[torch.Generator] = None,
                regions: Optional[Regions] = None):
        b, n, c = x.shape
        if regions is not None:
            r, p = regions.seq.local, regions.size
            x_r = torch.where(mask[..., None], x, 0).reshape(b * r, p, c)
            out = self.attn(x_r, mask.reshape(b * r, p), training, gen, (b, regions.seq))
            return torch.where(mask[..., None], out.reshape(b, n, c), 0)
        x_r, m_r, geo = region_partition(x, mask, self.region_num)
        r = x_r.shape[1]
        out = self.attn(x_r.reshape(b * r, -1, c), m_r.reshape(b * r, -1), training, gen)
        out = region_reverse(out.reshape(b, r, -1, c), geo, n)
        return torch.where(mask[..., None], out, 0)


class CrossRegionAttention(nn.Module):
    """CR-MSA (``rrt.py:138-186``): each region compresses into ``crmsa_k``
    summaries by the dispatch bank ``phi [dim, crmsa_k]`` (the combine
    softmax over the region's valid tokens), attention runs across the
    regions that hold a token, and the result goes back to the tokens by
    the softmax over K times the min-max normalised logits (±inf fills,
    0 for an empty region). Given ``regions``, ``x`` is this rank's
    region-major block (:func:`to_regions`): each region's summaries are
    made where it lies, gathered over the sp row, every rank attends across
    all the regions and keeps its own regions' rows."""

    def __init__(self, dim: int = 512, num_heads: int = 8, region_num: int = 8, crmsa_k: int = 3,
                 dropout: float = 0.1):
        super().__init__()
        self.region_num, self.crmsa_k = region_num, crmsa_k
        self.phi = nn.Parameter(torch.empty(dim, crmsa_k))
        self.attn = InnerAttention(dim, num_heads, epeg=False, dropout=dropout)

    @torch.no_grad()
    def init_own(self, generator: torch.Generator):
        """``phi`` uniform in ±1/sqrt(dim), as the JAX package's
        ``variance_scaling(1/3, fan_in, uniform)`` draws it."""
        bound = 1.0 / math.sqrt(self.phi.shape[0])
        self.phi.uniform_(-bound, bound, generator=generator)

    def forward(self, x, mask, training: bool = False, gen: Optional[torch.Generator] = None,
                regions: Optional[Regions] = None):
        b, n, c = x.shape
        if regions is not None:
            r, p = regions.seq.local, regions.size
            x_r = torch.where(mask[..., None], x, 0).reshape(b, r, p, c)
            m_r = mask.reshape(b, r, p)
        else:
            x_r, m_r, geo = region_partition(x, mask, self.region_num)
            r = x_r.shape[1]
        k = self.crmsa_k
        logits = torch.einsum("brpc,ck->brkp", x_r, self.phi)  # [B,R,K,P]
        valid = m_r[:, :, None, :]
        combine = masked_softmax(logits, valid)
        dispatch = torch.softmax(logits, dim=2)  # over K
        lmin = torch.where(valid, logits, math.inf).amin(dim=-1, keepdim=True)
        lmax = torch.where(valid, logits, -math.inf).amax(dim=-1, keepdim=True)
        lmin = torch.where(torch.isfinite(lmin), lmin, 0.0)
        lmax = torch.where(torch.isfinite(lmax), lmax, 0.0)
        dispatch_mm = (logits - lmin) / (lmax - lmin + 1e-8)

        summaries = torch.einsum("brkp,brpc->bkrc", combine, x_r)
        region_valid = m_r.any(dim=-1)
        if regions is not None:  # every region's summaries on every rank of the row
            summaries = sp_gather(summaries, regions.seq, 2)
            region_valid = sp_gather(region_valid, regions.seq, 1)
        r_all = region_valid.shape[1]
        region_valid = region_valid[:, None, :].expand(b, k, r_all)
        attended = self.attn(summaries.reshape(b * k, r_all, c), region_valid.reshape(b * k, r_all),
                             training, gen).reshape(b, k, r_all, c)
        if regions is not None:
            attended = attended.narrow(2, regions.seq.offset, r)
        out = torch.einsum("bkrc,brkp->brpc", attended, dispatch_mm * dispatch)
        out = out.reshape(b, n, c) if regions is not None else region_reverse(out, geo, n)
        return torch.where(mask[..., None], out, 0)


class RRTLayer(nn.Module):
    """Pre-norm residual block ``x + attn(norm(x))`` around R-MSA or CR-MSA (``rrt.py:189-213``)."""

    def __init__(self, attn: nn.Module, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = attn

    def forward(self, x, mask, training: bool = False, gen: Optional[torch.Generator] = None,
                regions: Optional[Regions] = None):
        return x + self.attn(self.norm(x), mask, training, gen, regions)


class RRTEncoder(nn.Module):
    """``n_layers − 1`` R-MSA layers, one CR-MSA layer of ``crmsa_heads``
    heads, then LayerNorm (``rrt.py:216-243``). Given ``seq``, ``x`` and
    ``mask`` are this rank's block of a bag sharded over the sp row: the
    layers run on the region-major layout (:func:`to_regions`) and the
    result comes back in ``seq``'s."""

    def __init__(self, dim: int = 512, n_layers: int = 2, num_heads: int = 8, region_num: int = 8,
                 epeg_k: int = 15, crmsa_k: int = 3, crmsa_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            RRTLayer(RegionAttention(dim, num_heads, region_num, True, epeg_k, dropout), dim)
            for _ in range(n_layers - 1))
        self.cr_msa = RRTLayer(CrossRegionAttention(dim, crmsa_heads, region_num, crmsa_k, dropout), dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, mask, training: bool = False, gen: Optional[torch.Generator] = None,
                seq: Optional[Seq] = None):
        regions = None
        if seq is not None:
            region_num = self.cr_msa.attn.region_num
            x, mask, regions = to_regions(x, mask, seq, region_num)
        for layer in self.layers:
            x = layer(x, mask, training, gen, regions)
        x = self.norm(self.cr_msa(x, mask, training, gen, regions))
        return x if seq is None else from_regions(x, regions, seq, region_num)


class RRTMIL(nn.Module):
    """``rrtmil`` (``rrt.py:246-288``): embed → RRT re-embedding → ABMIL pool → head."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, inner_dim: int = 512, dropout: float = 0.25,
                 act: str = "relu", da_act: str = "relu", da_gated: bool = False, n_layers: int = 2,
                 n_heads: int = 8, region_num: int = 8, epeg_k: int = 15, crmsa_k: int = 3,
                 trans_dropout: float = 0.1, mil_bias: bool = True):
        super().__init__()
        self.feature = FeatureEmbed(input_dim, inner_dim, act, dropout, mil_bias)
        self.online_encoder = RRTEncoder(inner_dim, n_layers, n_heads, region_num, epeg_k, crmsa_k,
                                         dropout=trans_dropout)
        # the reference's pool_fn: its attention holds the ABMIL layers
        # (attention.{0,2}, or attention_a/_b/_c gated) of width 128 without
        # biases, on the plain path
        self.da_gated = da_gated
        self.pool_fn = nn.Module()
        self.pool_fn.attention = nn.Module()
        add = add_gated_attention if da_gated else add_tanh_attention
        add(self.pool_fn.attention, inner_dim, 128, 1, da_act, False, 0.0, False)
        self.predictor = dense(inner_dim, n_classes, mil_bias)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, return_attn: bool = False):
        """``{"logits", "bag_feat"[, "attn" [B,N]]}``; under sp (the module's
        docstring) ``attn`` is this block's."""
        mask = mask.bool()
        seq = seq_layout(feats.shape[1], feats.device)
        x = self.feature(feats, training, gen, seq)
        x = self.online_encoder(x, mask, training, gen, seq)
        pool = gated_attention if self.da_gated else tanh_attention
        pooled, attn = pool(self.pool_fn.attention, x, mask, training, gen, seq=seq)
        out = {"logits": self.predictor(pooled[:, 0]), "bag_feat": pooled[:, 0]}
        if return_attn:
            out["attn"] = attn[:, 0]
        return out
