"""The patch encoders of layer L0 (the port's copy of
``mhim_mil_tpu/preprocess/encoders.py``; reference
CLAM/models/builder.py:75-133).

Seven encoders in four architectures, written out in PyTorch because
neither torchvision, timm, open_clip nor diffusers is a dependency:

- :class:`ResNetTrunc` (``resnet50_trunc``, 1024-d; ``r18``, 256-d), in
  torchvision names: a ResNet cut after layer3 and mean-pooled;
- :class:`ViTEncoder` (``uni_v1``, ``gigap``, and CONCH's CoCa trunk), in
  timm names;
- :class:`CLIPVisualTower` (classic-layout ``conch_v1``), in open_clip names;
- :class:`SwinChief` (``chief``: Swin-T with CHIEF's ConvStem), in timm names;
- :class:`SDVAEEncoder` (``sd_vae``), in diffusers names.

Every module takes NCHW images normalised as :mod:`.extract` does and runs
in ``eval()``: BatchNorm on its running statistics. Because the modules
keep the upstream ``state_dict`` names, the file an upstream checkpoint
ships loads with ``load_state_dict``, and the JAX package's ``import_*``
functions read a port ``state_dict`` as they read the upstream one.
Convolutions and products are cuDNN's and cuBLAS's; attention is
``scaled_dot_product_attention`` (Swin's windows: the plain product, for
their relative bias and shifted-window mask). :func:`get_encoder` is the
registry.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.platform import resolve_device

# Per-encoder normalization (reference CLAM/utils/constants.py:1-44).
ENCODER_NORM = {
    "resnet50_trunc": "imagenet",
    "r18": "imagenet",
    "uni_v1": "imagenet",
    "conch_v1": "openai_clip",
    "chief": "imagenet",
    "gigap": "imagenet",
    "sd_vae": "uniform",
}

ENCODER_DIM = {
    "resnet50_trunc": 1024,
    "r18": 256,
    "uni_v1": 1024,
    "chief": 768,
    "conch_v1": 768,
}

# Reference-compatible checkpoint discovery (builder.py:30-72 uses
# UNI_CKPT_PATH etc.; the CNN encoders there pull timm pretrained weights —
# here they read a torch state_dict from these variables).
ENCODER_CKPT_ENV = {
    "resnet50_trunc": "RESNET50_CKPT_PATH",
    "r18": "R18_CKPT_PATH",
    "uni_v1": "UNI_CKPT_PATH",
    "conch_v1": "CONCH_CKPT_PATH",
    "chief": "CHIEF_CKPT_PATH",
    "gigap": "GIGAP_CKPT_PATH",
    "sd_vae": "SD_VAE_CKPT_PATH",
}


# ---- ResNet (torchvision names) ----------------------------------------------------


class Bottleneck(nn.Module):
    """torchvision ResNet v1.5 bottleneck: stride on the 3x3 conv."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), nn.BatchNorm2d(out_ch))
                           if stride != 1 or in_ch != out_ch else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(in_ch, planes, 1, stride, bias=False), nn.BatchNorm2d(planes))
                           if stride != 1 or in_ch != planes else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + identity)


class ResNetTrunc(nn.Module):
    """ResNet truncated after layer3, mean-pooled (reference
    timm_wrapper.py:4-23: ``features_only, out_indices=(3,)`` +
    AdaptiveAvgPool → for ResNet-50 a 1024-d patch feature). The max pool
    pads with −inf, as ``nn.MaxPool2d`` does."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6), block: str = "bottleneck"):
        super().__init__()
        blk = Bottleneck if block == "bottleneck" else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.depths = tuple(depths)
        in_ch = 64
        for li, (depth, planes) in enumerate(zip(self.depths, (64, 128, 256))):
            blocks = []
            for bi in range(depth):
                blocks.append(blk(in_ch, planes, 2 if (bi == 0 and li > 0) else 1))
                in_ch = planes * blk.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.out_dim = in_ch

    def forward(self, x):  # [B, 3, H, W] normalized
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for li in range(len(self.depths)):
            x = getattr(self, f"layer{li + 1}")(x)
        return x.mean(dim=(2, 3))  # [B, C]


# ---- ViT (timm names) ----------------------------------------------------------------


class _Attention(nn.Module):
    """timm ``Attention``: fused ``qkv``, ``proj``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4).unbind(0)
        y = F.scaled_dot_product_attention(q, k, v)
        return self.proj(y.transpose(1, 2).reshape(b, n, d))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # torch-exact erf GELU


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class _ViTBlock(nn.Module):
    """Pre-norm block (LayerNorm eps 1e-6) with optional LayerScale
    (``ls{1,2}.gamma``)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, layer_scale: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, heads)
        self.ls1 = _LayerScale(dim) if layer_scale else nn.Identity()
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(round(dim * mlp_ratio)))
        self.ls2 = _LayerScale(dim) if layer_scale else nn.Identity()

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


def resize_pos_grid(grid_pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """A square ``[1, side², d]`` pos-embed grid resized to ``[1, gh·gw, d]``
    as ``jax.image.resize(..., "bilinear")`` resizes it: antialiased, so a
    shrink averages over the scaled triangle filter, and an enlargement
    interpolates plainly (half-pixel centres, edges clamped)."""
    side, d = math.isqrt(grid_pos.shape[1]), grid_pos.shape[-1]
    if (gh, gw) == (side, side):
        return grid_pos
    g = grid_pos.reshape(1, side, side, d).permute(0, 3, 1, 2)
    g = F.interpolate(g, size=(gh, gw), mode="bilinear", align_corners=False, antialias=True)
    return g.permute(0, 2, 3, 1).reshape(1, gh * gw, d)


class ViTEncoder(nn.Module):
    """ViT feature encoder (timm ``vit_large_patch16_224`` family): patch
    conv embed → cls token + learned pos embed → pre-norm blocks with
    optional LayerScale (``init_values=1e-5`` is how the reference builds
    UNI, CLAM/models/builder.py:86-90) → final LN → cls feature.

    ``dynamic_img_size`` behavior: the ``grid`` × ``grid`` pos-embed grid is
    resized bilinearly when the input's grid differs (:func:`resize_pos_grid`).
    """

    def __init__(self, embed_dim: int = 1024, depth: int = 24, heads: int = 16, mlp_ratio: float = 4.0,
                 patch: int = 16, layer_scale: bool = True, grid: int = 14):
        super().__init__()
        d = embed_dim
        self.patch_embed = _PatchEmbed(d, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, d))
        self.blocks = nn.ModuleList(_ViTBlock(d, heads, mlp_ratio, layer_scale) for _ in range(depth))
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.out_dim = d

    def forward(self, x):  # [B, 3, H, W] normalized
        b = x.shape[0]
        x = self.patch_embed.proj(x)
        d, gh, gw = x.shape[1:]
        x = x.flatten(2).transpose(1, 2)
        cls_pos = self.pos_embed[:, :1]
        x = torch.cat([(self.cls_token + cls_pos).expand(b, 1, d), x + resize_pos_grid(self.pos_embed[:, 1:], gh, gw)],
                      dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 0]


# ---- CLIP visual tower (open_clip names) -------------------------------------------------


class _MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``), batch first, self-attention only."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(nn.init.xavier_uniform_(torch.empty(3 * dim, dim)))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.reshape(b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4).unbind(0)
        y = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(y.transpose(1, 2).reshape(b, n, d))


class _CLIPMlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, 4 * dim)
        self.c_proj = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class _CLIPBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = _MultiheadAttention(dim, heads)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _CLIPMlp(dim)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class CLIPVisualTower(nn.Module):
    """CLIP-style ViT visual tower (conch_v1: CLIP ViT-B/16, reference
    builder.py:91-97 uses CONCH's ``encode_image(proj_contrast=False,
    normalize=False)`` — the pooled image feature *before* the contrastive
    projection). open_clip architecture: biasless conv patch embed, class
    embedding + positional embedding, pre-transformer LN, resblocks with
    torch-MultiheadAttention parameterization, post-LN on the cls token.
    The positional embedding is not resized: the input's grid must be
    ``grid`` × ``grid``."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, heads: int = 12, patch: int = 16, grid: int = 14):
        super().__init__()
        d = embed_dim
        self.conv1 = nn.Conv2d(3, d, patch, patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.positional_embedding = nn.Parameter(torch.zeros(1 + grid * grid, d))
        self.ln_pre = nn.LayerNorm(d, eps=1e-5)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(_CLIPBlock(d, heads) for _ in range(depth))
        self.ln_post = nn.LayerNorm(d, eps=1e-5)
        self.out_dim = d

    def forward(self, x):  # [B, 3, H, W] normalized
        b = x.shape[0]
        x = self.conv1(x).flatten(2).transpose(1, 2)
        if x.shape[1] + 1 != self.positional_embedding.shape[0]:
            raise ValueError(f"CLIPVisualTower: {x.shape[1]} patches, the positional embedding has "
                             f"{self.positional_embedding.shape[0] - 1}")
        x = torch.cat([self.class_embedding.expand(b, 1, -1), x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return self.ln_post(x[:, 0])


# ---- CHIEF: Swin-T with ConvStem (timm names) ------------------------------------------


class ConvStem(nn.Module):
    """CHIEF's convolutional patch embed (reference CLAM/models/chief.py:5-43):
    two stride-2 conv+BN+ReLU stages (3→d/8→d/4) then a 1x1 conv to the embed
    dim, flattened to tokens and LayerNormed."""

    def __init__(self, embed_dim: int = 96):
        super().__init__()
        d = embed_dim
        self.proj = nn.Sequential(
            nn.Conv2d(3, d // 8, 3, 2, 1, bias=False), nn.BatchNorm2d(d // 8), nn.ReLU(),
            nn.Conv2d(d // 8, d // 4, 3, 2, 1, bias=False), nn.BatchNorm2d(d // 4), nn.ReLU(),
            nn.Conv2d(d // 4, d, 1),
        )
        self.norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x):  # [B, 3, H, W] -> [B, L, d]
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


def _rel_pos_index(w: int) -> np.ndarray:
    """Swin relative-position index over a w×w window (timm's
    ``relative_position_index``)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, w², w²]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]  # [w², w²]


def _shift_mask(res: int, w: int, shift: int) -> torch.Tensor:
    """The shifted-window mask ``[nW, w², w²]``: −100 between tokens of
    different pre-shift regions, 0 within one (timm's, not −inf)."""
    img = np.zeros((res, res), np.int64)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(res // w, w, res // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return torch.from_numpy(np.where(mw[:, :, None] != mw[:, None, :], -100.0, 0.0).astype(np.float32))


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", torch.from_numpy(_rel_pos_index(window).reshape(-1)),
                             persistent=False)

    def forward(self, x, mask=None):  # x: [nW*B, w², C]; mask [nW, w², w²]
        bn, w2, c = x.shape
        h = self.heads
        q, k, v = self.qkv(x).reshape(bn, w2, 3, h, c // h).permute(2, 0, 3, 1, 4).unbind(0)
        sim = (q * (c // h) ** -0.5) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[self.relative_position_index].reshape(w2, w2, h)
        sim = sim + bias.permute(2, 0, 1)
        if mask is not None:
            nw = mask.shape[0]
            sim = (sim.view(-1, nw, h, w2, w2) + mask[None, :, None]).view(-1, h, w2, w2)
        y = sim.softmax(-1) @ v
        return self.proj(y.transpose(1, 2).reshape(bn, w2, c))


class _SwinMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, res: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = _WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _SwinMlp(dim, int(dim * mlp_ratio))
        self.register_buffer("attn_mask", _shift_mask(res, window, shift) if shift else None, persistent=False)

    def forward(self, x, hw):  # x: [B, L, C]
        H, W = hw
        b, L, c = x.shape
        w = self.window
        y = self.norm1(x).view(b, H, W, c)
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), (1, 2))
        y = y.view(b, H // w, w, W // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)
        y = self.attn(y, self.attn_mask)
        y = y.view(b, H // w, W // w, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, H, W, c)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), (1, 2))
        x = x + y.reshape(b, L, c)
        return x + self.mlp(self.norm2(x))


class _PatchMerging(nn.Module):
    def __init__(self, dim: int):  # input dim
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, hw):  # [B, L, C] -> [B, L/4, 2C]
        H, W = hw
        b, _, c = x.shape
        x = x.view(b, H, W, c)
        # timm's concat order over (row, col): x0=(0,0), x1=(1,0), x2=(0,1), x3=(1,1)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.view(b, -1, 4 * c)))


class SwinChief(nn.Module):
    """CHIEF patch encoder: Swin-T (window 7, depths 2/2/6/2) with the
    ConvStem patch embed, mean-pooled to a 768-d feature (reference
    builder.py:101-110: timm ``swin_tiny_patch4_window7_224`` with
    ``embed_layer=ConvStem`` and ``head=Identity``). Input must be 224×224
    (the stem asserts the same upstream, chief.py:37-38).

    The layout is old timm's (``layers.{i}.downsample`` at the end of stage
    i), as CHIEF's checkpoint has it; :func:`get_encoder` also reads new
    timm's (at the start of stage i+1). The relative-position index and the
    shifted-window masks are buffers outside the ``state_dict``."""

    img_size = 224

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 heads: Sequence[int] = (3, 6, 12, 24), window: int = 7):
        super().__init__()
        self.patch_embed = ConvStem(embed_dim)
        self.layers = nn.ModuleList()
        dim, res = embed_dim, self.img_size // 4
        for si, (depth, h) in enumerate(zip(depths, heads)):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                _SwinBlock(dim, h, window, 0 if (bi % 2 == 0 or res <= window) else window // 2, res)
                for bi in range(depth))
            if si < len(depths) - 1:
                stage.downsample = _PatchMerging(dim)
                dim, res = dim * 2, res // 2
            self.layers.append(stage)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.out_dim = dim

    def forward(self, x):  # [B, 3, 224, 224] normalized
        if tuple(x.shape[-2:]) != (self.img_size, self.img_size):
            raise ValueError(f"SwinChief takes {self.img_size}x{self.img_size} patches, got {tuple(x.shape[-2:])}")
        x = self.patch_embed(x)
        h = w = self.img_size // 4
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x, (h, w))
            if hasattr(stage, "downsample"):
                x = stage.downsample(x, (h, w))
                h, w = h // 2, w // 2
        return self.norm(x).mean(1)  # timm avg pool over tokens


# ---- SD VAE encoder (diffusers names) ------------------------------------------------


class _VAEResnetBlock(nn.Module):
    """diffusers ResnetBlock2D (GroupNorm32 → SiLU → conv3) × 2 with a 1x1
    shortcut on channel change."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class _VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, c: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):  # [B, C, H, W]
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        y = F.scaled_dot_product_attention(self.to_q(y)[:, None], self.to_k(y)[:, None], self.to_v(y)[:, None])[:, 0]
        return x + self.to_out[0](y).transpose(1, 2).reshape(b, c, h, w)


class _Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x):  # diffusers Downsample2D: asymmetric (0, 1) pad + stride-2 conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class SDVAEEncoder(nn.Module):
    """Stable-Diffusion VAE encoder (``sd_vae``): diffusers AutoencoderKL's
    encoder + quant_conv → scaled latents (reference
    CLAM/models/vae_warpper.py:1-14 wraps ``AutoencoderKL("sd-vae-ft-ema")``
    and returns ``encode(x).latent_dist.sample() * 0.18215``). The default
    geometry is sd-vae-ft-ema's: channels 128/256/512/512, two layers a block.

    Divergence (documented, as in the JAX package): this returns the
    distribution MEAN × 0.18215 — the reference *samples*. Output is
    flattened ``[B, 4·(H/8)·(W/8)]`` in ``[C, H, W]`` order, so the store
    keeps its ``[N, D]`` contract."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512), layers_per_block: int = 2,
                 latent_channels: int = 4):
        super().__init__()
        chans = tuple(block_out_channels)
        enc = nn.Module()
        enc.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        cin = chans[0]
        for i, ch in enumerate(chans):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(layers_per_block):
                blk.resnets.append(_VAEResnetBlock(cin, ch))
                cin = ch
            if i < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([_Downsample(ch)])
            enc.down_blocks.append(blk)
        enc.mid_block = nn.Module()
        enc.mid_block.resnets = nn.ModuleList([_VAEResnetBlock(cin, cin), _VAEResnetBlock(cin, cin)])
        enc.mid_block.attentions = nn.ModuleList([_VAEAttention(cin)])
        enc.conv_norm_out = nn.GroupNorm(32, cin, eps=1e-6)
        enc.conv_out = nn.Conv2d(cin, 2 * latent_channels, 3, padding=1)
        self.encoder = enc
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.latent_channels = latent_channels

    def forward(self, x):  # [B, 3, H, W] in [-1, 1]-style normalization
        e = self.encoder
        x = e.conv_in(x)
        for blk in e.down_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
        x = e.mid_block.resnets[1](e.mid_block.attentions[0](e.mid_block.resnets[0](x)))
        moments = self.quant_conv(e.conv_out(F.silu(e.conv_norm_out(x))))
        return (moments[:, : self.latent_channels] * 0.18215).flatten(1)


# ---- random weights ------------------------------------------------------------------


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BatchNorm statistic of ``module`` from
    ``generator``, module by module: conv and linear weights
    N(0, 1/fan_in), their biases N(0, 0.02²), norm scales 1 + N(0, 0.1²) and
    shifts N(0, 0.1²), BatchNorm means N(0, 0.1²) and variances U(0.5, 1.5),
    LayerScale gammas U(0.5, 1), embeddings and bias tables N(0, 0.02²).
    Deterministic for a seed on any device (drawn on the CPU)."""
    def draw(shape, kind):
        if kind == "normal":
            return torch.randn(shape, generator=generator)
        return torch.rand(shape, generator=generator)

    norms = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)
    for mod in module.modules():
        for pname, p in mod.named_parameters(recurse=False):
            if isinstance(mod, norms):
                val = 1 + 0.1 * draw(p.shape, "normal") if pname == "weight" else 0.1 * draw(p.shape, "normal")
            elif isinstance(mod, _LayerScale):
                val = 0.5 + 0.5 * draw(p.shape, "uniform")
            elif p.ndim >= 2 and pname in ("weight", "in_proj_weight"):
                val = draw(p.shape, "normal") * p[0].numel() ** -0.5
            else:
                val = 0.02 * draw(p.shape, "normal")
            p.copy_(val)
        if isinstance(mod, nn.BatchNorm2d):
            mod.running_mean.copy_(0.1 * draw(mod.running_mean.shape, "normal"))
            mod.running_var.copy_(0.5 + draw(mod.running_var.shape, "uniform"))
    return module


# ---- state_dict loading ----------------------------------------------------------------


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def _strip(sd: Mapping[str, Any], prefix: str = "model.") -> Dict[str, Any]:
    return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}


def load_encoder_state(module: nn.Module, sd: Mapping[str, Any]) -> nn.Module:
    """Load the keys of ``module``'s ``state_dict`` from ``sd`` (tensors or
    arrays), ignoring any other key as the JAX importers do (a classifier
    head, a decoder, a contrastive projection). A missing key raises
    ``KeyError``, a wrong shape ``RuntimeError``; BatchNorm's
    ``num_batches_tracked``, which eval never reads, may be absent."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} keys of {type(module).__name__}, "
                       f"e.g. {missing[:3]}")
    module.load_state_dict({k: _tensor(sd[k]) for k in own if k in sd}, strict=False)
    return module


def _vit_from_sd(sd: Dict[str, Any]) -> Tuple[ViTEncoder, Dict[str, Any]]:
    """The timm ViT of a state dict (heads follow timm's head_dim = 64)."""
    sd = _strip(sd)
    dim = int(_tensor(sd["pos_embed"]).shape[-1])
    depth = sum(1 for k in sd if k.endswith(".norm1.weight"))
    patch = int(_tensor(sd["patch_embed.proj.weight"]).shape[-1])
    grid = math.isqrt(int(_tensor(sd["pos_embed"]).shape[1]) - 1)
    hidden = int(_tensor(sd["blocks.0.mlp.fc1.weight"]).shape[0]) if depth else 4 * dim
    has_ls = any(k.endswith("ls1.gamma") for k in sd)
    return ViTEncoder(dim, depth, max(dim // 64, 1), hidden / dim, patch, has_ls, grid), sd


def _swin_from_sd(sd: Dict[str, Any]) -> Tuple[SwinChief, Dict[str, Any]]:
    """CHIEF's Swin of a state dict in either timm layout, its geometry
    inferred (Swin-T defaults: 96, 2/2/6/2, 3/6/12/24, window 7)."""
    sd = _strip(sd)
    # Only the old layout (downsample at stage end) has layers.0.downsample:
    # in the new one layers.{i}.downsample belongs to the merge after stage i-1.
    old_merge_layout = "layers.0.downsample.reduction.weight" in sd
    out = {}
    for k, v in sd.items():
        if k.endswith(("relative_position_index", "attn_mask")):
            continue  # buffers of old timm; the module makes its own
        if not old_merge_layout and k.startswith("layers.") and ".downsample." in k:
            si = int(k.split(".")[1])
            k = k.replace(f"layers.{si}.downsample.", f"layers.{si - 1}.downsample.", 1)
        out[k] = v
    embed = int(_tensor(out["patch_embed.proj.6.weight"]).shape[0])
    depths, heads = [], []
    while f"layers.{len(depths)}.blocks.0.norm1.weight" in out:
        si, bi = len(depths), 0
        while f"layers.{si}.blocks.{bi}.norm1.weight" in out:
            bi += 1
        depths.append(bi)
        heads.append(int(_tensor(out[f"layers.{si}.blocks.0.attn.relative_position_bias_table"]).shape[1]))
    table = int(_tensor(out["layers.0.blocks.0.attn.relative_position_bias_table"]).shape[0])
    window = int(round((table ** 0.5 + 1) / 2))
    return SwinChief(embed, tuple(depths), tuple(heads), window), out


def _clip_from_sd(sd: Dict[str, Any]) -> Tuple[CLIPVisualTower, Dict[str, Any]]:
    """The classic open_clip visual tower of a state dict whose ``visual.``
    prefix, if any, is already stripped."""
    bad = [k for k in sd if k.startswith("attn_pool")]
    if bad:
        raise NotImplementedError(
            f"CoCa attentional-pooler checkpoints not supported (keys {bad[:2]}…); "
            "supported subset: classic CLIP visual towers and timm-trunk ViTs"
        )
    dim = int(_tensor(sd["class_embedding"]).reshape(-1).shape[0])
    depth = sum(1 for k in sd if k.endswith(".ln_1.weight"))
    patch = int(_tensor(sd["conv1.weight"]).shape[-1])
    grid = math.isqrt(int(_tensor(sd["positional_embedding"]).shape[0]) - 1)
    sd = dict(sd, class_embedding=_tensor(sd["class_embedding"]).reshape(-1))
    return CLIPVisualTower(dim, depth, max(dim // 64, 1), patch, grid), sd


_VAE_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def _vae_from_sd(sd: Dict[str, Any]) -> Tuple[SDVAEEncoder, Dict[str, Any]]:
    """diffusers AutoencoderKL's encoder of a state dict (``encoder.*`` and
    ``quant_conv``; both attention namings: modern ``to_q/to_out.0`` and
    legacy ``query/proj_attn``, whose 1x1-conv weights are squeezed)."""
    ab = "encoder.mid_block.attentions.0."
    out = {}
    for k, v in sd.items():
        if k.startswith(ab):
            head, _, tail = k[len(ab):].rpartition(".")
            if head in _VAE_LEGACY_ATTN:
                k = f"{ab}{_VAE_LEGACY_ATTN[head]}.{tail}"
                v = _tensor(v)
                v = v[:, :, 0, 0] if v.ndim == 4 else v
        out[k] = v
    chans = []
    while f"encoder.down_blocks.{len(chans)}.resnets.0.conv1.weight" in out:
        chans.append(int(_tensor(out[f"encoder.down_blocks.{len(chans)}.resnets.0.conv1.weight"]).shape[0]))
    layers = sum(1 for k in out if k.startswith("encoder.down_blocks.0.resnets.") and k.endswith(".conv1.weight"))
    latent = int(_tensor(out["quant_conv.weight"]).shape[0]) // 2
    return SDVAEEncoder(tuple(chans), layers, latent), out


def _resnet_for(name: str) -> ResNetTrunc:
    return ResNetTrunc((3, 4, 6), "bottleneck") if name == "resnet50_trunc" else ResNetTrunc((2, 2, 2), "basic")


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def _unwrap(sd):
    return sd.get("state_dict", sd) if isinstance(sd, dict) else sd


def _needs_ckpt(name: str, what: str = "its downloaded checkpoint", extra: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"encoder '{name}' needs {what}: set {ENCODER_CKPT_ENV[name]} or pass ckpt_path"
        f"{extra or ' (reference builder.py:30-72 asserts the same).'}"
    )


def get_encoder(name: str, ckpt_path: Optional[str] = None, device=None) -> Tuple[nn.Module, str]:
    """The encoder ``name`` as an ``eval()`` module on ``device`` (CUDA unless
    the CPU is asked for) mapping ``images[B, 3, P, P]`` normalized to
    ``[B, D]``, and the normalization key for :mod:`.extract` (reference
    ``get_encoder``, CLAM/models/builder.py:75-133).

    ``ckpt_path`` (or the reference-style env var, ENCODER_CKPT_ENV) points
    at a torch state_dict ``.pt``/``.pth`` in the upstream names; the
    geometry of the foundation encoders is read from it. The CNN encoders
    fall back to random weights from ``torch.Generator`` seed 0 with a loud
    warning; the others raise ``NotImplementedError`` without a checkpoint,
    as does an unknown name."""
    device = resolve_device(device)
    ckpt_path = ckpt_path or os.environ.get(ENCODER_CKPT_ENV.get(name, ""), "")

    if name in ("resnet50_trunc", "r18"):
        module = _resnet_for(name)
        if ckpt_path:
            load_encoder_state(module, _strip(_unwrap(_torch_load(ckpt_path))))
        else:
            warnings.warn(
                f"{name}: no checkpoint (set {ENCODER_CKPT_ENV[name]} or pass "
                "ckpt_path) — using RANDOM weights; features are only useful "
                "for pipeline tests."
            )
            random_init_(module, torch.Generator().manual_seed(0))
    elif name in ("uni_v1", "gigap"):
        # timm-format ViT checkpoints: UNI = ViT-L/16 w/ layerscale 1e-5
        # (reference builder.py:86-91), prov-gigapath = ViT-giant/16
        # (builder.py:113-124).
        if not ckpt_path:
            raise _needs_ckpt(name)
        module, sd = _vit_from_sd(_unwrap(_torch_load(ckpt_path)))
        load_encoder_state(module, sd)
    elif name == "chief":
        # Swin-T + ConvStem → 768-d (reference builder.py:101-110)
        if not ckpt_path:
            raise _needs_ckpt(name)
        sd = _torch_load(ckpt_path)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]  # reference unwraps td['model'], builder.py:110
        module, sd = _swin_from_sd(sd)
        load_encoder_state(module, sd)
    elif name == "conch_v1":
        # CLIP ViT-B/16 visual tower, pooled pre-projection feature
        # (reference builder.py:91-97)
        if not ckpt_path:
            raise _needs_ckpt(name)
        sd = _unwrap(_torch_load(ckpt_path))
        if any(k.startswith(("visual.trunk.", "trunk.")) for k in sd):
            # CoCa-style CONCH: timm ViT trunk
            module, sd = _vit_from_sd({k.split("trunk.", 1)[1]: v for k, v in sd.items() if "trunk." in k})
        else:
            if any(k.startswith("visual.") for k in sd):
                # A full classic-CLIP checkpoint carries its text tower at the
                # TOP level (transformer.resblocks.*, ln_final.*, the 77-token
                # positional_embedding): keep strictly the visual tower.
                sd = {k: v for k, v in sd.items() if k.startswith("visual.")}
            else:
                sd = {k: v for k, v in sd.items()
                      if not k.startswith(("text.", "logit_scale", "token_emb"))}
            module, sd = _clip_from_sd(_strip(sd, "visual."))
        load_encoder_state(module, sd)
    elif name == "sd_vae":
        # SD VAE latents (reference vae_warpper.py wraps AutoencoderKL)
        if not ckpt_path:
            raise _needs_ckpt(name, "the AutoencoderKL checkpoint",
                              " (a diffusers state_dict .pt; the reference pulls stabilityai/sd-vae-ft-ema).")
        module, sd = _vae_from_sd(_unwrap(_torch_load(ckpt_path)))
        load_encoder_state(module, sd)
    else:
        raise NotImplementedError(f"model {name} not implemented")
    return module.to(device).eval(), ENCODER_NORM[name]
