"""Shared building blocks (port of ``mhim_mil_tpu/models/layers.py``).

Initialisation follows the reference's ``initialize_weights``: xavier-normal
linear and convolution weights, zero biases, unit LayerNorm. Weights come
from an explicit ``torch.Generator``, and so does every dropout mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.abmil_pool import fused_abmil_pool, merge_blocks
from ..ops.masked import masked_softmax
from ..parallel.mesh import Seq, rand_rows, sp_sum


def dense(in_features: int, out_features: int, use_bias: bool = True) -> nn.Linear:
    """A linear layer; :func:`init_weights` gives it xavier-normal weights and a zero bias."""
    return nn.Linear(in_features, out_features, bias=use_bias)


def promoted_linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)`` in the wider of the two dtypes, as flax's ``Dense`` promotes
    an fp32 input against bf16 weights under the bf16 policy."""
    dtype = torch.promote_types(x.dtype, lin.weight.dtype)
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def promoted_layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``ln(x)`` in the wider of the two dtypes, as flax's ``LayerNorm``."""
    dtype = torch.promote_types(x.dtype, ln.weight.dtype)
    bias = None if ln.bias is None else ln.bias.to(dtype)
    return F.layer_norm(x.to(dtype), ln.normalized_shape, ln.weight.to(dtype), bias, ln.eps)


def get_act(name: str) -> nn.Module:
    """Activation by name. ``gelu`` is the tanh approximation, as flax's ``nn.gelu``."""
    name = (name or "none").lower()
    return {
        "relu": nn.ReLU,
        "gelu": lambda: nn.GELU(approximate="tanh"),
        "tanh": nn.Tanh,
        "silu": nn.SiLU,
        "none": nn.Identity,
    }[name]()


class Dropout(nn.Module):
    """Dropout as flax applies it: keep each entry with probability ``1 - p``
    and scale the kept ones by ``1/(1-p)``. The keep-mask comes from the
    ``torch.Generator`` the caller passes (the train step owns it), never from
    torch's global generator; it is drawn only when ``training``. Under an
    active mesh it is drawn at the global batch's shape and this rank keeps
    its rows (``rand_rows``), as a one-process run draws it; given the
    layout ``seq`` of a sharded instance axis ``dim``, it keeps its block of
    that axis too."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, seq: Optional[Seq] = None, dim: int = 1) -> torch.Tensor:
        if not training or self.p == 0.0:
            return x
        if gen is None:
            raise ValueError("dropout in training mode needs a torch.Generator")
        keep = 1.0 - self.p
        kept = rand_rows(x.shape, gen, x.device, seq, dim) < keep
        return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class FeatureEmbed(nn.Sequential):
    """Instance-feature MLP: Linear(input→inner) + act + dropout. Index 0 is the
    linear layer, so the weights are named ``feature.0.*`` as in the reference."""

    def __init__(self, input_dim: int, inner_dim: int = 512, act: str = "relu",
                 dropout: float = 0.25, use_bias: bool = True):
        super().__init__(dense(input_dim, inner_dim, use_bias), get_act(act), Dropout(dropout))

    def forward(self, x: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, seq: Optional[Seq] = None) -> torch.Tensor:
        return self[2](self[1](self[0](x)), training, gen, seq)


def _pool(pool: nn.Module, x, logits, mask, training, no_norm, seq: Optional[Seq] = None):
    """The end of both attention pools: ``logits[B,N,K]`` to ``(pooled[B,K,D],
    attn[B,K,N])``. K4 on no-grad paths (not training, one branch, use_flash);
    the differentiable masked softmax and weighted sum otherwise. Given the
    layout ``seq`` of instances sharded over the active sp row, the softmax
    and the sum are the row's (K4's blocks merged by :func:`merge_blocks`);
    ``pooled`` is on every rank, ``attn`` this rank's block."""
    logits = logits.transpose(-1, -2)  # [B,K,N]
    if pool.use_flash and not training and not no_norm and pool.n_branches == 1:
        pooled, attn = fused_abmil_pool(x, logits[:, 0], mask)
        if seq is not None:
            pooled, attn = merge_blocks(pooled, attn, logits[:, 0], mask)
        return pooled[:, None].to(x.dtype), attn[:, None, :].to(x.dtype)
    attn = masked_softmax(logits, mask[:, None, :], sharded=seq is not None)
    pooled = torch.einsum("bkn,bnd->bkd", attn, x)
    if seq is not None:
        pooled = sp_sum(pooled)
    return pooled, (logits if no_norm else attn)


def add_tanh_attention(mod: nn.Module, dim: int, attn_dim: int, n_branches: int, act: str,
                       use_bias: bool, dropout: float, use_flash: bool):
    """Give ``mod`` the layers of the ABMIL attention ``A = w2·act(w1·x)``:
    ``attention``, the reference's ``Sequential(Linear, act, Linear)``, and
    the dropout after the activation. A model that pools with it holds the
    layers itself, so that its weights keep the reference's names."""
    mod.n_branches, mod.use_flash = n_branches, use_flash
    mod.attention = nn.Sequential(dense(dim, attn_dim, use_bias), get_act(act),
                                  dense(attn_dim, n_branches, use_bias))
    mod.drop = Dropout(dropout)


def tanh_attention(mod: nn.Module, x, mask, training: bool = False,
                   gen: Optional[torch.Generator] = None, no_norm: bool = False, seq: Optional[Seq] = None):
    """Pool ``x`` with the layers of :func:`add_tanh_attention` on ``mod``
    (``seq``: see :func:`_pool`)."""
    a = mod.drop(mod.attention[1](mod.attention[0](x)), training, gen, seq)
    return _pool(mod, x, mod.attention[2](a), mask.bool(), training, no_norm, seq)


def add_gated_attention(mod: nn.Module, dim: int, attn_dim: int, n_branches: int, act: str,
                        use_bias: bool, dropout: float, use_flash: bool):
    """Give ``mod`` the layers of the gated attention ``A = w_c·(act(w_a·x) ⊙
    σ(w_b·x))``, with the reference's ``attention_a``/``_b``/``_c`` names."""
    mod.n_branches, mod.use_flash = n_branches, use_flash
    mod.attention_a = nn.Sequential(dense(dim, attn_dim, use_bias), get_act(act))
    mod.attention_b = nn.Sequential(dense(dim, attn_dim, use_bias), nn.Sigmoid())
    mod.attention_c = dense(attn_dim, n_branches, use_bias)
    mod.drop = Dropout(dropout)


def gated_attention(mod: nn.Module, x, mask, training: bool = False,
                    gen: Optional[torch.Generator] = None, no_norm: bool = False, seq: Optional[Seq] = None):
    """Pool ``x`` with the layers of :func:`add_gated_attention` on ``mod``;
    the two branches draw their dropout masks apart, as flax's do
    (``seq``: see :func:`_pool`)."""
    a = mod.drop(mod.attention_a(x), training, gen, seq)
    g = mod.drop(mod.attention_b(x), training, gen, seq)
    return _pool(mod, x, mod.attention_c(a * g), mask.bool(), training, no_norm, seq)


class TanhAttentionPool(nn.Module):
    """ABMIL attention pooling ``A = w2·act(w1·x)``, masked softmax over the
    instances, weighted sum (port of ``layers.py:66-114``). Returns
    ``(pooled[B,K,D], attn[B,K,N])``, attn softmaxed (raw with ``no_norm``)."""

    def __init__(self, dim: int, attn_dim: int = 128, n_branches: int = 1, act: str = "tanh",
                 use_bias: bool = True, dropout: float = 0.0, use_flash: bool = True):
        super().__init__()
        add_tanh_attention(self, dim, attn_dim, n_branches, act, use_bias, dropout, use_flash)

    forward = tanh_attention


class GatedAttentionPool(nn.Module):
    """Gated ABMIL attention pooling (port of ``layers.py:117-163``)."""

    def __init__(self, dim: int, attn_dim: int = 128, n_branches: int = 1, act: str = "tanh",
                 use_bias: bool = True, dropout: float = 0.0, use_flash: bool = True):
        super().__init__()
        add_gated_attention(self, dim, attn_dim, n_branches, act, use_bias, dropout, use_flash)

    forward = gated_attention


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Reference initialisation, drawn from ``generator`` in module order:
    a module's own ``init_own`` where it has one (the Mamba modules, whose
    initialisers the JAX package sets apart), else xavier-normal weights and
    zero biases for linear and convolution layers, unit LayerNorms (zero
    bias where they have one), N(0, σ²) for a ``cls_token`` (σ the module's
    ``cls_token_std``, default 1), and a module's own ``reset_buffers``."""
    for mod in model.modules():
        if hasattr(mod, "init_own"):
            mod.init_own(generator)
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            nn.init.xavier_normal_(mod.weight, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        cls = getattr(mod, "cls_token", None)
        if isinstance(cls, nn.Parameter):
            cls.normal_(0.0, getattr(mod, "cls_token_std", 1.0), generator=generator)
        if hasattr(mod, "reset_buffers"):  # Merge's global queries
            mod.reset_buffers(generator)
    return model
