"""Plain PyTorch building blocks of the references, in fp32.

Nothing here imports the program. Each block is written from the
published description (Nystromformer, Xiong et al. 2021, eq. 15; TransMIL,
Shao et al. 2021; MHIM-MIL, Tang et al. 2023) in the layout the program
uses: bags ``x[B, N, D]`` padded at the end with a validity mask
``[B, N]``, every random draw ``torch.rand`` of the drawn shape from one
generator, in the order the program draws. Parameters are a flat dict by
the program's names, so that the benchmark can hand one set of weights to
both sides.

``Precision`` rounds the operands of every product (linear, convolution,
attention product) to the precision it names: ``float32`` leaves them as
they are; ``fp8`` rounds them to float8 e4m3, the control that the
comparison must fail; ``bf16`` rounds them to bfloat16, the precision the
configurations state, as a witness of what that precision alone moves. Softmax statistics, the pseudo-inverse, the norms and
the losses stay fp32 in both, as the configurations state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]
NEG_INF = -1e30
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


class Precision:
    """The rounding of every product's operands: ``float32``, ``bf16`` or ``fp8``."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bf16", "fp8"):
            raise ValueError(f"precision {kind!r}: float32, bf16 or fp8")
        self.kind = kind

    def __call__(self, x: Tensor) -> Tensor:
        if self.kind == "float32" or not x.is_floating_point():
            return x
        if self.kind == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)


FP32 = Precision("float32")


@contextlib.contextmanager
def no_tf32():
    """fp32 products as fp32: TF32 off for cuBLAS and cuDNN inside, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ---- weights -------------------------------------------------------------------

def linear_spec(name: str, d_in: int, d_out: int, bias: bool = True) -> List[Tuple]:
    spec = [(f"{name}.weight", (d_out, d_in), "xavier")]
    return spec + ([(f"{name}.bias", (d_out,), "zeros")] if bias else [])


def norm_spec(name: str, d: int) -> List[Tuple]:
    return [(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")]


def translayer_spec(name: str, dim: int, heads: int) -> List[Tuple]:
    inner = dim  # heads × (dim / heads)
    return (norm_spec(f"{name}.norm", dim) + linear_spec(f"{name}.attn.to_qkv", dim, 3 * inner, bias=False)
            + linear_spec(f"{name}.attn.to_out.0", inner, dim)
            + [(f"{name}.attn.res_conv.weight", (heads, 1, 33, 1), "xavier")])


def ppeg_spec(name: str, dim: int) -> List[Tuple]:
    spec = []
    for conv, k in (("proj", 7), ("proj1", 5), ("proj2", 3)):
        spec += [(f"{name}.{conv}.weight", (dim, 1, k, k), "xavier"), (f"{name}.{conv}.bias", (dim,), "zeros")]
    return spec


def xavier_std(shape: Sequence[int]) -> float:
    """The xavier-normal standard deviation of a weight of ``shape`` (gain 1)."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return math.sqrt(2.0 / (fan_in + fan_out))


# ---- layers -------------------------------------------------------------------------

def linear(p: Params, name: str, x: Tensor, prec: Precision) -> Tensor:
    return F.linear(prec(x), prec(p[f"{name}.weight"]), p.get(f"{name}.bias"))


def layer_norm(p: Params, name: str, x: Tensor) -> Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def gelu(x: Tensor) -> Tensor:
    """GELU, tanh approximation (flax's and the port's ``gelu``)."""
    return F.gelu(x, approximate="tanh")


def act(name: str, x: Tensor) -> Tensor:
    return {"gelu": gelu, "relu": F.relu}[name](x)


def dropout(x: Tensor, p: float, gen: Optional[torch.Generator]) -> Tensor:
    """Inverted dropout with the keep mask ``rand(x.shape) < 1 − p`` from
    ``gen``; no draw when ``gen`` is None (evaluation) or ``p`` is 0."""
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def masked_softmax(logits: Tensor, mask: Tensor) -> Tensor:
    """Softmax over the last axis at the True positions of ``mask``; 0 elsewhere."""
    x = torch.where(mask, logits, NEG_INF)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True).detach()) * mask
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def landmark_means(t: Tensor, mask: Tensor, m: int) -> Tuple[Tensor, Tensor]:
    """Means of ``t[B, H, N, d]`` over ``m`` groups of consecutive tokens,
    valid tokens only: token i in group ``(i + m·l − N) // l``, ``l =
    ceil(N / m)``, so the empty groups come first. Returns ``(means,
    lm_mask[B, m])``; an empty group is masked and its mean 0."""
    b, h, n, d = t.shape
    l = -(-n // m)
    group = (torch.arange(n, device=t.device) + m * l - n) // l
    t = t * mask[:, None, :, None]
    sums = t.new_zeros((b, h, m, d)).index_add_(2, group, t)
    counts = mask.float().new_zeros((b, m)).index_add_(1, group, mask.float())
    return sums / counts.clamp_min(1.0)[:, None, :, None], counts > 0


def pseudo_inverse(x: Tensor, iters: int) -> Tensor:
    """The Newton–Schulz pseudo-inverse of Nystromformer (fp32): from
    ``z = xᵀ / (max row sum · max column sum)`` of |x|, the maxes over the
    whole batch, ``z ← ¼·z·(13I − xz·(15I − xz·(7I − xz)))``."""
    x = x.float()
    a = x.abs()
    z = x.transpose(-1, -2) / (a.sum(dim=-1).max() * a.sum(dim=-2).max()).clamp_min(1e-12)
    eye = torch.eye(x.shape[-1], device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - xz @ (15 * eye - xz @ (7 * eye - xz)))
    return z


def nystrom_attention(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, m: int, iters: int, prec: Precision,
                      return_attn: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """Masked Nystrom attention ``softmax(Q·K̃ᵀ)·pinv(softmax(Q̃·K̃ᵀ))·softmax(Q̃·Kᵀ)·V``
    (q pre-scaled), materialised. Returns ``out[B, H, N, dh]`` (0 at masked
    tokens) and, with ``return_attn``, the cls row (token 0) of the
    attention ``[B, H, N]``."""
    valid = mask[:, None, :, None]
    q, k, v = (torch.where(valid, t, 0.0) for t in (q, k, v))
    q_l, lm_mask = landmark_means(q, mask, m)
    k_l, _ = landmark_means(k, mask, m)
    lm = lm_mask[:, None, None, :]
    attn1 = masked_softmax(prec(q) @ prec(k_l).transpose(-1, -2), lm)
    attn2 = masked_softmax(prec(q_l) @ prec(k_l).transpose(-1, -2), lm)
    attn3 = masked_softmax(prec(q_l) @ prec(k).transpose(-1, -2), mask[:, None, None, :])
    z = pseudo_inverse(attn2, iters) @ (prec(attn3) @ prec(v))
    out = torch.where(valid, prec(attn1) @ prec(z), 0.0)
    if not return_attn:
        return out, None
    cls = (attn1[:, :, :1] @ pseudo_inverse(attn2, iters)) @ attn3
    return out, cls[:, :, 0]


def nystrom_msa(p: Params, name: str, x: Tensor, mask: Tensor, heads: int, prec: Precision,
                gen: Optional[torch.Generator], return_attn: bool = False):
    """Nystrom multi-head self-attention with the (33, 1) depthwise value
    convolution (TransMIL's ``NystromAttention``), ``dim / 2`` landmarks, 6
    iterations, and dropout 0.1 on its output. With ``return_attn`` also the
    cls row of the attention and ``to_out`` of the cls-attention-weighted
    values of the instance tokens (MHIM's pseudo-score ingredients)."""
    b, n, dim = x.shape
    dh = dim // heads
    x = torch.where(mask[..., None], x, 0.0)
    qkv = linear(p, f"{name}.to_qkv", x, prec).view(b, n, 3, heads, dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, N, dh]
    out, attn = nystrom_attention(q * dh ** -0.5, k, v, mask, dim // 2, 6, prec, return_attn)
    conv = F.conv2d(prec(v), prec(p[f"{name}.res_conv.weight"]), padding=(16, 0), groups=heads)
    out = (out + conv).transpose(1, 2).reshape(b, n, dim)
    out = torch.where(mask[..., None], dropout(linear(p, f"{name}.to_out.0", out, prec), 0.1, gen), 0.0)
    if not return_attn:
        return out
    weighted = (v[:, :, 1:] * attn[:, :, 1:, None]).transpose(1, 2).reshape(b, n - 1, dim)
    return out, attn, linear(p, f"{name}.to_out.0", weighted, prec)


def trans_layer(p: Params, name: str, x: Tensor, mask: Tensor, heads: int, prec: Precision,
                gen: Optional[torch.Generator], return_attn: bool = False):
    """``x + MSA(LayerNorm(x))``."""
    if return_attn:
        z, attn, scored = nystrom_msa(p, f"{name}.attn", layer_norm(p, f"{name}.norm", x), mask, heads, prec,
                                      gen, True)
        return x + z, attn, scored
    return x + nystrom_msa(p, f"{name}.attn", layer_norm(p, f"{name}.norm", x), mask, heads, prec, gen)


def ppeg(p: Params, name: str, x: Tensor, mask: Tensor, prec: Precision) -> Tensor:
    """TransMIL's PPEG: the bag laid row-major on a ``ceil(√N)²`` grid (0 at
    masked and filler cells), plus its 7×7, 5×5 and 3×3 depthwise
    convolutions; masked tokens keep their input."""
    b, n, c = x.shape
    hw = math.ceil(math.sqrt(n))
    grid = F.pad(x * mask[..., None], (0, 0, 0, hw * hw - n)).view(b, hw, hw, c).permute(0, 3, 1, 2)
    out = grid
    for conv, k in (("proj", 7), ("proj1", 5), ("proj2", 3)):
        out = out + F.conv2d(prec(grid), prec(p[f"{name}.{conv}.weight"]), p[f"{name}.{conv}.bias"],
                             padding=k // 2, groups=c)
    out = out.permute(0, 2, 3, 1).reshape(b, hw * hw, c)[:, :n]
    return torch.where(mask[..., None], out, x)


def cls_encoder(p: Params, prefix: str, x: Tensor, mask: Tensor, heads: int, prec: Precision,
                gen: Optional[torch.Generator], pos_name: str, return_attn: bool = False):
    """cls token, TransLayer, PPEG on the instance tokens, TransLayer, and
    the LayerNorm of the cls token. Returns the normed cls feature and,
    with ``return_attn``, layer 1's cls attention of the instances and its
    scored values."""
    b = x.shape[0]
    x = torch.cat([p[f"{prefix}cls_token"].expand(b, 1, -1), x], dim=1)
    full = torch.cat([mask.new_ones((b, 1)), mask], dim=1)
    scored = attn = None
    if return_attn:
        x, attn, scored = trans_layer(p, f"{prefix}layer1", x, full, heads, prec, gen, True)
    else:
        x = trans_layer(p, f"{prefix}layer1", x, full, heads, prec, gen)
    x = torch.cat([x[:, :1], ppeg(p, f"{prefix}{pos_name}", x[:, 1:], mask, prec)], dim=1)
    x = trans_layer(p, f"{prefix}layer2", x, full, heads, prec, gen)
    return layer_norm(p, f"{prefix}norm", x[:, 0]), attn, scored


def weighted_mean(per_bag: Tensor, weights: Tensor) -> Tensor:
    w = weights.float()
    return (per_bag * w).sum() / w.sum().clamp_min(1.0)


def cross_entropy(logits: Tensor, target: Tensor, weights: Tensor) -> Tensor:
    """Mean cross-entropy over the bags that ``weights`` marks."""
    nll = -torch.gather(F.log_softmax(logits.float(), dim=-1), -1, target.long()[:, None])[:, 0]
    return weighted_mean(nll, weights)


# ---- optimisation ----------------------------------------------------------------------

def cosine(base: float, final: float, total: int, step) -> Tensor:
    """A half cosine from ``base`` to ``final`` over ``total`` steps, in fp32
    on the host (no warm-up)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    t = (step / max(int(total), 1)).clamp(0.0, 1.0)
    return final + 0.5 * (base - final) * (1 + torch.cos(torch.as_tensor(math.pi, dtype=torch.float32) * t))


class Adam:
    """Adam with the weight decay added to the gradient (``adam`` +
    ``add_decayed_weights``), eps 1e-8, betas 0.9 / 0.999, in place on a
    dict of fp32 leaves."""

    def __init__(self, params: Params, weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.wd, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params, lr: float) -> Params:
        """The gradients as the optimizer takes them (decay added), after it moved ``params``."""
        self.t += 1
        taken = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / (1 - self.b2 ** self.t)).sqrt() + self.eps
            p.sub_(lr / (1 - self.b1 ** self.t) * self.m[k] / denom)
        return taken
