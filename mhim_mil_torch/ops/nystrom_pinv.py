"""The Newton–Schulz pseudo-inverse of K3's glue on the tensor cores (K3p).

The Nystrom attention's ``pinv(attn2)``, ``attn2[B,H,m,m]``, is 6
Newton–Schulz iterations from :func:`~.nystrom.pinv_start`
(``mhim_mil_tpu/ops/nystrom.py:33-56``, which the forward of the Pallas
custom VJP ``flash_nystrom`` runs in XLA between its kernels). Each
iteration

    xz = x·z,  u = xz·(7I − xz),  w = xz·(15I − u),  z' = 0.25·z·(13I − w)

is four products, and its reverse sweep eight. **K3p**
:func:`pinv_product` runs one of them, ``D = α·op(A)·(op(B) + d·I) + β·C``
over the batch of m × m matrices (``op`` transposes its operand where
asked), by the CUDA kernel of ``csrc/nystrom_pinv.cu`` on CUDA tensors
(3×TF32 ``mma.sync``; ``c·I − M`` as α negated and ``d = −c``, so no pass
over a matrix forms it) and by :func:`pinv_product_plain` on CPU tensors;
``pinv_product.launches`` counts its launches. :func:`pinv_program` runs a
list of products in order (its tensors checked once), :func:`newton_schulz`
and :func:`newton_schulz_backward` the iterations and their sweep as such
lists (the forward sweep is the ``torch.library`` op
``torch.ops.mhim_mil_torch.newton_schulz``, so that ``torch.export``
traces it; the reverse sweep is the op ``.newton_schulz_backward``, so
that a profile names it and records its iterations as a shape), and
:class:`NewtonSchulz` maps ``(x, z0) → z`` through them, saving the
iterates; :func:`pseudo_inverse` is the pseudo-inverse that
K3's glue runs: the
initial scale in plain torch under autograd (its gradient flows through
abs, the sums and the batch-wide max, near-ties and all), then
:class:`NewtonSchulz` on CUDA tensors, and ``moore_penrose_pinv`` on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import load_library
from ..kernels.launch import H100_SMS, check, on_cpu, raise_on, sm_count
from .nystrom import moore_penrose_pinv, pinv_start

Tensor = torch.Tensor
TILES = ((64, 64), (32, 32))  # the kernel's tiles, largest first (csrc nystrom_pinv_tiles)


def pinv_product_plain(a: Tensor, b: Tensor, alpha: float = 1.0, diag: float = 0.0, ta: bool = False,
                       tb: bool = False, c: Optional[Tensor] = None, beta: float = 0.0) -> Tensor:
    """K3p's function: ``α·op(a)·(op(b) + diag·I) + β·c`` over ``[..., m, m]``,
    ``op`` transposing where ``ta`` / ``tb``."""
    a = a.transpose(-1, -2) if ta else a
    b = b.transpose(-1, -2) if tb else b
    if diag:
        b = b + diag * torch.eye(b.shape[-1], dtype=b.dtype, device=b.device)
    d = alpha * (a @ b)
    return d + beta * c if beta else d


def pinv_plan(g: int, m: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """The tile ``(BM, BN)`` of a product over ``g`` matrices of ``m × m``:
    64 × 64 where its grid has a block for three quarters of the SMs, else
    32 × 32. On the H100 (``time_nystrom --cases pinv``) 64 × 64 was the
    faster with 128 blocks and more (m 256 at G 8, 16 and 32; m 128 at G
    32), 32 × 32 with 64 and 32 (m 128 at G 16 and 8)."""
    bm, bn = TILES[0]
    return TILES[0] if g * math.ceil(m / bm) * math.ceil(m / bn) >= 3 * sms // 4 else TILES[-1]


@functools.lru_cache(maxsize=None)
def _library():
    """K3p's library, once its tiles are checked against :data:`TILES`."""
    lib = load_library("nystrom_pinv")
    out = (ctypes.c_int * len(TILES))()
    lib.nystrom_pinv_tiles(out)
    got = tuple(divmod(v, 1000) for v in out)
    if got != TILES:
        raise RuntimeError(f"nystrom_pinv.cu's tiles {got} differ from the wrapper's {TILES}")
    return lib


def pinv_product(a: Tensor, b: Tensor, alpha: float = 1.0, diag: float = 0.0, ta: bool = False,
                 tb: bool = False, c: Optional[Tensor] = None, beta: float = 0.0,
                 out: Optional[Tensor] = None) -> Tensor:
    """K3p: ``α·op(a)·(op(b) + diag·I) + β·c`` by the CUDA kernel on CUDA
    tensors (fp32, contiguous ``[..., m, m]``, m a multiple of 4; into
    ``out`` where given, which may be ``c``; never both transposed), by
    :func:`pinv_product_plain` on CPU tensors. ``pinv_product.launches``
    counts the launches, this function's and :func:`pinv_program`'s."""
    if out is None and not on_cpu(a, b, *(() if c is None else (c,))):
        out = torch.empty_like(a)
    return pinv_program([(a, b, c, out, alpha, diag, ta, tb, beta)])[0]


pinv_product.launches = 0


def pinv_program(products: List[tuple]) -> List[Tensor]:
    """Run ``products`` in order, each ``(a, b, c, out, alpha, diag, ta,
    tb, beta)`` writing ``out`` (which may be ``c``) from what the earlier
    ones wrote, and return the outs: on CUDA tensors one K3p launch each,
    every tensor checked once; on CPU tensors :func:`pinv_product_plain`
    each (into ``out`` where given)."""
    if on_cpu(*(t for p in products for t in p[:4] if t is not None)):
        outs = []
        for a, b, c, out, alpha, diag, ta, tb, beta in products:
            d = pinv_product_plain(a, b, alpha, diag, ta, tb, c, beta)
            outs.append(d if out is None else out.copy_(d))
        return outs
    a0 = products[0][0]
    m = a0.shape[-1]
    g = a0.numel() // (m * m) if m else 0
    dev = a0.device
    seen = set()
    for a, b, c, out, alpha, diag, ta, tb, beta in products:
        for name, t in (("a", a), ("b", b), ("out", out)) + ((("c", c),) if c is not None else ()):
            if id(t) not in seen:
                check(name, t, a0.shape, dev, contiguous=True)
                seen.add(id(t))
        if a0.shape[-2] != m or g < 1 or m % 4 or (ta and tb) or (beta and c is None) \
                or out.data_ptr() in (a.data_ptr(), b.data_ptr()):
            raise ValueError(f"K3p takes [..., m, m] with m a multiple of 4, one transpose at most, c with beta, and "
                             f"out apart from a and b; got {tuple(a0.shape)}, ta {ta}, tb {tb}, beta {beta}")
    bm, bn = pinv_plan(g, m, sm_count(dev.index))
    lib, stream = _library(), torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for a, b, c, out, alpha, diag, ta, tb, beta in products:
            err = lib.nystrom_pinv_product(a.data_ptr(), b.data_ptr(), c.data_ptr() if beta else None, out.data_ptr(),
                                           g, m, int(ta), int(tb), alpha, diag, beta, bm, bn, stream)
            raise_on(err, "nystrom_pinv_product")
            pinv_product.launches += 1
    return [p[3] for p in products]


def newton_schulz(x: Tensor, z: Tensor, iters: int, keep: bool = False) -> Tuple[Tensor, Tensor]:
    """``iters`` Newton–Schulz iterations from ``z``, four products each, as
    one :func:`pinv_program`; returns the last iterate and the op's
    ``iterates[iters, 4, *x.shape]``, each iteration's ``(z, xz, u, w)``
    for :func:`newton_schulz_backward` where ``keep``, else
    ``[0, 4, *x.shape]`` (the iterations then share their buffers)."""
    on_cpu(x, z)  # raises on a mix or another device, which the dispatcher would take to the fake
    return torch.ops.mhim_mil_torch.newton_schulz(x, z, iters, keep)


@torch.library.custom_op("mhim_mil_torch::newton_schulz", mutates_args=(), device_types=("cpu", "cuda"),
                         schema="(Tensor x, Tensor z0, int iters, bool keep) -> (Tensor, Tensor)")
def _newton_schulz_op(x: Tensor, z0: Tensor, iters: int, keep: bool) -> Tuple[Tensor, Tensor]:
    """The forward sweep as one op: K3p launches on CUDA tensors (``x`` and
    ``z0`` contiguous, as :func:`pinv_program` checks),
    :func:`pinv_product_plain` on CPU tensors. Returns the last iterate and
    ``iterates[iters, 4, *x.shape]``, each iteration's ``(z, xz, u, w)``
    where ``keep`` (the first ``z`` a copy of ``z0``, so that no output is
    an input), else ``[0, 4, *x.shape]``."""
    iterates = x.new_empty((iters if keep else 0, 4, *x.shape))
    if iters == 0:
        return z0.clone(), iterates
    xz, u, w = (torch.empty_like(x) for _ in range(3))
    zs = (torch.empty_like(x), torch.empty_like(x))
    products = []
    z = z0
    if keep:
        iterates[0, 0].copy_(z0)
    for i in range(iters):
        if keep:
            xz, u, w = iterates[i, 1], iterates[i, 2], iterates[i, 3]
        last = i == iters - 1
        z_next = (torch.empty_like(x) if last else iterates[i + 1, 0]) if keep else zs[i % 2]
        products += [(x, z, None, xz, 1.0, 0.0, False, False, 0.0),  # xz = x·z
                     (xz, xz, None, u, -1.0, -7.0, False, False, 0.0),  # u = xz·(7I − xz)
                     (xz, u, None, w, -1.0, -15.0, False, False, 0.0),  # w = xz·(15I − u)
                     (z, w, None, z_next, -0.25, -13.0, False, False, 0.0)]  # z' = 0.25·z·(13I − w)
        z = z_next
    pinv_program(products)
    return z, iterates


@_newton_schulz_op.register_fake
def _(x, z0, iters, keep):
    return x.new_empty(x.shape), x.new_empty((iters if keep else 0, 4, *x.shape))


def newton_schulz_backward(x: Tensor, iterates: Tensor, g: Tensor) -> Tuple[Tensor, Tensor]:
    """The reverse sweep of :func:`newton_schulz` under the cotangent ``g``
    of its last iterate, eight products an iteration, as the op
    ``torch.ops.mhim_mil_torch.newton_schulz_backward``: returns the
    cotangents of ``x`` and of the first iterate, from the
    ``iterates[iters, 4, *x.shape]`` that :func:`newton_schulz` kept."""
    return torch.ops.mhim_mil_torch.newton_schulz_backward(x, iterates, g)


@torch.library.custom_op("mhim_mil_torch::newton_schulz_backward", mutates_args=(), device_types=("cpu", "cuda"),
                         schema="(Tensor x, Tensor iterates, Tensor g) -> (Tensor, Tensor)")
def _newton_schulz_backward_op(x: Tensor, iterates: Tensor, g: Tensor) -> Tuple[Tensor, Tensor]:
    """The reverse sweep as one :func:`pinv_program`, its iterations in
    reverse order (K3p launches on CUDA tensors, ``x``, ``iterates`` and
    ``g`` contiguous); with no iteration the cotangents pass through."""
    if iterates.shape[0] == 0:
        return torch.zeros_like(x), g.clone()
    dw, du, dxz, dx = (torch.empty_like(x) for _ in range(4))
    dzs = (torch.empty_like(x), torch.empty_like(x))
    products = []
    for i, (z, xz, u, w) in enumerate(reversed(iterates.unbind(0))):
        dz = dzs[i % 2]
        acc = 0.0 if i == 0 else 1.0  # dx is written by the first iteration of the sweep, then added to
        products += [(g, w, None, dz, -0.25, -13.0, False, True, 0.0),  # dz = 0.25·G·(13I − w)ᵀ
                     (z, g, None, dw, -0.25, 0.0, True, False, 0.0),  # dw = −0.25·zᵀ·G
                     (dw, u, None, dxz, -1.0, -15.0, False, True, 0.0),  # dxz = dw·(15I − u)ᵀ
                     (xz, dw, None, du, -1.0, 0.0, True, False, 0.0),  # du = −xzᵀ·dw
                     (du, xz, dxz, dxz, -1.0, -7.0, False, True, 1.0),  # dxz += du·(7I − xz)ᵀ
                     (xz, du, dxz, dxz, -1.0, 0.0, True, False, 1.0),  # dxz −= xzᵀ·du
                     (dxz, z, dx if acc else None, dx, 1.0, 0.0, False, True, acc),  # dx += dxz·zᵀ
                     (x, dxz, dz, dz, 1.0, 0.0, True, False, 1.0)]  # dz += xᵀ·dxz
        g = dz
    pinv_program(products)
    return dx, g


@_newton_schulz_backward_op.register_fake
def _(x, iterates, g):
    return x.new_empty(x.shape), x.new_empty(x.shape)


class NewtonSchulz(torch.autograd.Function):
    """``(x, z0) → z``: :func:`newton_schulz` forward, saving the iterates
    when a gradient is needed (4 matrices an iteration, so the backward
    recomputes nothing), and :func:`newton_schulz_backward` backward."""

    @staticmethod
    def forward(ctx, x, z0, iters):
        x, z0 = x.contiguous(), z0.contiguous()
        keep = any(ctx.needs_input_grad[:2])
        on_cpu(x, z0)  # raises on a mix or another device, as in newton_schulz
        z, iterates = torch.ops.mhim_mil_torch.newton_schulz(x, z0, iters, keep)
        if keep:
            ctx.save_for_backward(x, iterates)
        return z

    @staticmethod
    def backward(ctx, g):
        x, iterates = ctx.saved_tensors
        dx, dz0 = newton_schulz_backward(x, iterates, g.contiguous())
        return dx, dz0, None


def pseudo_inverse(x: Tensor, iters: int = 6) -> Tensor:
    """``pinv(x)`` of ``x[..., m, m]``, differentiable: on CUDA tensors
    :func:`newton_schulz_pinv` (K3p), on CPU tensors
    :func:`~.nystrom.moore_penrose_pinv`."""
    if x.device.type == "cpu":
        return moore_penrose_pinv(x, iters)
    return newton_schulz_pinv(x, iters)


def newton_schulz_pinv(x: Tensor, iters: int = 6) -> Tensor:
    """:func:`pseudo_inverse`'s card path, on any device (the plain products
    on the CPU): :func:`pinv_start` in plain torch under autograd, then
    :class:`NewtonSchulz`, in fp32; m zero-padded to a multiple of 4, which
    is exact (the padded rows and columns stay zero)."""
    x, z0 = pinv_start(x)
    m = x.shape[-1]
    pad = -m % 4
    if pad:
        x, z0 = F.pad(x, (0, pad, 0, pad)), F.pad(z0, (0, pad, 0, pad))
    z = NewtonSchulz.apply(x, z0, iters)
    return z[..., :m, :m] if pad else z
