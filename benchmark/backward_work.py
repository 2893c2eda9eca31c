"""The operations and bytes of the Nystrom attention's backward kernels, from
the shapes that their ops record, and the reader of their roofline.

K1b, K2b and K3p's reverse sweep run inside the program's ops
``mhim_mil_torch::pass_a_backward``, ``::pass_b_backward`` and
``::newton_schulz_backward`` (:data:`OPS`). The counts are in the terms of
``workcounts.py``: every operation against the bf16 peak, every byte once
(each input read once, each output written once) at the dtype the
configuration states: bf16 activations and their gradients, fp32 softmax
statistics (``attn3v``, ``m3``, ``s3``, ``r'``, the cls row), the
pseudo-inverse's iterates, and the cotangents of each of those, in fp32;
bool masks. A program without these ops (one that launches the kernels
outside any op) gives no reading.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from .workcounts import ACT, MASK, STAT, Work, bound_s

OPS = ("mhim_mil_torch::pass_a_backward", "mhim_mil_torch::pass_b_backward",
       "mhim_mil_torch::newton_schulz_backward")


def pass_a_backward(ql: Sequence[int], k: Sequence[int], s3_cot: bool) -> Work:
    """K1b, ``pass_a_backward(ql[B,H,m,dh], k, v[B,H,N,dh], mask[B,N], attn3v,
    m3, s3, d_attn3v, d_s3)``: with ``P = exp(ql·kᵀ − m3) / s3`` over the
    valid keys, ``dP = d_attn3v·vᵀ``, ``dS = P ∘ (dP − D)``, and the
    gradients ``d_ql = dS·k``, ``d_k = dSᵀ·ql``, ``d_v = Pᵀ·d_attn3v``: five
    products of ``m × N × dh``, two operations a multiply-add,
    ``10·B·H·m·N·dh``. Reads ql, k, v, the mask, attn3v, m3, s3, d_attn3v
    and, where given, d_s3; writes d_ql, d_k and d_v."""
    b, h, m, dh = ql
    n = k[2]
    flops = 5 * (2.0 * b * h * m * n * dh)
    nbytes = (b * h * m * dh + 2 * b * h * n * dh) * ACT + b * n * MASK
    nbytes += (2 * b * h * m * dh + (3 if s3_cot else 2) * b * h * m) * STAT
    nbytes += (b * h * m * dh + 2 * b * h * n * dh) * ACT
    return flops, nbytes


def pass_b_backward(q: Sequence[int], kl: Sequence[int], cls: bool) -> Work:
    """K2b, ``pass_b_backward(q, k[B,H,N,dh], mask, kl[B,H,m,dh], lm_mask, mid,
    ql, rp, m3, d_out, d_cls, out)``: with ``P1 = softmax_m(q·klᵀ)``,
    ``dP1 = d_out·midᵀ``, ``dS1 = P1 ∘ (dP1 − Σ_m P1·dP1)``, and
    ``d_q = dS1·kl``, ``d_kl = dS1ᵀ·q``, ``d_mid = P1ᵀ·d_out``: five products
    of ``N × m × dh``; with ``d_cls`` also ``E = exp(ql·kᵀ − m3)``,
    ``d_k = Gᵀ·ql`` and ``d_ql = G·k`` (``G = r'·E·d_cls``): eight. Reads
    q, kl, mid, the two masks, d_out and out; writes d_q, d_kl and d_mid.
    Only the cls term reads k, ql, r', m3 and d_cls (the kernels stage
    them under ``if constexpr (CLS)`` alone) and writes d_k, d_ql and d_r'."""
    b, h, n, dh = q
    m = kl[2]
    flops = (8 if cls else 5) * (2.0 * b * h * n * m * dh)
    nbytes = (b * h * n * dh + 2 * b * h * m * dh) * ACT + (b * n + b * m) * MASK  # q, kl, mid, the masks
    nbytes += 2 * b * h * n * dh * ACT  # d_out, out
    nbytes += (b * h * n * dh + 2 * b * h * m * dh) * ACT  # d_q, d_kl, d_mid
    if cls:
        nbytes += (b * h * n * dh + b * h * m * dh) * ACT + (2 * b * h * m + b * h * n) * STAT  # k, ql, r', m3, d_cls
        nbytes += (b * h * n * dh + b * h * m * dh) * ACT + b * h * m * STAT  # d_k, d_ql, d_r'
    return flops, nbytes


def newton_schulz_backward(x: Sequence[int], iters: int) -> Work:
    """K3p's reverse sweep, ``newton_schulz_backward(x[..., m, m],
    iterates[iters, 4, ..., m, m], g)``: the reverse of an iteration's four
    products is eight ``m × m`` products (two a forward product, one for
    each operand's cotangent), ``16·iters·G·m³`` operations over the ``G``
    matrices. Reads x, the iterates and g; writes dx and dz0, all fp32."""
    m = x[-1]
    g = math.prod(x[:-2])
    return iters * 8 * 2.0 * g * m ** 3, (4 * iters + 4) * g * m * m * STAT


def work(name: str, shapes: list) -> Optional[Work]:
    """The work of one call of the op ``name`` from its recorded input shapes
    (an absent optional input records ``[]``), or None where they are not
    all there."""
    if name == OPS[0] and len(shapes) == 9:
        return pass_a_backward(shapes[0], shapes[1], bool(shapes[8]))
    if name == OPS[1] and len(shapes) == 12:
        return pass_b_backward(shapes[0], shapes[3], bool(shapes[10]))
    if name == OPS[2] and len(shapes) == 3 and shapes[1]:
        return newton_schulz_backward(shapes[0], shapes[1][0])
    return None


def roofline(run) -> Optional[float]:
    """Σ bound / Σ device seconds, in %, over the calls of :data:`OPS` in the
    traced window that have device time; None where none has."""
    if run.trace is None:
        return None
    bound = spent = 0.0
    for name in OPS:
        for op in run.trace.ops.get(name, []):
            w = work(name, op.shapes)
            if w is not None and op.device_s > 0:
                bound += bound_s(w)
                spent += op.device_s
    return 100.0 * bound / spent if spent > 0 else None
