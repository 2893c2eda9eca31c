"""The operations and bytes of the kernels that the rooflines read, from
the shapes of a call, at the precision the configuration states, and the
least time the card could take for them.

The card's peaks are NVIDIA's data sheet for one H100 SXM at 700 W: 989
TFLOP/s dense bf16 on the tensor cores, and 3.35 TB/s of HBM3. Every
operation counts against the bf16 peak, whatever a kernel runs it in,
and every byte once: each input read once, each output written once, at
the dtype the configuration states (bf16 activations; fp32 softmax
statistics, pseudo-inverse and its iterates; bool masks). How a kernel
is built (products split into three TF32 products, exponentials on the
special-function units, rereads) does not enter, so that no
implementation can read above 100%.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
ACT, STAT, MASK = 2, 4, 1  # bytes of an activation (bf16), a statistic (fp32), a mask entry (bool)

Work = Tuple[float, float]  # (operations, bytes)


def bound_s(work: Work) -> float:
    """The least seconds for ``(operations, bytes)``: the larger of the two bounds."""
    flops, nbytes = work
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def pass_a(ql: Sequence[int], k: Sequence[int]) -> Work:
    """``pass_a(ql[B,H,m,dh], k, v[B,H,N,dh], mask[B,N])``: the online softmax
    of ``ql·kᵀ`` over the keys and its product with v. Reads ql, k, v, mask;
    writes ``attn3v[B,H,m,dh]``, ``m3``, ``s3`` in fp32."""
    b, h, m, dh = ql
    n = k[2]
    flops = 2 * (2.0 * b * h * m * n * dh)
    nbytes = (b * h * m * dh + 2 * b * h * n * dh) * ACT + b * n * MASK + (b * h * m * dh + 2 * b * h * m) * STAT
    return flops, nbytes


def pass_b(q: Sequence[int], kl: Sequence[int]) -> Work:
    """``pass_b(q, k[B,H,N,dh], mask, kl, lm_mask, mid, ql[B,H,m,dh], rp, m3[B,H,m])``:
    per token the softmax of ``q·klᵀ`` times mid, and the cls row
    ``Σ_m rp·exp(ql·k − m3)``. Reads q, k, mask, the landmark operands;
    writes ``out[B,H,N,dh]`` and ``cls[B,H,N]``."""
    b, h, n, dh = q
    m = kl[2]
    flops = 3 * (2.0 * b * h * n * m * dh) + 2.0 * b * h * n * m
    nbytes = (2 * b * h * n * dh + 3 * b * h * m * dh) * ACT + (b * n + b * m) * MASK + 2 * b * h * m * STAT
    nbytes += b * h * n * dh * ACT + b * h * n * STAT
    return flops, nbytes


def newton_schulz(x: Sequence[int], iters: int, keep: bool) -> Work:
    """``newton_schulz(x[..., m, m], z0, iters, keep)``: four ``m × m``
    products an iteration, in fp32. Reads x and z0; writes the last iterate
    and, with ``keep``, the four iterates of every iteration."""
    m = x[-1]
    g = math.prod(x[:-2])
    flops = iters * 4 * 2.0 * g * m ** 3
    nbytes = (3 + (4 * iters if keep else 0)) * g * m * m * STAT
    return flops, nbytes


def depthwise_conv(x: Sequence[int], w: Sequence[int]) -> Work:
    """The value convolution ``conv2d(x[B,H,N,dh], w[H,1,kh,kw], groups=H)``
    with "same" padding: ``kh·kw`` products a output element. Reads x and
    w; writes an output of x's shape."""
    out = math.prod(x)
    return 2.0 * out * math.prod(w[2:]), (2 * out + math.prod(w)) * ACT


def depthwise_conv_backward(x: Sequence[int], w: Sequence[int], grad_input: bool, grad_weight: bool) -> Work:
    """Its backward: the input's gradient (the convolution of the output's
    gradient by the flipped kernel) and the weight's (a reduction of
    ``grad_out ⊙ shifted x`` over the batch and the columns), each as many
    products as the forward. Reads grad_out, and x and w as needed; writes
    the gradients asked for."""
    out = math.prod(x)
    taps = math.prod(w[2:])
    flops = 2.0 * out * taps * (int(grad_input) + int(grad_weight))
    nbytes = out * ACT  # grad_out
    if grad_input:
        nbytes += math.prod(w) * ACT + out * ACT
    if grad_weight:
        nbytes += out * ACT + math.prod(w) * ACT
    return flops, nbytes


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                         _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    """``aten.convolution_backward``: the input's gradient and the weight's
    each take as many products as the forward, ``prod(out)·prod(w[1:])``
    (``w[1]`` already the channels of one group). torch's own formula counts
    the weight's gradient as if the convolution were not grouped, which for
    a depthwise convolution is ``groups`` times too many."""
    out = x_shape if transposed else grad_out_shape
    forward = 2 * math.prod(out) * math.prod(w_shape[1:])
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def flop_counter():
    """``FlopCounterMode`` with the grouped convolution's backward counted as above."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flops})
