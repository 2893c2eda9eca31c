"""The frozen work counts against FlopCounterMode on plain computations of
the same functions at small shapes, and the peaks they count against."""

import ast

import pytest
import torch
import torch.nn.functional as F

from benchmark import workcounts as wc
from benchmark.reference import common


def _count(fn):
    with wc.flop_counter() as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("b,h,n,m,dh", [(2, 3, 40, 8, 16), (1, 8, 97, 16, 64)])
def test_nystrom_passes(b, h, n, m, dh):
    ql, k, v = torch.randn(b, h, m, dh), torch.randn(b, h, n, dh), torch.randn(b, h, n, dh)
    q, kl, mid = torch.randn(b, h, n, dh), torch.randn(b, h, m, dh), torch.randn(b, h, m, dh)
    rp = torch.randn(b, h, 1, m)

    def pass_a():  # attn3 = softmax(ql·kᵀ), attn3·v
        torch.softmax(ql @ k.transpose(-1, -2), -1) @ v

    def pass_b():  # softmax(q·klᵀ)·mid, and the cls row rp·exp(ql·kᵀ)
        torch.softmax(q @ kl.transpose(-1, -2), -1) @ mid
        rp @ torch.exp(ql @ k.transpose(-1, -2))

    assert wc.pass_a(ql.shape, k.shape)[0] == _count(pass_a)
    assert wc.pass_b(q.shape, kl.shape)[0] == _count(pass_b)


@pytest.mark.parametrize("g,m,iters", [((2, 3), 16, 6), ((4,), 32, 2)])
def test_newton_schulz(g, m, iters):
    x = torch.softmax(torch.randn(*g, m, m), -1)
    assert wc.newton_schulz(x.shape, iters, False)[0] == _count(lambda: common.pseudo_inverse(x, iters))


@pytest.mark.parametrize("b,h,n,dh", [(2, 8, 50, 64), (1, 2, 33, 16)])
def test_value_convolution(b, h, n, dh):
    x = torch.randn(b, h, n, dh, requires_grad=True)
    w = torch.randn(h, 1, 33, 1, requires_grad=True)
    assert wc.depthwise_conv(x.shape, w.shape)[0] == _count(lambda: F.conv2d(x, w, padding=(16, 0), groups=h))
    y = F.conv2d(x, w, padding=(16, 0), groups=h)
    assert wc.depthwise_conv_backward(x.shape, w.shape, True, True)[0] == _count(
        lambda: torch.autograd.grad(y.sum(), (x, w), retain_graph=True))


def test_bounds_use_only_the_data_sheet():
    """Operations at 989 TFLOP/s and bytes at 3.35 TB/s, and no other rate
    in the module (no 3×TF32 at 495, no fp32 FMAs at 67, no exponentials)."""
    assert (wc.PEAK_FLOPS, wc.PEAK_BYTES_S) == (989e12, 3.35e12)
    for work in ((1e12, 1.0), (1.0, 1e9), (3e9, 7e6)):
        assert wc.bound_s(work) == max(work[0] / 989e12, work[1] / 3.35e12)
    tree = ast.parse(open(wc.__file__).read())
    numbers = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, float)
               and n.value > 1e6}
    assert numbers == {989e12, 3.35e12}
    # K1 at 4 × 10,240: two products of ql·kᵀ's size, and k, v read once in bf16
    fl, by = wc.pass_a((4, 8, 256, 64), (4, 8, 10240, 64))
    assert fl == 4 * 4 * 8 * 256 * 10240 * 64 and by >= 2 * 4 * 8 * 10240 * 64 * 2
