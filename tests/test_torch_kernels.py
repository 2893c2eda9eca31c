"""K1-K6, K1b and K2b against their plain versions on a Hopper card, and the kernel check.

Marked ``cuda``: skips without a card of capability 9.0. This file imports no
JAX, so it runs on the card's machine, from the root of the repo:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py``.
"""

import pytest
import torch

import os
import subprocess
import sys

from mhim_mil_torch.ops import abmil_pool, probe, scan2d
from mhim_mil_torch.ops import flash_nystrom as fn
from mhim_mil_torch.ops import nystrom_pinv as npv
from mhim_mil_torch.ops.masked import masked_softmax
from mhim_mil_torch.ops.nystrom import _landmark_mean, moore_penrose_pinv, nystrom_attention
from mhim_mil_torch.utils.kernel_check import pinv_reference64, vjp_close

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA card of capability 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_passes(dev, q, k, v, mask, m):
    """K1 and K2 against pass_a_plain / pass_b_plain on the same card inputs,
    one launch each; attn3v, m3, s3 and out at rtol 1e-4 atol 1e-5, cls at
    max|d| <= 1e-4 max|ref| (entries are small)."""
    q_l, k_l, lm_mask, pinv = fn.landmarks(q, k, mask, m)
    want_a = fn.pass_a_plain(q_l, k, v, mask)
    before = (fn.pass_a.launches, fn.pass_b.launches)
    got_a = fn.pass_a(q_l, k, v, mask)
    torch.cuda.synchronize()
    for got, want in zip(got_a, want_a):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    mid, rp = fn.pass_b_operands(q, k_l, mask, lm_mask, pinv, *want_a[::2])
    args = (q, k, mask, k_l, lm_mask, mid, q_l, rp, want_a[1])
    got_out, got_cls = fn.pass_b(*args)
    want_out, want_cls = fn.pass_b_plain(*args)
    torch.cuda.synchronize()
    assert (fn.pass_a.launches, fn.pass_b.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got_out, want_out, rtol=RTOL, atol=ATOL)
    assert (got_cls - want_cls).abs().max() <= 1e-4 * want_cls.abs().max()
    return got_a, (got_out, got_cls), lm_mask


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,dh,m,ragged", [(2, 1000, 64, 64, True), (2, 100, 32, 8, False),
                                             (1, 10241, 64, 256, False)])
def test_kernels_match_plain_versions_on_the_card(hopper, b, n, dh, m, ragged):
    """K1 and K2 against their plain versions, ragged and full, up to the
    flagship's batch-1 shape (N 10,241, m 256, dh 64), at the tolerances of
    ``_check_passes``."""
    gen = torch.Generator(device=hopper).manual_seed(0)
    h = 4 if b == 2 else 8
    q, k, v = (torch.randn(b, h, n, dh, device=hopper, generator=gen) for _ in range(3))
    q = q * dh ** -0.5
    lengths = torch.tensor([n * 2 // 3 if ragged else n, n][:b], device=hopper)
    mask = torch.arange(n, device=hopper)[None] < lengths[:, None]
    _check_passes(hopper, q, k, v, mask, m)


@pytest.mark.cuda
@pytest.mark.parametrize("h,n,dh,m,lengths", [
    (2, 300, 16, 8, (300, 150)),  # DH 16, m = 8; bag 1 leaves landmark groups empty
    (2, 500, 32, 40, (500, 0, 77)),  # a bag with no valid key; m not a multiple of 16
    (8, 10241, 64, 256, (5121,)),  # ragged at batch 1: K1's splits past 5,121 hold no valid key
])
def test_kernels_take_edge_cases_on_the_card(hopper, h, n, dh, m, lengths):
    """K1 and K2 against their plain versions with NaN in q, k and v at
    every masked token (never read), at the tolerances of ``_check_passes``;
    a bag with no valid key gives attn3v 0, m3 −1e30, s3 0, and out and cls 0."""
    gen = torch.Generator(device=hopper).manual_seed(6)
    b = len(lengths)
    mask = torch.arange(n, device=hopper)[None] < torch.tensor(lengths, device=hopper)[:, None]
    q, k, v = (torch.where(mask[:, None, :, None], torch.randn(b, h, n, dh, device=hopper, generator=gen),
                           float("nan")) for _ in range(3))
    q = q * dh ** -0.5
    (attn3v, m3, s3), (out, cls), lm_mask = _check_passes(hopper, q, k, v, mask, m)
    assert not lm_mask.all()
    for i, n_valid in enumerate(lengths):
        if n_valid == 0:
            assert torch.all(attn3v[i] == 0) and torch.all(m3[i] == -1e30) and torch.all(s3[i] == 0)
            assert torch.all(out[i] == 0) and torch.all(cls[i] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,dh,m,ragged", [(2, 4, 1000, 48, 64, True), (2, 4, 1000, 128, 64, True),
                                               (1, 8, 300, 96, 32, False), (1, 4, 10241, 128, 256, False),
                                               (2, 4, 1000, 160, 64, True), (2, 2, 1000, 256, 256, True),
                                               (1, 2, 10241, 256, 256, False)])
def test_kernels_take_any_head_dim_on_the_card(hopper, b, h, n, dh, m, ragged):
    """K1 and K2 at head dims they are not built for (48, 96 and 160,
    zero-padded to 64, 128 and 256) and at the DH-128 and DH-256
    instantiations (two column halves), up to the flagship's batch-1 shape,
    against their plain versions at the tolerances of ``_check_passes``;
    out keeps its head dim."""
    gen = torch.Generator(device=hopper).manual_seed(7)
    q, k, v = (torch.randn(b, h, n, dh, device=hopper, generator=gen) for _ in range(3))
    q = q * dh ** -0.5
    lengths = torch.tensor([n * 2 // 3 if ragged else n, n][:b], device=hopper)
    mask = torch.arange(n, device=hopper)[None] < lengths[:, None]
    (attn3v, _, _), (out, _), _ = _check_passes(hopper, q, k, v, mask, m)
    assert attn3v.shape[-1] == out.shape[-1] == dh


@pytest.mark.cuda
def test_head_dims_above_128_raise_on_the_card(hopper):
    """A head dim past the largest instantiation (257 since DH 256 was
    added; 129 before) raises a ValueError naming the range before any
    launch."""
    q = torch.randn(1, 1, 64, 257, device=hopper)
    mask = torch.ones(1, 64, dtype=torch.bool, device=hopper)
    before = fn.pass_a.launches
    with pytest.raises(ValueError, match="head dims 1 to 256"):
        fn.flash_nystrom_infer(q, q, q, mask, 8)
    assert fn.pass_a.launches == before


def _k2b_operands(dev, b, h, n, dh, m, lengths, seed):
    """K2's operands from the plain glue, q and k as strided views of one
    qkv projection with NaN at masked tokens, d_out as a [B,H,N,dh] view of
    [B,N,H,dh] storage with NaN at masked tokens, d_cls with NaN there."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.arange(n, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]
    tok = mask[:, :, None]
    qkv = torch.where(tok, torch.randn(b, n, 3 * h * dh, device=dev, generator=gen), float("nan"))
    q, k, v = (qkv[..., i * h * dh:(i + 1) * h * dh].view(b, n, h, dh).transpose(1, 2) for i in range(3))
    q = q * dh ** -0.5
    q_l, k_l, lm_mask, pinv = fn.landmarks(q, k, mask, m)
    attn3v, m3, s3 = fn.pass_a_plain(q_l, k, v, mask)
    mid, rp = fn.pass_b_operands(q, k_l, mask, lm_mask, pinv, attn3v, s3)
    d_out = torch.where(tok[..., None], torch.randn(b, n, h, dh, device=dev, generator=gen),
                        float("nan")).transpose(1, 2)
    d_cls = torch.where(mask[:, None], torch.randn(b, h, n, device=dev, generator=gen), float("nan"))
    return (q, k, mask, k_l, lm_mask, mid, q_l, rp, m3), d_out, d_cls


BACKWARD_LAYOUTS = [
    (4, 8, 1027, 64, 256, (1027, 943, 717, 846)),  # the student's shape
    (3, 2, 300, 16, 8, (300, 150, 0)),  # DH 16, m 8; empty landmark groups; a bag with no valid token
    (2, 2, 333, 32, 24, (333, 0)),  # DH 32; N and m not multiples of the 32-row step; a bag with no valid token
    (2, 3, 95, 64, 40, (95, 17)),  # DH 64; N and m not multiples of 32 and 64
    (2, 4, 500, 128, 40, (500, 77)),  # DH 128 (2 × 2 warps, 16-row steps); m not a multiple of 16
    (3, 4, 257, 128, 48, (257, 0, 100)),  # DH 128, a bag with no valid token
    (2, 2, 200, 24, 16, (200, 131)),  # a padded head dim
    (2, 2, 500, 160, 40, (500, 77)),  # padded to DH 256 (2 × 4 warps)
    (2, 2, 1027, 256, 256, (1027, 0)),  # DH 256 at the student's m, a bag with no valid token
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,dh,m,lengths", BACKWARD_LAYOUTS)
@pytest.mark.parametrize("with_cls", [False, True])
def test_pass_b_backward_matches_its_plain_version_on_the_card(hopper, b, h, n, dh, m, lengths, with_cls):
    """K2b against pass_b_backward_plain on the same card inputs, NaN at
    every masked q, k, d_out and d_cls entry (never read): each gradient at
    max|d| <= 1e-4·max|ref| (3×TF32 products against fp32 ones, sums over up
    to a thousand tokens), zero at masked tokens; one launch counted; two
    launches give the same bits (no float atomics). Without the cls term it
    is handed K2's out, as PassB hands it; with it the wrapper runs K2 for
    out itself."""
    args, d_out, d_cls = _k2b_operands(hopper, b, h, n, dh, m, lengths, 8)
    cls = d_cls if with_cls else None
    kw = {} if with_cls else {"out": fn.pass_b(*args)[0]}
    want = fn.pass_b_backward_plain(*args, d_out, cls)
    before = fn.pass_b_backward.launches
    got = fn.pass_b_backward(*args, d_out, cls, **kw)
    again = fn.pass_b_backward(*args, d_out, cls, **kw)
    torch.cuda.synchronize()
    assert fn.pass_b_backward.launches == before + 2
    for name, g, w, g2 in zip(("d_q", "d_k", "d_kl", "d_mid", "d_ql", "d_rp", "d_m3"), got, want, again):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        assert torch.isfinite(g).all(), name
        assert (g - w).abs().max() <= 1e-4 * w.abs().max(), (name, (g - w).abs().max(), w.abs().max())
        assert torch.equal(g, g2), name
    for g in (got[0], got[1]):
        if g is not None:
            assert torch.all(torch.where(args[2][:, None, :, None], 0.0, g) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,dh,m,lengths", BACKWARD_LAYOUTS)
@pytest.mark.parametrize("with_s3", [False, True])
def test_pass_a_backward_matches_its_plain_version_on_the_card(hopper, b, h, n, dh, m, lengths, with_s3):
    """K1b against pass_a_backward_plain on K1's operands from the plain
    glue, k and v as strided views with NaN at every masked key (never
    read), random cotangents of attn3v and s3: each gradient at max|d| <=
    1e-4·max|ref| (3×TF32 products against fp32 ones, as K2b's test), zero
    at masked keys; one launch counted; two launches give the same bits."""
    (q, k, mask, _, _, _, q_l, _, _), _, _ = _k2b_operands(hopper, b, h, n, dh, m, lengths, 10)
    v = torch.where(mask[:, None, :, None], torch.randn_like(k), float("nan"))
    attn3v, m3, s3 = fn.pass_a_plain(q_l, k, v, mask)
    gen = torch.Generator(device=hopper).manual_seed(11)
    d_attn3v = torch.randn(b, h, m, dh, device=hopper, generator=gen)
    d_s3 = torch.randn(b, h, m, device=hopper, generator=gen) if with_s3 else None
    args = (q_l, k, v, mask, attn3v, m3, s3, d_attn3v, d_s3)
    want = fn.pass_a_backward_plain(*args)
    before = fn.pass_a_backward.launches
    got, again = fn.pass_a_backward(*args), fn.pass_a_backward(*args)
    torch.cuda.synchronize()
    assert fn.pass_a_backward.launches == before + 2
    for name, g, w, g2 in zip(("d_ql", "d_k", "d_v"), got, want, again):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert (g - w).abs().max() <= 1e-4 * w.abs().max(), (name, (g - w).abs().max(), w.abs().max())
        assert torch.equal(g, g2), name
    for g in got[1:]:
        assert torch.all(torch.where(mask[:, None, :, None], 0.0, g) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype", [(4, 1000, 512, torch.float32), (3, 100, 32, torch.float32),
                                         (2, 333, 100, torch.bfloat16),
                                         (3, 500, 1536, torch.float32), (3, 500, 1536, torch.bfloat16)])
def test_abmil_pool_matches_its_plain_version_on_the_card(hopper, b, n, d, dtype):
    """K4 against abmil_pool_plain: ragged bags, a fake bag (pooled and attn
    zero, nothing NaN) and garbage at masked instances; rtol 1e-5 atol 1e-5,
    attn atol 1e-6, as the JAX package's kernel test holds its kernel. Widths
    above 1,024 run as column groups in one call."""
    gen = torch.Generator(device=hopper).manual_seed(1)
    x = torch.randn(b, n, d, device=hopper, generator=gen).to(dtype)
    logits = 3 * torch.randn(b, n, device=hopper, generator=gen)
    lengths = torch.tensor([n, n // 2 + 1, 0, n - 7][:b], device=hopper)
    mask = torch.arange(n, device=hopper)[None] < lengths[:, None]
    x = torch.where(mask[..., None], x, torch.tensor(float("nan"), dtype=dtype, device=hopper))
    before = abmil_pool.fused_abmil_pool.launches
    pooled, attn = abmil_pool.fused_abmil_pool(x, logits, mask)
    torch.cuda.synchronize()
    assert abmil_pool.fused_abmil_pool.launches == before + 1
    want_pooled, want_attn = abmil_pool.abmil_pool_plain(x, logits, mask)
    torch.testing.assert_close(pooled, want_pooled, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(attn, want_attn, rtol=1e-5, atol=1e-6)
    if b > 2:
        assert torch.all(pooled[2] == 0) and torch.all(attn[2] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,dtype", [(4, 10240, 512, torch.float32), (4, 10240, 512, torch.bfloat16),
                                         (1, 10240, 512, torch.float32), (2, 333, 100, torch.bfloat16)])
def test_abmil_pool_is_one_launch(hopper, b, n, d, dtype):
    """K4 at D <= 1,024 is one CUDA launch a call: the profiler's device
    records of 5 calls after a warm-up are all K4's kernel, at most 5 of
    them (the profiler drops a record now and then); and two calls give the
    same bits (the last block of a bag merges the chunks in a fixed order)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=hopper).manual_seed(3)
    x = torch.randn(b, n, d, device=hopper, generator=gen).to(dtype)
    logits = 3 * torch.randn(b, n, device=hopper, generator=gen)
    mask = torch.arange(n, device=hopper)[None] < torch.tensor([n, n // 2, n - 5, 7][:b], device=hopper)[:, None]
    first = abmil_pool.fused_abmil_pool(x, logits, mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            again = abmil_pool.fused_abmil_pool(x, logits, mask)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(names) <= 5 and all("abmil_pool_kernel" in name for name in names), names
    for g, w in zip(first, again):
        assert torch.equal(g, w)


def _attn2(dev, b, h, n, dh, m, lengths, seed):
    """The glue's attn2 = softmax(q_l·k_lᵀ) over the valid landmarks, from
    random q, k of ragged bags (empty landmark groups where a bag is short)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn(b, h, n, dh, device=dev, generator=gen) for _ in range(2))
    mask = torch.arange(n, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]
    mv = mask[:, None, :, None]
    q_l, lm_mask = _landmark_mean(torch.where(mv, q * dh ** -0.5, 0.0), mask, m)
    k_l, _ = _landmark_mean(torch.where(mv, k, 0.0), mask, m)
    return masked_softmax(q_l @ k_l.transpose(-1, -2), lm_mask[:, None, None, :])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 40, 30])
@pytest.mark.parametrize("tile", npv.TILES)
def test_pinv_product_matches_its_plain_version_on_the_card(hopper, monkeypatch, m, tile):
    """Each product K3p runs (every transpose, diagonal and accumulate of
    the iterations and their reverse sweep) at each tile the kernel is built
    for, against pinv_product_plain in fp64 on the same fp32 inputs: max|d|
    <= 1e-5·max|ref| (3×TF32: about 2^-20 of each term); m 40 leaves partial
    tiles, m 30 is padded to 32 as pseudo_inverse pads it."""
    monkeypatch.setattr(npv, "pinv_plan", lambda g, mm, sms=0: tile)
    gen = torch.Generator(device=hopper).manual_seed(m)
    mp = m + (-m % 4)
    a, b_, c = (torch.nn.functional.pad(torch.randn(6, m, m, device=hopper, generator=gen), (0, mp - m, 0, mp - m))
                for _ in range(3))
    for kw in ({}, {"alpha": -1.0, "diag": -7.0}, {"alpha": -0.25, "diag": -13.0, "tb": True},
               {"alpha": -0.25, "ta": True}, {"alpha": -1.0, "diag": -7.0, "tb": True, "beta": 1.0},
               {"ta": True, "beta": 1.0}, {"tb": True}):
        cc = c if kw.get("beta") else None
        got = npv.pinv_product(a, b_, c=cc, **kw)
        torch.cuda.synchronize()
        want = npv.pinv_product_plain(a.double(), b_.double(), c=None if cc is None else cc.double(), **kw)
        assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max(), kw
        assert torch.all(got[:, m:] == 0) and torch.all(got[:, :, m:] == 0)
    out = c.clone()
    got = npv.pinv_product(a, b_, tb=True, c=out, beta=1.0, out=out)  # accumulate in place
    want = npv.pinv_product_plain(a.double(), b_.double(), tb=True, c=c.double(), beta=1.0)
    assert got.data_ptr() == out.data_ptr() and (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,m,lengths", [(1, 8, 256, (1027,)), (4, 8, 256, (1027, 943, 300, 846)),
                                           (2, 4, 40, (300, 90)), (4, 8, 40, (300, 30, 299, 150))])
def test_pseudo_inverse_matches_moore_penrose_pinv_on_the_card(hopper, b, h, m, lengths):
    """K3p's pseudo_inverse against moore_penrose_pinv at G = B·H of 8 and
    32, m 256 and 40, on attn2 of ragged bags (empty landmark groups):
    forward max|d| <= 1e-4·max|ref| against fp32, the VJP (through the
    initial scale too) at max|d| <= 1e-4·max|ref| against fp32 autograd and
    by kernel_check's VJP criterion against fp64 with fp32's ties in the
    scale's maxes (``pinv_reference64``); 24 launches forward and 48
    backward."""
    x = _attn2(hopper, b, h, 1027 if m == 256 else 300, 64, m, lengths, seed=m + b)
    gen = torch.Generator(device=hopper).manual_seed(11)
    cot = torch.randn(b, h, m, m, device=hopper, generator=gen)

    def run(f, dtype=torch.float32):
        xx = x.to(dtype).requires_grad_()
        z = f(xx)
        return z.detach(), torch.autograd.grad(z, xx, cot.to(dtype))[0]

    before = npv.pinv_product.launches
    z, dx = run(npv.pseudo_inverse)
    torch.cuda.synchronize()
    assert npv.pinv_product.launches == before + 24 + 48
    z32, dx32 = run(moore_penrose_pinv)
    z64, dx64 = run(lambda xx: pinv_reference64(xx, x), torch.float64)
    assert (z - z32).abs().max() <= 1e-4 * z32.abs().max()
    assert (dx - dx32).abs().max() <= 1e-4 * dx32.abs().max()
    assert vjp_close(dx, dx64)["ok"], vjp_close(dx, dx64)
    assert vjp_close(dx32, dx64)["ok"], vjp_close(dx32, dx64)


@pytest.mark.cuda
def test_flash_nystrom_gradients_on_the_card(hopper):
    """K3 (forward K1 + K2, backward K2b, the glue's autograd and K1b)
    against autograd through the plain nystrom_attention, at a student-like
    ragged shape: out, attn and the q/k/v gradients at rtol 1e-4 atol 1e-5
    against the fp32 plain path; besides, the gradients of K3 and of the
    fp32 plain path each by kernel_check's VJP criterion against the plain
    path in fp64. K1b and K2b launched once each."""
    gen = torch.Generator(device=hopper).manual_seed(2)
    b, h, n, dh, m = 2, 4, 300, 64, 32
    q, k, v = (torch.randn(b, h, n, dh, device=hopper, generator=gen) for _ in range(3))
    q = q * dh ** -0.5
    mask = torch.arange(n, device=hopper)[None] < torch.tensor([[n], [200]], device=hopper)
    co = torch.randn(b, h, n, dh, device=hopper, generator=gen)
    ca = torch.randn(b, h, n, device=hopper, generator=gen)

    def run(f, dtype=torch.float32):
        qq, kk, vv = (t.to(dtype, copy=True).requires_grad_() for t in (q, k, v))
        out, attn = f(qq, kk, vv)
        ((out * co.to(dtype)).sum() + (attn * ca.to(dtype)).sum()).backward()
        return out.detach(), attn.detach(), qq.grad, kk.grad, vv.grad

    calls = (fn.flash_nystrom.forward_calls, fn.flash_nystrom.backward_calls, fn.pass_a_backward.launches,
             fn.pass_b_backward.launches)
    got = run(lambda *t: fn.flash_nystrom(*t, mask, m))
    assert (fn.flash_nystrom.forward_calls, fn.flash_nystrom.backward_calls, fn.pass_a_backward.launches,
            fn.pass_b_backward.launches) == tuple(c + 1 for c in calls)
    plain = lambda *t: nystrom_attention(*t, mask, m, return_attn=True)
    want = run(plain)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    for g, g32, w in zip(got[2:], want[2:], run(plain, torch.float64)[2:]):
        for x in (g, g32):
            assert vjp_close(x, w)["ok"], vjp_close(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,use_attn", [(48, True), (128, False), (200, True), (200, False)])
def test_flash_nystrom_gradients_at_other_head_dims_on_the_card(hopper, dh, use_attn):
    """K3 at a padded head dim (48), at DH 128 and at dh 200 (padded to
    256: two column halves), attn used and unused, against autograd through
    the plain attention: out at rtol 1e-4 atol 1e-5, gradients at max|d| <=
    1e-4·max|ref|."""
    gen = torch.Generator(device=hopper).manual_seed(9)
    b, h, n, m = 2, 4, 300, 32
    q, k, v, co = (torch.randn(b, h, n, dh, device=hopper, generator=gen) for _ in range(4))
    q = q * dh ** -0.5
    ca = torch.randn(b, h, n, device=hopper, generator=gen)
    mask = torch.arange(n, device=hopper)[None] < torch.tensor([[n], [171]], device=hopper)

    def run(f):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out, attn = f(qq, kk, vv)
        total = (out * co).sum() + ((attn * ca).sum() if use_attn else 0.0)
        return (out.detach(), *torch.autograd.grad(total, (qq, kk, vv)))

    got = run(lambda *t: fn.flash_nystrom(*t, mask, m))
    want = run(lambda *t: nystrom_attention(*t, mask, m, return_attn=True))
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1:], want[1:]):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


@pytest.mark.cuda
def test_flash_nystrom_infer_refuses_to_drop_the_graph(hopper):
    """The kernels' outputs carry no graph: under grad, with q/k/v that need
    one, the no-grad entry raises instead of cutting the gradient silently."""
    q, k, v = (torch.randn(1, 2, 40, 32, device=hopper, requires_grad=True) for _ in range(3))
    mask = torch.ones(1, 40, dtype=torch.bool, device=hopper)
    with pytest.raises(RuntimeError, match="no gradient"):
        fn.flash_nystrom_infer(q, k, v, mask, 8)
    with torch.no_grad():
        fn.flash_nystrom_infer(q, k, v, mask, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,h,w,ed,n,dtype", [
    (2, 6, 8, 8, 4, torch.float32),  # test_pallas_scan2d.py's shape
    (1, 5, 11, 64, 16, torch.float32),  # ragged: one warp, 11 columns
    (2, 9, 102, 64, 16, torch.float32),  # the serving raster width
    (1, 4, 700, 16, 16, torch.float32),  # two column chunks with the carried prefix
    (2, 7, 381, 32, 16, torch.bfloat16),  # the BLCA width, bf16 read in registers
])
def test_scan2d_matches_its_plain_version_on_the_card(hopper, bs, h, w, ed, n, dtype):
    """K5 against scan2d_plain on the same card inputs (Δ = 0.1·softplus(normal),
    A_log = log(1..N), as pallas_hw_check.py draws them), rtol 1e-4 atol 1e-5;
    B and C as strided slices of one x_proj-like output."""
    gen = torch.Generator(device=hopper).manual_seed(3)
    x = torch.randn(bs, h, w, ed, device=hopper, generator=gen).to(dtype)
    delta = (0.1 * torch.nn.functional.softplus(torch.randn(bs, h, w, ed, device=hopper, generator=gen))).to(dtype)
    bc = torch.randn(bs, h, w, 3 + 2 * n, device=hopper, generator=gen).to(dtype)
    B, C = bc[..., 3:3 + n], bc[..., 3 + n:]
    a_log = torch.log(torch.arange(1, n + 1, device=hopper, dtype=torch.float32)).expand(ed, n)
    D = torch.randn(ed, device=hopper, generator=gen)
    before = scan2d.selective_scan_2d_fused.launches
    got = scan2d.selective_scan_2d_fused(x, delta, a_log, B, C, D)
    torch.cuda.synchronize()
    assert scan2d.selective_scan_2d_fused.launches == before + 1
    torch.testing.assert_close(got, scan2d.scan2d_plain(x, delta, a_log, B, C, D), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(12, torch.float32), (32, torch.float32), (3, torch.bfloat16),
                                     (20, torch.bfloat16)])
def test_scan2d_takes_any_state_size(hopper, n, dtype):
    """K5 at state sizes it is not built for (padded with zero B and C
    columns; above 16 in groups of 16) against scan2d_plain, rtol 1e-4 atol
    1e-5, at the serving raster width; B and C as strided slices of one
    x_proj-like output; one call counted."""
    gen = torch.Generator(device=hopper).manual_seed(10)
    bs, h, w, ed = 2, 9, 102, 64
    x = torch.randn(bs, h, w, ed, device=hopper, generator=gen).to(dtype)
    delta = (0.1 * torch.nn.functional.softplus(torch.randn(bs, h, w, ed, device=hopper, generator=gen))).to(dtype)
    bc = torch.randn(bs, h, w, 3 + 2 * n, device=hopper, generator=gen).to(dtype)
    B, C = bc[..., 3:3 + n], bc[..., 3 + n:]
    a_log = torch.log(torch.arange(1, n + 1, device=hopper, dtype=torch.float32)).expand(ed, n)
    D = torch.randn(ed, device=hopper, generator=gen)
    before = scan2d.selective_scan_2d_fused.launches
    got = scan2d.selective_scan_2d_fused(x, delta, a_log, B, C, D)
    torch.cuda.synchronize()
    assert scan2d.selective_scan_2d_fused.launches == before + 1
    torch.testing.assert_close(got, scan2d.scan2d_plain(x, delta, a_log, B, C, D), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("w,n", [(1500, 16), (2100, 16), (4200, 16), (1500, 4)])
def test_scan2d_takes_wide_rows(hopper, w, n):
    """Rows wider than 1,024 columns against scan2d_plain, rtol 1e-4 atol
    1e-5: the h beyond the first two chunks in shared memory (1,500 and
    2,100 columns) or, past what a block's shared memory holds at N = 16, in
    the wrapper's global scratch (4,200)."""
    gen = torch.Generator(device=hopper).manual_seed(4)
    bs, h, ed = 2, 5, 8
    x = torch.randn(bs, h, w, ed, device=hopper, generator=gen)
    delta = 0.1 * torch.nn.functional.softplus(torch.randn(bs, h, w, ed, device=hopper, generator=gen))
    B, C = (torch.randn(bs, h, w, n, device=hopper, generator=gen) for _ in range(2))
    a_log = torch.log(torch.arange(1, n + 1, device=hopper, dtype=torch.float32)).expand(ed, n)
    D = torch.randn(ed, device=hopper, generator=gen)
    before = scan2d.selective_scan_2d_fused.launches
    got = scan2d.selective_scan_2d_fused(x, delta, a_log, B, C, D)
    torch.cuda.synchronize()
    assert scan2d.selective_scan_2d_fused.launches == before + 1
    torch.testing.assert_close(got, scan2d.scan2d_plain(x, delta, a_log, B, C, D), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_scan2d_refuses_grad_and_wide_rows(hopper):
    """K5 has no gradient; a row of 1,025 columns, one past the wide
    kernel's register chunks (run by the cluster kernel since it holds rows
    up to 1,152 columns), matches the plain scan."""
    x = torch.randn(1, 2, 8, 16, device=hopper, requires_grad=True)
    delta = torch.full_like(x, 0.05).detach()
    bc = torch.randn(1, 2, 8, 4, device=hopper)
    a_log, D = torch.zeros(16, 4, device=hopper), torch.ones(16, device=hopper)
    with pytest.raises(RuntimeError, match="no gradient"):
        scan2d.selective_scan_2d_fused(x, delta, a_log, bc, bc, D)
    wide = torch.randn(1, 1, 1025, 16, device=hopper)
    got = scan2d.selective_scan_2d_fused(wide, 0.1 * wide.abs(), a_log, wide[..., :4], wide[..., 4:8], D)
    torch.testing.assert_close(got, scan2d.scan2d_plain(wide, 0.1 * wide.abs(), a_log, wide[..., :4],
                                                        wide[..., 4:8], D), rtol=RTOL, atol=ATOL)


def _scan_operands(dev, seed, bs, h, w, ed, n, dtype):
    """K5's operands as the card tests draw them: Δ = 0.1·softplus(normal),
    A_log = log(1..N) plus a channel term, B and C at offsets 3 and 3 + N of
    one ``[.., 3 + 2N]`` projection (not 16-byte aligned)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(bs, h, w, ed, device=dev, generator=gen).to(dtype)
    delta = (0.1 * torch.nn.functional.softplus(torch.randn(bs, h, w, ed, device=dev, generator=gen))).to(dtype)
    bc = torch.randn(bs, h, w, 3 + 2 * n, device=dev, generator=gen).to(dtype)
    a_log = (torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32))
             + 0.01 * torch.arange(ed, device=dev, dtype=torch.float32)[:, None])
    D = torch.randn(ed, device=dev, generator=gen)
    return x, delta, a_log, bc[..., 3:3 + n], bc[..., 3 + n:], D


@pytest.mark.cuda
@pytest.mark.parametrize("bs,h,w,ed,n,dtype", [
    (1, 4, 383, 8, 16, torch.float32),  # the BLCA layout (S 8 x 16 runs of 3): one column short
    (1, 4, 384, 8, 16, torch.float32),  # exactly S·P·R
    (1, 4, 385, 8, 16, torch.float32),  # one past: 4 channels a block, 5 blocks of 32 runs
    (1, 3, 119, 16, 16, torch.bfloat16),  # the bf16 serving layout (S 5 x 8 runs of 3): one short
    (1, 3, 120, 16, 16, torch.bfloat16),
    (1, 3, 121, 16, 16, torch.bfloat16),
    (3, 5, 50, 12, 16, torch.float32),  # ED not a multiple of G; Bs 3
    (3, 5, 50, 20, 16, torch.bfloat16),
    (2, 6, 200, 16, 2, torch.float32),  # N 2, 4, 8
    (2, 6, 200, 16, 4, torch.bfloat16),
    (2, 6, 200, 16, 8, torch.float32),
    (1, 3, 700, 16, 16, torch.bfloat16),  # 4 channels a block
    (1, 3, 768, 6, 16, torch.float32),  # the widest row of 128-thread blocks
    (1, 3, 769, 8, 16, torch.float32),  # one past: 4 channels in 6 blocks of 192 threads
    (2, 3, 1000, 12, 16, torch.bfloat16),
    (1, 3, 1024, 8, 8, torch.float32),
    (1, 3, 1152, 4, 16, torch.float32),  # the widest row a cluster holds (S 8 x 48 runs of 3)
    (1, 3, 1153, 8, 16, torch.float32),  # one past: the wide kernel
])
def test_scan2d_cluster_layouts_match_the_plain_version(hopper, bs, h, w, ed, n, dtype):
    """The cluster kernel against scan2d_plain, rtol 1e-4 atol 1e-5, at the
    edges of its layouts (``scan_plan``): a row one column short of, exactly
    at and one past S·P·R columns, ED not a multiple of G, Bs 3, state sizes
    2 to 16, fp32 and bf16, B and C at an unaligned offset; in 192-thread
    blocks past 768 columns; and at the widest row it holds and the first it
    does not."""
    plan = scan2d.scan_plan(w, n, torch.empty((), dtype=dtype).element_size())
    assert (plan is None) == (w == 1153)
    ops = _scan_operands(hopper, w + n, bs, h, w, ed, n, dtype)
    before = scan2d.selective_scan_2d_fused.launches
    got = scan2d.selective_scan_2d_fused(*ops)
    torch.cuda.synchronize()
    assert scan2d.selective_scan_2d_fused.launches == before + 1
    torch.testing.assert_close(got, scan2d.scan2d_plain(*ops), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,h,w,dtype", [(1, 275, 381, torch.float32), (4, 101, 102, torch.bfloat16)])
def test_scan2d_is_deterministic(hopper, bs, h, w, dtype):
    """Two launches of K5 at the BLCA grid (fp32) and the serving grid (bf16),
    ED 256, N 16, give y equal to the bit."""
    ops = _scan_operands(hopper, 11, bs, h, w, 256, 16, dtype)
    first = scan2d.selective_scan_2d_fused(*ops)
    second = scan2d.selective_scan_2d_fused(*ops)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_scan2d_refuses_a_bad_layout(hopper):
    """A layout the C entry does not take (a cluster of 9 blocks, a block of
    more than 128 threads of 8 channels or 192 of 4, a block left empty, a
    group it is not built for) is refused at launch, and the wrapper's check
    raises on it; nothing falls back."""
    from mhim_mil_torch.kernels import load_library
    from mhim_mil_torch.kernels.launch import raise_on

    x, delta, a_log, B, C, D = _scan_operands(hopper, 12, 1, 2, 381, 16, 16, torch.float32)
    y = torch.empty(x.shape, device=hopper)
    lib = load_library("scan2d")
    stream = torch.cuda.current_stream(hopper).cuda_stream
    for g, s, p in ((8, 9, 16), (8, 1, 128), (4, 2, 64), (8, 8, 20), (16, 8, 16)):
        err = lib.scan2d(x.data_ptr(), delta.data_ptr(), B.data_ptr(), B.stride(2), C.data_ptr(), C.stride(2), 0,
                         a_log.data_ptr(), D.data_ptr(), y.data_ptr(), None, 1, 2, 381, 16, 16, g, s, p, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            raise_on(err, "scan2d")


@pytest.mark.cuda
def test_probe_matches_its_plain_version_on_the_card(hopper):
    """K6 against probe_plain, exactly: on the gate's ones(8, 128) and on
    random values of an odd length; CPU tensors are refused."""
    gen = torch.Generator(device=hopper).manual_seed(5)
    for x in (torch.ones(8, 128, device=hopper), torch.randn(1001, device=hopper, generator=gen)):
        before = probe.probe.launches
        got = probe.probe(x)
        torch.cuda.synchronize()
        assert probe.probe.launches == before + 1
        assert torch.equal(got, probe.probe_plain(x))
    with pytest.raises(ValueError, match="on the card"):
        probe.probe(torch.ones(8, 128))


@pytest.mark.cuda
def test_kernel_check_small_passes_on_the_card(hopper):
    """``python3 -m mhim_mil_torch.utils.kernel_check --small`` exits 0 with
    every check PASS."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "mhim_mil_torch.utils.kernel_check", "--small"],
                         cwd=repo, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert '"ok": true' in res.stdout.splitlines()[-1]
