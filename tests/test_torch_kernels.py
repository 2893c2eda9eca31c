"""K1-K6 against their plain versions on a Hopper card, and the kernel check.

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
from mhim_mil_torch.ops.nystrom import nystrom_attention

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
@pytest.mark.parametrize("b,n,d,dtype", [(4, 1000, 512, torch.float32), (3, 100, 32, torch.float32),
                                         (2, 333, 100, torch.bfloat16)])
def test_abmil_pool_matches_its_plain_version_on_the_card(hopper, b, n, d, dtype):
    """K4 against abmil_pool_plain: ragged bags, a fake bag (pooled and attn
    zero, nothing NaN) and garbage at masked instances; rtol 1e-5 atol 1e-5,
    attn atol 1e-6, as the JAX package's kernel test holds its kernel."""
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
def test_flash_nystrom_gradients_on_the_card(hopper):
    """K3 (forward K1 + K2, backward by recompute) against autograd through
    the plain nystrom_attention, at a student-like ragged shape: out and attn
    at rtol 1e-4 atol 1e-5, q/k/v gradients at rtol 1e-4 atol 1e-5."""
    gen = torch.Generator(device=hopper).manual_seed(2)
    b, h, n, dh, m = 2, 4, 300, 64, 32
    q, k, v = (torch.randn(b, h, n, dh, device=hopper, generator=gen) for _ in range(3))
    q = q * dh ** -0.5
    mask = torch.arange(n, device=hopper)[None] < torch.tensor([[n], [200]], device=hopper)
    co = torch.randn(b, h, n, dh, device=hopper, generator=gen)
    ca = torch.randn(b, h, n, device=hopper, generator=gen)

    def run(fn):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out, attn = fn(qq, kk, vv)
        ((out * co).sum() + (attn * ca).sum()).backward()
        return out.detach(), attn.detach(), qq.grad, kk.grad, vv.grad

    calls = (fn.FlashNystrom.forward_calls, fn.FlashNystrom.backward_calls)
    got = run(lambda *t: fn.flash_nystrom(*t, mask, m))
    assert (fn.FlashNystrom.forward_calls, fn.FlashNystrom.backward_calls) == (calls[0] + 1, calls[1] + 1)
    want = run(lambda *t: nystrom_attention(*t, mask, m, return_attn=True))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


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
    """K5 has no gradient; a row of 1,025 columns, one past the register
    chunks, goes through the wide path and matches the plain scan."""
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
