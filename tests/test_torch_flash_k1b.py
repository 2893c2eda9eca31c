"""K1b, the backward of K1's pass, K3's backward through K1b and K2b, head
dims up to 256, and the kernel gate's VJP criterion, on the CPU.

- ``pass_a_backward_plain`` (K1b's function, the formulas the kernels
  compute) against autograd through ``pass_a_plain`` under ``d_attn3v`` and
  ``d_s3``, on ragged bags, a bag with no valid key, N not a multiple of 32
  and m 8, in fp64 (rtol 1e-9, atol 1e-11: the derivation, not fp32's
  rounding, is under test); NaN at masked keys is never read.
- The fold of ``s3``'s cotangent into ``D`` and the dropped ``m3``
  cotangent, held against autograd of the whole composition in fp64.
- K3 never calls the plain ``nystrom_attention`` in its backward.
- K3's VJP against the JAX package at head dims 160 and 200, through the
  wrappers' padding to 256; dh 257 raises.
- ``vjp_close`` at ``kernel_check``'s full shape: it passes the fp32
  reference and K3 on the plain formulas, and fails four mutations.
"""

import numpy as np
import pytest
import torch

import mhim_mil_torch.ops.nystrom as nystrom_mod
from mhim_mil_torch.ops import flash_nystrom as fn
from mhim_mil_torch.utils.kernel_check import vjp_close
from test_torch_flash_backward import _vjp_jax
from test_torch_flash_passes import _tf32
from test_torch_shapes import nystrom_card_branch  # noqa: F401 (a fixture)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _k1_operands(seed, lengths, n, dh, m, h=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    ql = _t(rng.normal(size=(b, h, m, dh)).astype(dtype)) * dh ** -0.5
    k, v = (_t(rng.normal(size=(b, h, n, dh)).astype(dtype)) for _ in range(2))
    mask = _t(np.arange(n)[None] < np.array(lengths)[:, None])
    d_attn3v = _t(rng.normal(size=(b, h, m, dh)).astype(dtype))
    d_s3 = _t(rng.normal(size=(b, h, m)).astype(dtype))
    return ql, k, v, mask, d_attn3v, d_s3


@pytest.mark.parametrize("lengths,n,m", [
    ((100, 37), 100, 16),  # ragged, N not a multiple of 32
    ((64, 64), 64, 8),  # full bags, m = 8
    ((90, 0, 45), 90, 8),  # a bag with no valid key
])
@pytest.mark.parametrize("with_s3", [False, True])
def test_pass_a_backward_plain_matches_autograd(lengths, n, m, with_s3):
    """K1b's function against autograd through pass_a_plain in fp64, rtol
    1e-9 atol 1e-11. m3 is a constant of K1b's function: autograd reaches it through
    amax, and its cotangent there is set to s3·d_s3, the one the composition
    gives it (the shift invariance of m3 and s3), so that the amax path adds
    nothing. A bag with no valid key gives zero gradients (autograd is NaN
    there: exp(+1e30) before the mask)."""
    ql, k, v, mask, d_attn3v, d_s3 = _k1_operands(n + m, lengths, n, 16, m, dtype=np.float64)
    leaves = [t.clone().requires_grad_() for t in (ql, k, v)]
    attn3v, m3, s3 = fn.pass_a_plain(*leaves, mask)
    loss = (attn3v * d_attn3v).sum()
    if with_s3:
        loss = loss + (s3 * d_s3).sum() + (m3 * (s3 * d_s3).detach()).sum()
    want = torch.autograd.grad(loss, leaves)
    got = fn.pass_a_backward_plain(ql, k, v, mask, attn3v.detach(), m3.detach(), s3.detach(), d_attn3v,
                                   d_s3 if with_s3 else None)
    full = torch.tensor([n_valid > 0 for n_valid in lengths])
    for name, g, w in zip(("d_ql", "d_k", "d_v"), got, want):
        torch.testing.assert_close(g[full], w[full], rtol=1e-9, atol=1e-11, msg=name)
        assert torch.all(g[~full] == 0), name
    for g in got[1:]:
        assert torch.all(torch.where(mask[:, None, :, None], 0.0, g) == 0)


def test_pass_a_backward_plain_ignores_values_at_masked_keys():
    """NaN in k and v at masked keys changes nothing."""
    ql, k, v, mask, d_attn3v, d_s3 = _k1_operands(3, (60, 23), 60, 16, 8)
    fwd = fn.pass_a_plain(ql, k, v, mask)
    want = fn.pass_a_backward_plain(ql, k, v, mask, *fwd, d_attn3v, d_s3)
    tok = mask[:, None, :, None]
    got = fn.pass_a_backward_plain(ql, *(torch.where(tok, t, float("nan")) for t in (k, v)), mask, *fwd,
                                   d_attn3v, d_s3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _plain_composition(q, k, v, mask, m):
    """landmarks -> K1 -> glue -> K2 on the plain versions, differentiated
    by autograd end to end (m3 through amax included)."""
    q_l, k_l, lm_mask, pinv = fn.landmarks(q, k, mask, m)
    attn3v, m3, s3 = fn.pass_a_plain(q_l, k, v, mask)
    mid, rp = fn.pass_b_operands(q, k_l, mask, lm_mask, pinv, attn3v, s3)
    return fn.pass_b_plain(q, k, mask, k_l, lm_mask, mid, q_l, rp, m3)


@pytest.mark.parametrize("use_attn", [True, False])
def test_k3_backward_folds_s3_and_drops_m3_in_fp64(use_attn):
    """K3's composition with K1b's and K2b's formulas as the backwards of K1
    and K2 (m3 without a gradient, s3's cotangent folded into D) against
    autograd of the whole plain composition, m3's path through amax
    included, all in fp64 on ragged bags with empty landmark groups: the
    q/k/v gradients agree to rtol 1e-9, atol 1e-11."""
    rng = np.random.default_rng(11)
    b, h, n, dh, m = 2, 2, 70, 16, 8
    q, k, v, co = (_t(rng.normal(size=(b, h, n, dh))) for _ in range(4))
    q = q * dh ** -0.5
    ca = _t(rng.normal(size=(b, h, n)))
    mask = _t(np.arange(n)[None] < np.array([70, 29])[:, None])

    def grads(f):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, attn = f(*leaves, mask, m)
        loss = (out * co).sum() + ((attn * ca).sum() if use_attn else 0.0)
        return torch.autograd.grad(loss, leaves)

    before = (fn.pass_a_backward.launches, fn.pass_b_backward.launches)
    got = grads(lambda *a: fn._nystrom_passes(*a, 6))
    assert (fn.pass_a_backward.launches, fn.pass_b_backward.launches) == before  # CPU: plain versions
    for name, g, w in zip(("dq", "dk", "dv"), got, grads(_plain_composition)):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-11, msg=name)


def test_k3_backward_never_calls_the_plain_attention(monkeypatch):
    """With ops.nystrom.nystrom_attention made to raise, K3's forward and
    backward still run, and each counts one call."""
    def refuse(*args, **kwargs):
        raise AssertionError("K3 called nystrom_attention")

    monkeypatch.setattr(nystrom_mod, "nystrom_attention", refuse)
    assert not hasattr(fn, "nystrom_attention")
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.normal(size=(2, 2, 50, 16)).astype(np.float32)).requires_grad_() for _ in range(3))
    mask = _t(np.arange(50)[None] < np.array([50, 31])[:, None])
    calls = (fn.flash_nystrom.forward_calls, fn.flash_nystrom.backward_calls)
    out, attn = fn.flash_nystrom(q, k, v, mask, 8)
    (out.sum() + attn.sum()).backward()
    assert (fn.flash_nystrom.forward_calls, fn.flash_nystrom.backward_calls) == (calls[0] + 1, calls[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_k3_backward_runs_twice_with_retain_graph():
    """K3's graph walked twice under retain_graph gives the same gradients
    twice, and each walk counts one backward call."""
    rng = np.random.default_rng(6)
    q, k, v = (_t(rng.normal(size=(2, 2, 50, 16)).astype(np.float32)).requires_grad_() for _ in range(3))
    mask = _t(np.arange(50)[None] < np.array([50, 31])[:, None])
    out, attn = fn.flash_nystrom(q, k, v, mask, 8)
    loss = out.square().sum() + attn.sum()
    calls = fn.flash_nystrom.backward_calls
    first = torch.autograd.grad(loss, (q, k, v), retain_graph=True)
    second = torch.autograd.grad(loss, (q, k, v))
    assert fn.flash_nystrom.backward_calls == calls + 2
    for a, b in zip(first, second):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- fault 10: head dims 129-256 ----


@pytest.mark.parametrize("dh", [160, 200])
@pytest.mark.parametrize("use_attn", [True, False])
def test_flash_nystrom_vjp_at_head_dims_up_to_256(nystrom_card_branch, dh, use_attn):
    """K3 with every wrapper on its card branch, so K1, K2, K1b and K2b run
    at 256 columns and are cut back, against JAX's custom VJP in
    interpreter mode, attn's cotangent on and off; each kernel counted
    once. out, attn, dk and dv against JAX at rtol 1e-4, atol 1e-5. dq
    reaches 11 here, where JAX's fp32 dq and the port's each sit about 2e-5
    from the fp64 gradient, too far apart for atol 1e-5 between them; so dq
    of both, and dk and dv too, are held to the fp64 gradient of the plain
    attention by kernel_check's ``vjp_close``."""
    g = np.random.default_rng(dh)
    b, n, m = 2, 70, 8
    q, k, v, co = (g.normal(size=(b, 2, n, dh)).astype(np.float32) for _ in range(4))
    q *= dh ** -0.5
    ca = g.normal(size=(b, 2, n)).astype(np.float32) if use_attn else None
    mask = np.arange(n)[None] < np.array([70, 43])[:, None]

    def grads(f, dtype):
        leaves = [_t(x).to(dtype).requires_grad_() for x in (q, k, v)]
        out, attn = f(*leaves, _t(mask), m)
        total = (out * _t(co).to(dtype)).sum() + ((attn * _t(ca).to(dtype)).sum() if use_attn else 0.0)
        return (out.detach(), attn.detach(), *torch.autograd.grad(total, leaves))

    kernels = (fn.pass_a, fn.pass_b, fn.pass_a_backward, fn.pass_b_backward)
    before = [f.launches for f in kernels]
    got = [x.numpy() for x in grads(fn.flash_nystrom, torch.float32)]
    assert [f.launches for f in kernels] == [x + 1 for x in before]
    want = _vjp_jax(q, k, v, mask, co, ca, m)
    g64 = grads(lambda *a: nystrom_mod.nystrom_attention(*a, return_attn=True), torch.float64)[2:]
    for name, x, y in zip(("out", "attn", "dq", "dk", "dv"), got, want):
        if name != "dq":
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=name)
    for name, x, y, w in zip(("dq", "dk", "dv"), got[2:], want[2:], g64):
        for who, gr in (("port", x), ("jax", y)):
            res = vjp_close(_t(gr), w)
            assert res["ok"], (name, who, res)


def test_head_dim_257_raises_before_any_launch(nystrom_card_branch):
    """dh 257: K1, K1b, K2b and K3 raise a ValueError naming the range, and
    nothing is counted."""
    q = torch.zeros(1, 1, 40, 257)
    mask = torch.ones(1, 40, dtype=torch.bool)
    kernels = (fn.pass_a, fn.pass_b, fn.pass_a_backward, fn.pass_b_backward)
    before = [f.launches for f in kernels]
    ql, m3 = q[:, :, :8], torch.zeros(1, 1, 8)
    calls = (
        lambda: fn.flash_nystrom(q.clone().requires_grad_(), q, q, mask, 8),
        lambda: fn.pass_a_backward(ql, q, q, mask, ql, m3, m3, ql, m3),
        lambda: fn.pass_b_backward(q, q, mask, ql, mask[:, :8], ql, ql, m3, m3, q),
    )
    for call in calls:
        with pytest.raises(ValueError, match="head dims 1 to 256"):
            call()
    assert [f.launches for f in kernels] == before


# ---- the kernel gate's VJP criterion ----


@pytest.fixture(scope="module")
def full_vjp_case():
    """kernel_check's flash_nystrom_vjp case at its full shape and seed
    (1 × 8 × 2,048, dh 64, 128 landmarks, 90% valid), with the fp64
    reference gradients of autograd through the plain attention."""
    rng = np.random.default_rng(2)
    b, h, n, dh, m = 1, 8, 2048, 64, 128
    q, k, v = (_t(rng.normal(size=(b, h, n, dh)).astype(np.float32)) for _ in range(3))
    mask = _t(np.arange(n)[None] < int(n * 0.9))
    co = _t(rng.normal(size=(b, h, n, dh)).astype(np.float32))
    ca = _t(rng.normal(size=(b, h, n)).astype(np.float32))
    case = dict(q=q, k=k, v=v, mask=mask, co=co, ca=ca, m=m)
    case["g64"] = _grads(case, lambda *t: nystrom_mod.nystrom_attention(*t, mask, m, return_attn=True),
                         torch.float64)
    return case


def _grads(case, f, dtype=torch.float32):
    leaves = [case[x].to(dtype, copy=True).requires_grad_() for x in "qkv"]
    out, attn = f(*leaves)
    loss = (out * case["co"].to(dtype)).sum() + (attn * case["ca"].to(dtype)).sum()
    return torch.autograd.grad(loss, leaves)


def _k3(case, mask=None):
    return _grads(case, lambda *t: fn.flash_nystrom(*t, case["mask"] if mask is None else mask, case["m"]))


def _misses(got, g64):
    return sum(vjp_close(g, w)["n_bad"] for g, w in zip(got, g64))


def test_vjp_criterion_passes_the_fp32_reference_and_k3(full_vjp_case):
    """The fp32 autograd reference and K3 on the plain formulas (K1b's and
    K2b's functions as the backwards) meet vjp_close against the fp64
    gradients in every entry, with at least twice the room they use."""
    case = full_vjp_case
    ref32 = _grads(case, lambda *t: nystrom_mod.nystrom_attention(*t, case["mask"], case["m"], return_attn=True))
    for got in (ref32, _k3(case)):
        for g, w in zip(got, case["g64"]):
            res = vjp_close(g, w)
            assert res["ok"] and res["of_allowance"] < 0.5, res


def _mutated_k3(monkeypatch, case, name, mutate):
    """K3 with one wrapper's result changed by ``mutate``."""
    real = getattr(fn, name)

    def wrapper(*args, **kwargs):
        return mutate(real(*args, **kwargs))

    with monkeypatch.context() as mp:
        mp.setattr(fn, name, wrapper)
        return _k3(case)


def test_vjp_criterion_fails_single_tf32_products(monkeypatch, full_vjp_case):
    """K1b's and K2b's operands rounded once to TF32 (a kernel that skips
    the 3×TF32 split): many entries miss the criterion."""
    case = full_vjp_case
    with monkeypatch.context() as mp:
        for name in ("pass_a_backward_plain", "pass_b_backward_plain"):
            real = getattr(fn, name)
            mp.setattr(fn, name, lambda *a, _real=real: _real(
                *(_tf32(x) if isinstance(x, torch.Tensor) and x.is_floating_point() else x for x in a)))
        got = _k3(case)
    assert _misses(got, case["g64"]) > 1000


def test_vjp_criterion_fails_a_dropped_cls_term(monkeypatch, full_vjp_case):
    """K2b's d_k of the cls row left out: the criterion fails."""
    got = _mutated_k3(monkeypatch, full_vjp_case, "pass_b_backward",
                      lambda r: (r[0], torch.zeros_like(r[1]), *r[2:]))
    assert _misses(got, full_vjp_case["g64"]) > 100


def test_vjp_criterion_fails_a_zeroed_landmark_group(monkeypatch, full_vjp_case):
    """d_mid of one landmark group zeroed in K2b's result: the criterion
    fails."""
    def zero_group(r):
        d_mid = r[3].clone()
        d_mid[:, :, 5] = 0.0
        return (*r[:3], d_mid, *r[4:])

    got = _mutated_k3(monkeypatch, full_vjp_case, "pass_b_backward", zero_group)
    assert _misses(got, full_vjp_case["g64"]) > 100


def test_vjp_criterion_fails_a_mask_shifted_by_one_token(full_vjp_case):
    """K3 run with one more valid token than the reference's mask: the
    criterion fails."""
    case = full_vjp_case
    mask = case["mask"].clone()
    mask[0, int(mask.sum())] = True
    assert _misses(_k3(case, mask), case["g64"]) > 100
