"""K2b, the backward of K2's pass, and K3's VJP, on the CPU.

- ``pass_b_backward_plain`` (K2b's function, the formulas the kernels
  compute) against ``torch.autograd`` of ``pass_b_plain``: ragged bags,
  empty landmark groups, a bag with no valid token, m = 8, with and without
  the cls cotangent; rtol 1e-5, atol 1e-6. Values at masked tokens are never
  used, and the cls term is invariant to a shift of m3.
- K3 (``flash_nystrom``) against the JAX package's custom-VJP
  ``flash_nystrom`` with its Pallas kernels in interpreter mode, at
  ``tests/test_torch_train.py``'s K3 tolerances (rtol 1e-4, atol 1e-5), on
  the cases that file does not take: a bag with no valid token, attn
  unused, m 16 with empty landmark groups, and head dims the kernels are not
  built for, through the wrappers' padding.
- The backward kernels' grids: K2b's token tiles and landmark splits, K1b's
  one grid of landmark and key blocks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_torch.ops import flash_nystrom as fn
from mhim_mil_tpu.ops.pallas_nystrom import flash_nystrom as j_flash_nystrom


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _operands(seed, lengths, n, dh, m, h=2):
    """q (scaled), k, v, mask and K2's operands from the plain glue, as
    flash_nystrom_infer makes them."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q, k, v = (_t(rng.normal(size=(b, h, n, dh)).astype(np.float32)) for _ in range(3))
    q = q * dh ** -0.5
    mask = _t(np.arange(n)[None] < np.array(lengths)[:, None])
    q_l, k_l, lm_mask, pinv = fn.landmarks(q, k, mask, m)
    attn3v, m3, s3 = fn.pass_a_plain(q_l, k, v, mask)
    mid, rp = fn.pass_b_operands(q, k_l, mask, lm_mask, pinv, attn3v, s3)
    d_out = _t(rng.normal(size=(b, h, n, dh)).astype(np.float32))
    d_cls = _t(rng.normal(size=(b, h, n)).astype(np.float32))
    return (q, k, v, mask), (k_l, lm_mask, mid, q_l, rp, m3), d_out, d_cls


@pytest.mark.parametrize("lengths,n,m", [
    ((100, 37), 100, 16),  # ragged: bag 1 leaves landmark groups empty
    ((64, 64), 64, 8),  # full bags, m = 8
    ((90, 0, 45), 90, 8),  # a bag with no valid token
])
@pytest.mark.parametrize("with_cls", [False, True])
def test_pass_b_backward_plain_matches_autograd(lengths, n, m, with_cls):
    """Every gradient of pass_b_plain's out·d_out (+ cls·d_cls) against
    autograd, rtol 1e-5 atol 1e-6. Autograd of the forward is NaN on a bag
    with no valid token (its cls row takes exp(+1e30) before the mask), so
    that bag is held at exactly zero instead; d_kl and d_mid are zero at
    empty landmark groups."""
    (q, k, _, mask), (k_l, lm_mask, mid, q_l, rp, m3), d_out, d_cls = _operands(n + m, lengths, n, 16, m)
    assert lm_mask.all() == (min(lengths) == n)
    leaves = [t.clone().requires_grad_() for t in (q, k, k_l, mid, q_l, rp, m3)]
    out, cls = fn.pass_b_plain(leaves[0], leaves[1], mask, leaves[2], lm_mask, *leaves[3:])
    loss = (out * d_out).sum() + ((cls * d_cls).sum() if with_cls else 0.0)
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = fn.pass_b_backward_plain(q, k, mask, k_l, lm_mask, mid, q_l, rp, m3, d_out,
                                   d_cls if with_cls else None)
    full = torch.tensor([n_valid > 0 for n_valid in lengths])
    for name, g, w in zip(("d_q", "d_k", "d_kl", "d_mid", "d_ql", "d_rp", "d_m3"), got,
                          (want[0], want[1], want[2], want[3], want[4], want[5], want[6])):
        if g is None:
            assert not with_cls and name in ("d_k", "d_ql", "d_rp", "d_m3"), name
            continue
        w = torch.zeros_like(g) if w is None else w
        torch.testing.assert_close(g[full], w[full], rtol=1e-5, atol=1e-6, msg=name)
        assert torch.all(g[~full] == 0), name
    for name, g in (("d_kl", got[2]), ("d_mid", got[3])):
        assert torch.all(g.transpose(1, 2)[~lm_mask] == 0), name
    tok = mask[:, None, :, None]
    assert torch.all(torch.where(tok, 0.0, got[0]) == 0)


def test_pass_b_backward_plain_ignores_values_at_masked_tokens():
    """NaN in q, k and both cotangents at masked tokens changes nothing."""
    (q, k, _, mask), rest, d_out, d_cls = _operands(7, (60, 23), 60, 16, 8)
    want = fn.pass_b_backward_plain(q, k, mask, *rest, d_out, d_cls)
    tok = mask[:, None, :, None]
    nan = [torch.where(tok, t, float("nan")) for t in (q, k, d_out)]
    got = fn.pass_b_backward_plain(nan[0], nan[1], mask, *rest, nan[2],
                                   torch.where(mask[:, None, :], d_cls, float("nan")))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _vjp_jax(q, k, v, mask, co, ca, m):
    def loss(q, k, v):
        out, attn = j_flash_nystrom(q, k, v, jnp.asarray(mask), m, 6, 64, True)
        total = jnp.sum(out * co)
        return (total if ca is None else total + jnp.sum(attn * ca)), (out, attn)

    (_, (out, attn)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    return [np.asarray(x) for x in (out, attn, *grads)]


def _vjp_port(q, k, v, mask, co, ca, m):
    qt, kt, vt = (_t(t).requires_grad_() for t in (q, k, v))
    calls = fn.flash_nystrom.backward_calls
    out, attn = fn.flash_nystrom(qt, kt, vt, _t(mask), m)
    total = (out * _t(co)).sum()
    if ca is not None:
        total = total + (attn * _t(ca)).sum()
    total.backward()
    assert fn.flash_nystrom.backward_calls == calls + 1
    return [x.detach().numpy() for x in (out, attn, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("b,n,dh,m,lengths,use_attn", [
    (2, 128, 16, 8, (128, 90), True),  # tests/test_torch_train.py's case
    (3, 100, 16, 8, (100, 61, 0), True),  # ragged, a bag with no valid token
    (2, 100, 16, 8, (100, 61), False),  # attn unused: K2b without the cls term
    (2, 96, 32, 16, (96, 40), True),  # m 16, bag 1 leaves landmark groups empty
])
def test_flash_nystrom_vjp_matches_jax_interpret(b, n, dh, m, lengths, use_attn):
    """K3 on the CPU (the plain versions of K1 and K2 forward, of K1b and
    K2b backward) against JAX's custom-VJP flash_nystrom with its Pallas kernels
    in interpreter mode: out, attn and the q/k/v gradients under random
    cotangents (attn's left out where unused), rtol 1e-4, atol 1e-5."""
    g = np.random.default_rng(n + dh)
    q, k, v, co = (g.normal(size=(b, 2, n, dh)).astype(np.float32) for _ in range(4))
    q *= dh ** -0.5
    ca = g.normal(size=(b, 2, n)).astype(np.float32) if use_attn else None
    mask = np.arange(n)[None] < np.array(lengths)[:, None]
    want = _vjp_jax(q, k, v, mask, co, ca, m)
    got = _vjp_port(q, k, v, mask, co, ca, m)
    for name, x, y in zip(("out", "attn", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dh", [24, 40])
def test_flash_nystrom_vjp_through_padded_head_dims(monkeypatch, dh):
    """K3 with every wrapper on its card branch (launches replaced by the
    plain versions, each asserting a built head dim), so K1, K2 and their
    backwards K1b and K2b run at 32 or 64 columns and are cut back, against
    JAX's VJP in interpreter mode at rtol 1e-4, atol 1e-5."""
    def built_for(plain):
        def launch(*args):
            assert args[0].shape[-1] in fn.HEAD_DIMS
            return plain(*args)
        return launch

    monkeypatch.setattr(fn, "_on_cpu", lambda *ts: False)
    for name, plain in (("_launch_pass_a", fn.pass_a_plain), ("_launch_pass_b", fn.pass_b_plain),
                        ("_launch_pass_b_backward",  # K2's out: unused; the gradients as K2b lays them out
                         lambda *a: fn.pass_b_backward_rows(*fn.pass_b_backward_plain(*a[:11]))),
                        ("_launch_pass_a_backward", fn.pass_a_backward_plain)):
        monkeypatch.setattr(fn, name, built_for(plain))
    g = np.random.default_rng(dh)
    b, n, m = 2, 80, 8
    q, k, v, co = (g.normal(size=(b, 2, n, dh)).astype(np.float32) for _ in range(4))
    q *= dh ** -0.5
    ca = g.normal(size=(b, 2, n)).astype(np.float32)
    mask = np.arange(n)[None] < np.array([80, 51])[:, None]
    kernels = (fn.pass_a, fn.pass_b, fn.pass_a_backward, fn.pass_b_backward)
    before = [f.launches for f in kernels]
    got = _vjp_port(q, k, v, mask, co, ca, m)
    assert [f.launches for f in kernels] == [x + 1 for x in before]
    for name, x, y in zip(("out", "attn", "dq", "dk", "dv"), got, _vjp_jax(q, k, v, mask, co, ca, m)):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=name)


def test_cls_term_is_invariant_to_a_shift_of_m3():
    """cls = Σ_m r'·exp(q_l·k − m3): shifting m3 by any c and r' by exp(c)
    leaves out, cls and every gradient but d_r' as they were (d_r' scales by
    exp(−c), so d_m3 = −r'·d_r' is unchanged), rtol 1e-5 atol 1e-6. So the
    gradient that reaches m3's arg-max through amax is exact whichever key
    amax picks, and a backward may equally take m3 as a constant."""
    (q, k, _, mask), (k_l, lm_mask, mid, q_l, rp, m3), d_out, d_cls = _operands(12, (60, 37), 60, 16, 8)
    c = 0.5 * torch.tanh(q_l.sum(dim=-1))
    fwd = fn.pass_b_plain(q, k, mask, k_l, lm_mask, mid, q_l, rp, m3)
    fwd_s = fn.pass_b_plain(q, k, mask, k_l, lm_mask, mid, q_l, rp * torch.exp(c), m3 + c)
    for x, y in zip(fwd_s, fwd):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    want = fn.pass_b_backward_plain(q, k, mask, k_l, lm_mask, mid, q_l, rp, m3, d_out, d_cls)
    got = fn.pass_b_backward_plain(q, k, mask, k_l, lm_mask, mid, q_l, rp * torch.exp(c), m3 + c, d_out, d_cls)
    for name, x, y in zip(("d_q", "d_k", "d_kl", "d_mid", "d_ql", "d_rp", "d_m3"), got, want):
        if name == "d_rp":
            x = x * torch.exp(c)
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6, msg=name)


@pytest.mark.parametrize("b,h,n,m,dh", [(4, 8, 1027, 256, 64), (1, 2, 128, 8, 16), (2, 4, 10241, 256, 128),
                                        (1, 1, 31, 300, 32), (4, 4, 1027, 256, 128), (4, 2, 1027, 256, 256),
                                        (1, 8, 2048, 128, 64)])
@pytest.mark.parametrize("kernel", ["K2b", "K1b"])
def test_backward_plan_covers_every_token_once(b, h, n, m, dh, kernel):
    """The backward kernels' grids at the student's shape (B 4, H 8, N
    1,027, m 256), dh 128 and 256 beside it, kernel_check's VJP shapes (full
    and --small) and odd ones. K2b: the token kernel's tiles cover [0, n)
    once, and the landmark kernel's token splits are whole tiles of
    ``bwd_keys`` tokens, none empty, that cover [0, n) once for every
    landmark tile, which cover [0, m) once; at the student's shape it has at
    least two blocks for each of the H100's 132 SMs. K1b: its one grid's
    landmark blocks (tiles of rows landmarks, key splits) cover each
    (landmark, key) pair once and its key blocks each key once. Every block
    holds at least four warps."""
    rows, tile = fn.bwd_rows(dh), fn.bwd_keys(dh)
    assert (rows // 16) * max(1, fn.kernel_head_dim(dh) // 64) >= 4  # warps: row groups × 64-column groups
    if kernel == "K2b":
        n_splits, per_split = fn.pass_b_backward_plan(b, h, n, m, dh=dh)
    else:
        n_splits, per_split = fn.pass_a_backward_plan(n, m, dh)
    landmark = [(r, s * per_split, min(n, (s + 1) * per_split)) for s in range(n_splits)
                for r in range(0, m, rows)]
    key = [(t0, min(n, t0 + rows)) for t0 in range(0, n, rows)]
    assert per_split % tile == 0 and per_split > 0
    pairs = torch.zeros(m, n, dtype=torch.int64)
    for r0, lo, hi in landmark:
        assert lo < hi and r0 < m
        pairs[r0:r0 + rows, lo:hi] += 1
    assert torch.all(pairs == 1)
    covered = torch.zeros(n, dtype=torch.int64)
    for lo, hi in key:
        assert lo < hi
        covered[lo:hi] += 1
    assert torch.all(covered == 1)
    if (b, h, n, m, dh, kernel) == (4, 8, 1027, 256, 64, "K2b"):
        assert b * h * math.ceil(m / fn.bwd_rows(dh)) * n_splits >= 2 * 132
