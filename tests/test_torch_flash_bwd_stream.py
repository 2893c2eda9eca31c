"""The arithmetic of the redesigned K2b and K1b, on the CPU.

- ``pass_b_backward_stream_plain`` (K2b as its kernels order it: ``D`` from
  K2's ``out``, one walk over landmark chunks with the online softmax, the
  landmark side over token splits) and ``pass_a_backward_split_plain`` (K1b's
  one grid: ``D`` and ``1/s3`` where they are used, ``d_ql`` over key
  splits) against autograd through ``pass_b_plain`` / ``pass_a_plain`` at
  rtol 1e-4, atol 1e-5, on ragged bags whose last landmark groups are empty,
  at the kernels' chunk sizes and split plans.
- K3 with both mirrors as its backwards (every wrapper on its card branch)
  against the JAX package's custom-VJP ``flash_nystrom`` with its Pallas
  kernels in interpreter mode, rtol 1e-4, atol 1e-5.
- The K2b wrapper hands the kernels K2's ``out``: ``PassB`` saves it, and
  without it the card branch runs K2 (counted) for it.
"""

import numpy as np
import pytest
import torch

from mhim_mil_torch.ops import flash_nystrom as fn
from test_torch_flash_backward import _operands, _vjp_jax, _vjp_port


def _t(a):
    return torch.from_numpy(np.asarray(a))


CASES = [
    ((100, 37), 100, 16, 16),  # ragged: bag 1 leaves landmark groups empty
    ((90, 0, 45), 90, 8, 32),  # a bag with no valid token
    ((130, 61), 130, 16, 128),  # dh 128: 16-row chunks and tiles
]


@pytest.mark.parametrize("lengths,n,m,dh", CASES)
@pytest.mark.parametrize("with_cls", [False, True])
def test_pass_b_backward_stream_plain_matches_autograd(lengths, n, m, dh, with_cls):
    """K2b's streamed arithmetic at its chunk size and split plan against
    autograd of pass_b_plain's out·d_out (+ cls·d_cls), rtol 1e-4 atol 1e-5;
    zero at a bag with no valid token (autograd is NaN there) and, for d_kl
    and d_mid, at empty landmark groups."""
    (q, k, _, mask), (k_l, lm_mask, mid, q_l, rp, m3), d_out, d_cls = _operands(n + dh, lengths, n, dh, m)
    assert not lm_mask.all()
    leaves = [t.clone().requires_grad_() for t in (q, k, k_l, mid, q_l, rp, m3)]
    out, cls = fn.pass_b_plain(leaves[0], leaves[1], mask, leaves[2], lm_mask, *leaves[3:])
    loss = (out * d_out).sum() + ((cls * d_cls).sum() if with_cls else 0.0)
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    n_splits, per_split = fn.pass_b_backward_plan(len(lengths), 2, n, m, dh=dh)
    got = fn.pass_b_backward_stream_plain(q, k, mask, k_l, lm_mask, mid, q_l, rp, m3, d_out,
                                          d_cls if with_cls else None, out.detach(), fn.bwd_keys(dh), n_splits,
                                          per_split)
    full = torch.tensor([x > 0 for x in lengths])
    for name, g, w in zip(("d_q", "d_k", "d_kl", "d_mid", "d_ql", "d_rp", "d_m3"), got, want):
        if g is None:
            assert not with_cls, name
            continue
        w = torch.zeros_like(g) if w is None else w
        torch.testing.assert_close(g[full], w[full], rtol=1e-4, atol=1e-5, msg=name)
        assert torch.all(g[~full] == 0), name
    for name, g in (("d_kl", got[2]), ("d_mid", got[3])):
        assert torch.all(g.transpose(1, 2)[~lm_mask] == 0), name


@pytest.mark.parametrize("lengths,n,m,dh", CASES)
@pytest.mark.parametrize("with_s3", [False, True])
def test_pass_a_backward_split_plain_matches_autograd(lengths, n, m, dh, with_s3):
    """K1b's one-grid arithmetic at its split plan against autograd through
    pass_a_plain (m3's cotangent set to the one the composition gives it, as
    test_torch_flash_k1b holds the plain version), rtol 1e-4 atol 1e-5; zero
    at a bag with no valid key."""
    rng = np.random.default_rng(n + dh)
    b = len(lengths)
    ql = _t(rng.normal(size=(b, 2, m, dh)).astype(np.float32)) * dh ** -0.5
    k, v = (_t(rng.normal(size=(b, 2, n, dh)).astype(np.float32)) for _ in range(2))
    mask = _t(np.arange(n)[None] < np.array(lengths)[:, None])
    d_attn3v = _t(rng.normal(size=(b, 2, m, dh)).astype(np.float32))
    d_s3 = _t(rng.normal(size=(b, 2, m)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (ql, k, v)]
    attn3v, m3, s3 = fn.pass_a_plain(*leaves, mask)
    loss = (attn3v * d_attn3v).sum()
    if with_s3:
        loss = loss + (s3 * d_s3).sum() + (m3 * (s3 * d_s3).detach()).sum()
    want = torch.autograd.grad(loss, leaves)
    n_splits, per_split = fn.pass_a_backward_plan(n, m, dh)
    got = fn.pass_a_backward_split_plain(ql, k, v, mask, attn3v.detach(), m3.detach(), s3.detach(), d_attn3v,
                                         d_s3 if with_s3 else None, n_splits, per_split)
    full = torch.tensor([x > 0 for x in lengths])
    for name, g, w in zip(("d_ql", "d_k", "d_v"), got, want):
        torch.testing.assert_close(g[full], w[full], rtol=1e-4, atol=1e-5, msg=name)
        assert torch.all(g[~full] == 0), name


@pytest.fixture
def stream_card_branch(monkeypatch):
    """flash_nystrom's wrappers on their card branch: K1 and K2 launched as
    their plain versions, K2b as its streamed mirror and K1b as its split
    mirror at the kernels' plans, each asserting a built head dim (and K2b
    that it was handed K2's out)."""
    def k2b(q, k, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_cls, out):
        b, h, n, dh = q.shape
        assert dh in fn.HEAD_DIMS
        torch.testing.assert_close(out, fn.pass_b_plain(q, k, mask, kl, lm_mask, mid, ql, rp, m3)[0],
                                   rtol=0, atol=0)
        n_splits, per_split = fn.pass_b_backward_plan(b, h, n, kl.shape[2], dh=dh)
        return fn.pass_b_backward_rows(*fn.pass_b_backward_stream_plain(
            q, k, mask, kl, lm_mask, mid, ql, rp, m3, d_out, d_cls, out, fn.bwd_keys(dh), n_splits, per_split))

    def k1b(ql, k, v, mask, attn3v, m3, s3, d_attn3v, d_s3):
        assert ql.shape[-1] in fn.HEAD_DIMS
        return fn.pass_a_backward_split_plain(ql, k, v, mask, attn3v, m3, s3, d_attn3v, d_s3,
                                              *fn.pass_a_backward_plan(k.shape[2], ql.shape[2], ql.shape[-1]))

    monkeypatch.setattr(fn, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(fn, "_launch_pass_a", fn.pass_a_plain)
    monkeypatch.setattr(fn, "_launch_pass_b", fn.pass_b_plain)
    monkeypatch.setattr(fn, "_launch_pass_b_backward", k2b)
    monkeypatch.setattr(fn, "_launch_pass_a_backward", k1b)


@pytest.mark.parametrize("b,n,dh,m,lengths,use_attn", [
    (2, 128, 16, 8, (128, 90), True),
    (2, 96, 32, 16, (96, 40), True),  # m 16, bag 1 leaves landmark groups empty
    (2, 100, 64, 16, (100, 61), False),  # attn unused: K2b without the cls term
    (3, 70, 64, 8, (70, 43, 0), True),  # a bag with no valid token
])
def test_flash_nystrom_vjp_through_the_stream_mirrors_matches_jax(stream_card_branch, b, n, dh, m, lengths,
                                                                   use_attn):
    """K3 with the redesigned backwards' arithmetic (K2b handed K2's out by
    PassB, one launch of each counted, K2 not run again) against JAX's
    custom-VJP flash_nystrom in interpreter mode: out, attn and the q/k/v
    gradients under random cotangents, rtol 1e-4, atol 1e-5."""
    g = np.random.default_rng(n + dh + m)
    q, k, v, co = (g.normal(size=(b, 2, n, dh)).astype(np.float32) for _ in range(4))
    q *= dh ** -0.5
    ca = g.normal(size=(b, 2, n)).astype(np.float32) if use_attn else None
    mask = np.arange(n)[None] < np.array(lengths)[:, None]
    kernels = (fn.pass_a, fn.pass_b, fn.pass_a_backward, fn.pass_b_backward)
    before = [f.launches for f in kernels]
    got = _vjp_port(q, k, v, mask, co, ca, m)
    assert [f.launches for f in kernels] == [x + 1 for x in before]
    for name, x, y in zip(("out", "attn", "dq", "dk", "dv"), got, _vjp_jax(q, k, v, mask, co, ca, m)):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=name)


def test_pass_b_backward_without_out_runs_k2_first(stream_card_branch):
    """Called without out on the card branch, pass_b_backward runs K2 (one
    pass_b launch counted) and hands its out to the kernels; the gradients
    are pass_b_backward_plain's."""
    (q, k, _, mask), rest, d_out, d_cls = _operands(4, (60, 33), 60, 16, 8)
    before = (fn.pass_b.launches, fn.pass_b_backward.launches)
    got = fn.pass_b_backward(q, k, mask, *rest, d_out, d_cls)
    assert (fn.pass_b.launches, fn.pass_b_backward.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, fn.pass_b_backward_plain(q, k, mask, *rest, d_out, d_cls)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
