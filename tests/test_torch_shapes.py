"""The shapes the port's kernels are not built for, on the CPU.

K1/K2 are built for head dims 16, 32, 64, 128 and 256, K5 for state sizes 2, 4,
8 and 16, and K4 for at most 1,024 columns a launch; their wrappers reshape
every other shape into those (``flash_nystrom.padded_head_dim``,
``scan2d.state_groups``, ``abmil_pool.column_groups``). Here each wrapper
takes its card branch with its launch replaced by the kernel's plain version,
which asserts that it was handed a shape the kernel is built for, and the
result is held against the JAX package's function on the same numpy inputs:
``flash_nystrom_infer`` against JAX's ``flash_nystrom_infer`` with its Pallas
kernels in interpreter mode (rtol 1e-4, atol 1e-5), the 2D scan against
JAX's separable scan and ``pallas_selective_scan_2d`` in interpreter mode
(rtol 1e-4, atol 1e-5), and the pool against JAX's ``fused_abmil_pool`` in
interpreter mode (1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.ops.pallas_scan2d as jps
from mhim_mil_torch.ops import abmil_pool, scan2d
from mhim_mil_torch.ops import flash_nystrom as fn
from mhim_mil_tpu.ops import scan as jscan
from mhim_mil_tpu.ops.pallas_abmil import fused_abmil_pool as j_abmil
from mhim_mil_tpu.ops.pallas_nystrom import flash_nystrom_infer as j_flash_infer


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def nystrom_card_branch(monkeypatch):
    """flash_nystrom's wrappers on their card branch, each launch replaced by
    its plain version, which asserts a head dim the kernels are built for."""
    def built_for(plain):
        def launch(*args):
            assert args[0].shape[-1] in fn.HEAD_DIMS, args[0].shape
            return plain(*args)
        return launch

    monkeypatch.setattr(fn, "_on_cpu", lambda *ts: False)
    for name, plain in (("_launch_pass_a", fn.pass_a_plain), ("_launch_pass_b", fn.pass_b_plain),
                        ("_launch_pass_b_backward",  # K2's out: unused; the gradients as K2b lays them out
                         lambda *a: fn.pass_b_backward_rows(*fn.pass_b_backward_plain(*a[:11]))),
                        ("_launch_pass_a_backward", fn.pass_a_backward_plain)):
        monkeypatch.setattr(fn, name, built_for(plain))


# ---- faults 7 and 10: K1/K2 at any head dim up to 256 ----


@pytest.mark.parametrize("dh", [8, 24, 48, 96, 160, 256])
def test_padded_head_dim_matches_jax_flash_nystrom_infer(nystrom_card_branch, dh):
    """flash_nystrom_infer through the zero-padded head dim (each pass run
    at 16, 32, 64, 128 or 256 columns and cut back) against JAX's
    flash_nystrom_infer in interpreter mode: rtol 1e-4, atol 1e-5; K1 and K2
    counted once each."""
    rng = np.random.default_rng(dh)
    b, h, n, m = 2, 2, 100, 8
    q, k, v = (rng.normal(size=(b, h, n, dh)).astype(np.float32) for _ in range(3))
    q *= dh ** -0.5
    mask = np.arange(n)[None] < np.array([100, 61])[:, None]
    before = (fn.pass_a.launches, fn.pass_b.launches)
    out, attn = fn.flash_nystrom_infer(*(_t(x) for x in (q, k, v, mask)), m)
    assert (fn.pass_a.launches, fn.pass_b.launches) == (before[0] + 1, before[1] + 1)
    want_out, want_attn = j_flash_infer(*(jnp.asarray(x) for x in (q, k, v, mask)), num_landmarks=m,
                                        tile=64, interpret=True)
    assert out.shape == (b, h, n, dh)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dh,want", [(1, 16), (16, 16), (17, 32), (48, 64), (64, 64), (96, 128), (128, 128),
                                     (129, 256), (200, 256), (256, 256)])
def test_kernel_head_dim_is_the_next_instantiation(dh, want):
    assert fn.kernel_head_dim(dh) == want


def test_head_dims_above_128_raise_before_any_launch(nystrom_card_branch):
    """A head dim past the largest instantiation (256 since DH 256 was
    added; 128 before) raises a ValueError that names the range, and no
    pass is counted."""
    q = torch.zeros(1, 1, 8, 257)
    mask = torch.ones(1, 8, dtype=torch.bool)
    before = fn.pass_a.launches
    with pytest.raises(ValueError, match="head dims 1 to 256"):
        fn.pass_a(q[:, :, :2], q, q, mask)
    assert fn.pass_a.launches == before


def test_padded_pass_b_backward_matches_its_plain_version(nystrom_card_branch):
    """K2b's wrapper at head dim 24 (run at 32 and cut back) against
    pass_b_backward_plain on the unpadded tensors, with and without the cls
    term: rtol 1e-5, atol 1e-6; d_out in a strided [B,H,N,dh] view of
    [B,N,H,dh] storage."""
    rng = np.random.default_rng(4)
    b, h, n, dh, m = 2, 2, 50, 24, 8
    q, k, v = (_t(rng.normal(size=(b, h, n, dh)).astype(np.float32)) for _ in range(3))
    mask = _t(np.arange(n)[None] < np.array([50, 29])[:, None])
    q_l, k_l, lm_mask, pinv = fn.landmarks(q, k, mask, m)
    attn3v, m3, s3 = fn.pass_a_plain(q_l, k, v, mask)
    mid, rp = fn.pass_b_operands(q, k_l, mask, lm_mask, pinv, attn3v, s3)
    d_out = _t(rng.normal(size=(b, n, h, dh)).astype(np.float32)).transpose(1, 2)
    d_cls = _t(rng.normal(size=(b, h, n)).astype(np.float32))
    for cls in (None, d_cls):
        args = (q, k, mask, k_l, lm_mask, mid, q_l, rp, m3, d_out, cls)
        got = fn.pass_b_backward(*args)
        want = fn.pass_b_backward_plain(*args)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.shape == w.shape
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# ---- fault 8: K5 at any state size ----


def _scan_inputs(seed, bs, h, w, ed, n):
    """x, Δ = 0.1·softplus(normal), A_log = log(1..n), B, C, D as
    ``test_pallas_scan2d.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bs, h, w, ed)).astype(np.float32)
    delta = (np.log1p(np.exp(rng.normal(size=(bs, h, w, ed)))) * 0.1).astype(np.float32)
    a_log = np.log(np.tile(np.arange(1, n + 1, dtype=np.float32), (ed, 1)))
    B = rng.normal(size=(bs, h, w, n)).astype(np.float32)
    C = rng.normal(size=(bs, h, w, n)).astype(np.float32)
    D = rng.normal(size=(ed,)).astype(np.float32)
    return x, delta, a_log, B, C, D


@pytest.mark.parametrize("n,groups", [(3, 1), (12, 1), (32, 2), (1, 1), (20, 2)])
def test_state_groups_match_jax(monkeypatch, n, groups):
    """The K5 wrapper's card branch at state size n, its launch replaced by
    scan2d_plain that asserts a built state size (2, 4, 8 or 16): n padded
    with zero B and C columns, and above 16 in groups of 16 whose y are
    summed, against JAX's separable scan and pallas_selective_scan_2d in
    interpreter mode, rtol 1e-4 atol 1e-5. One call counted, ⌈n/16⌉ launches."""
    calls = []

    def launch(x, delta, a_log, B, C, D):
        assert a_log.shape[-1] in scan2d.STATES and B.shape[-1] == C.shape[-1] == a_log.shape[-1]
        calls.append(a_log.shape[-1])
        return scan2d.scan2d_plain(x, delta, a_log, B, C, D)

    monkeypatch.setattr(scan2d, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(scan2d, "_launch", launch)
    bs, h, w, ed = 2, 5, 7, 4
    x, delta, a_log, B, C, D = _scan_inputs(n, bs, h, w, ed, n)
    j = [jnp.asarray(t) for t in (x, delta, a_log, B, C, D)]
    want = np.asarray(jscan.selective_scan_2d(j[0], j[1], -jnp.exp(j[2]), *j[3:]))
    want_k = np.asarray(jps.pallas_selective_scan_2d(*j, ed_tile=ed, interpret=True))
    bc = _t(np.concatenate([B, C], axis=-1))  # B and C as slices of one projection
    before = scan2d.selective_scan_2d_fused.launches
    with torch.no_grad():
        got = scan2d.selective_scan_2d_fused(_t(x), _t(delta), _t(a_log), bc[..., :n], bc[..., n:], _t(D))
    assert scan2d.selective_scan_2d_fused.launches == before + 1
    assert len(calls) == groups
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_k, rtol=1e-4, atol=1e-5)


def test_state_groups_pass_states_16_as_they_are():
    """At a built state size the inner call gets the caller's tensors
    themselves (no copy)."""
    x, delta, a_log, B, C, D = (_t(a) for a in _scan_inputs(0, 1, 2, 3, 4, 16))
    seen = scan2d.state_groups(lambda *a: a, x, delta, a_log, B, C, D)
    assert all(s is t for s, t in zip(seen, (x, delta, a_log, B, C, D)))


# ---- fault 9: K4 at any width ----


def _abmil_launch(widths):
    """K4's launch as plain torch, returning (pooled, attn) as the kernel
    does, after asserting a width the kernel takes."""
    def launch(x, logits, mask):
        assert x.shape[-1] <= abmil_pool.COLUMNS and x.stride(-1) == 1
        widths.append(x.shape[-1])
        return abmil_pool.abmil_pool_plain(x, logits, mask)
    return launch


@pytest.mark.parametrize("d,dtype", [(1536, np.float32), (2100, np.float32), (1025, np.float32)])
def test_column_groups_match_jax(monkeypatch, d, dtype):
    """The K4 wrapper's card branch at width d, its launch replaced by the
    plain pool on at most 1,024 columns: groups of 1,024 columns, pooled
    concatenated and attn from the first group's statistics, against JAX's
    fused_abmil_pool in interpreter mode at 1e-5; ragged bags and a bag with
    no valid instance. One call counted."""
    widths = []
    monkeypatch.setattr(abmil_pool, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(abmil_pool, "_launch", _abmil_launch(widths))
    rng = np.random.default_rng(d)
    b, n = 3, 70
    x = rng.normal(size=(b, n, d)).astype(dtype)
    logits = (3 * rng.normal(size=(b, n))).astype(np.float32)
    mask = np.arange(n)[None] < np.array([70, 33, 0])[:, None]
    want_pooled, want_attn = j_abmil(jnp.asarray(x), jnp.asarray(logits), jnp.asarray(mask), tile=64,
                                     interpret=True)
    before = abmil_pool.fused_abmil_pool.launches
    with torch.no_grad():
        pooled, attn = abmil_pool.fused_abmil_pool(_t(x), _t(logits), _t(mask))
    assert abmil_pool.fused_abmil_pool.launches == before + 1
    assert widths == [min(1024, d - c) for c in range(0, d, 1024)]
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), rtol=1e-5, atol=1e-6)
    assert np.all(pooled[2].numpy() == 0) and np.all(attn[2].numpy() == 0)


def test_column_groups_keep_strided_views():
    """Each group is a view of the caller's x (a slice of its columns), so
    the kernel reads it in place."""
    x = torch.randn(2, 5, 3000)[..., 100:2600]
    seen = []
    abmil_pool.column_groups(lambda xs, lg, mk: (seen.append(xs) or xs.sum(1), None), x, None, None)
    assert [s.shape[-1] for s in seen] == [1024, 1024, 452]
    assert all(s.data_ptr() == x[..., c:].data_ptr() and s.stride() == x.stride()
               for s, c in zip(seen, (0, 1024, 2048)))
