"""K1's key splits and the operand precision of the flash-Nystrom kernels, on the CPU.

- ``pass_a_split_plain`` (the split-and-merge arithmetic of K1's two
  kernels) against ``pass_a_plain`` at rtol 1e-5, atol 1e-6: the same sums
  in another grouping; and, in place of K1 inside ``flash_nystrom_infer``,
  against the JAX package's Pallas kernels in interpreter mode.
- ``pass_a_plan``: every key in exactly one split, and enough blocks to
  fill the card at the flagship shape.
- The kernels' 3×TF32 products emulated in torch (each fp32 operand split
  into ``hi = tf32(x)``, rounded to nearest with ties away from zero, and
  ``lo = x − hi``, which the tensor cores read truncated to TF32; ``lo·hi +
  hi·lo + hi·hi`` summed in fp32) on K1's and K2's functions, against the fp64
  plain versions at ``chip_smoke.py``'s tolerances; and through the whole
  ``flash_nystrom_infer`` against ``nystrom_attention`` at
  ``kernel_check``'s shape and tolerances. The emulation does not model the
  tensor cores' order of accumulation.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_torch.ops import flash_nystrom as fn
from mhim_mil_torch.ops.masked import NEG_INF
from mhim_mil_torch.ops.nystrom import nystrom_attention
from mhim_mil_tpu.ops.pallas_nystrom import flash_nystrom_infer as j_flash


def _tensors(seed, b, h, n, dh, m, lengths, scale):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, dh)).astype(np.float32)) for _ in range(3))
    ql = torch.from_numpy(rng.normal(size=(b, h, m, dh)).astype(np.float32)) * scale
    mask = torch.arange(n)[None] < torch.tensor(lengths)[:, None]
    return q * scale, k, v, ql, mask


@pytest.mark.parametrize("n,m,lengths,per_split", [
    (1000, 64, (1000, 613), 128),  # ragged bags; N not a multiple of the split
    (1000, 64, (700, 1000), 96),  # splits past 700 hold no valid key in bag 0
    (300, 16, (0, 300), 64),  # a bag with no valid key
    (100, 8, (100, 37), 32),  # m = 8
    (257, 8, (257, 1), 256),  # a last split of one key; a bag of one key
])
def test_split_and_merge_matches_pass_a_plain(n, m, lengths, per_split):
    """K1's split arithmetic equals pass_a_plain (rtol 1e-5, atol 1e-6); a
    bag with no valid key gives attn3v 0, m3 −1e30 and s3 0, and values at
    masked keys (NaN here) are never used."""
    b, h, dh = len(lengths), 2, 32
    _, k, v, ql, mask = _tensors(0, b, h, n, dh, m, lengths, dh ** -0.5)
    k, v = (torch.where(mask[:, None, :, None], t, float("nan")) for t in (k, v))
    n_splits = math.ceil(n / per_split)
    got = fn.pass_a_split_plain(ql, k, v, mask, n_splits, per_split)
    want = fn.pass_a_plain(ql, k, v, mask)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    empty = [i for i, n_valid in enumerate(lengths) if n_valid == 0]
    for i in empty:
        assert torch.all(got[0][i] == 0) and torch.all(got[1][i] == NEG_INF) and torch.all(got[2][i] == 0)


@pytest.mark.parametrize("b,h,n,dh,m,lengths", [
    (2, 2, 128, 32, 16, (96, 128)),  # bag 0's last split holds no valid key
    (1, 2, 100, 32, 8, (100,)),  # N not a multiple of the split
])
def test_split_pass_a_matches_jax_interpret(monkeypatch, b, h, n, dh, m, lengths):
    """flash_nystrom_infer with K1's function taken as the kernels take it
    (the keys in pass_a_plan's splits, merged by log-sum-exp) against the
    JAX package's flash_nystrom_infer with its Pallas kernels in interpreter
    mode, on the same numpy inputs: rtol 1e-4, atol 1e-5."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(b, h, n, dh)).astype(np.float32) for _ in range(3))
    q *= dh ** -0.5
    mask = np.arange(n)[None] < np.array(lengths)[:, None]
    n_splits, per_split = fn.pass_a_plan(b, h, n, m)
    assert n_splits > 1
    monkeypatch.setattr(fn, "pass_a", lambda *a: fn.pass_a_split_plain(*a, n_splits, per_split))
    got_out, got_attn = fn.flash_nystrom_infer(*(torch.from_numpy(x) for x in (q, k, v, mask)), m)
    want_out, want_attn = j_flash(*(jnp.asarray(x) for x in (q, k, v, mask)), num_landmarks=m, tile=64,
                                  interpret=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,h,n,m", [(4, 8, 10241, 256), (1, 8, 10241, 256), (1, 2, 100, 8),
                                     (2, 4, 1, 64), (16, 8, 4096, 256), (1, 1, 31, 300)])
def test_split_plan_covers_every_key_once(b, h, n, m):
    """Splits are whole 32-key tiles, none empty, and together cover [0, n)
    exactly once."""
    n_splits, per_split = fn.pass_a_plan(b, h, n, m)
    assert per_split % fn.PASS_A_KEYS == 0 and per_split > 0
    covered = torch.zeros(n, dtype=torch.int64)
    for s in range(n_splits):
        lo, hi = s * per_split, min(n, (s + 1) * per_split)
        assert lo < hi
        covered[lo:hi] += 1
    assert torch.all(covered == 1)


@pytest.mark.parametrize("b", [4, 1])
def test_split_plan_fills_the_card_at_the_flagship(b):
    """At the flagship (H 8, N 10,241, m 256), batch 4 and batch 1, K1's
    grid has at least two blocks for each of the H100's 132 SMs."""
    n_splits, per_split = fn.pass_a_plan(b, 8, 10241, 256)
    blocks = b * 8 * math.ceil(256 / fn.PASS_A_ROWS) * n_splits
    assert blocks >= 2 * 132, (n_splits, per_split, blocks)


# ---- the operand precision ----


def _tf32(x, round_bit=0x1000):
    """x with 10 mantissa bits: rounded to nearest, ties away from zero (as
    the kernels' ``split`` rounds hi), or truncated with ``round_bit=0`` (as
    the tensor cores read lo)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + round_bit) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b on the kernels' 3×TF32 operands, summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah, 0), _tf32(b - bh, 0)
    return (al @ bh + ah @ bl) + ah @ bh


def _pass_a_3xtf32(ql, k, v, mask):
    valid = mask[:, None, None, :]
    sim = torch.where(valid, _mm3(ql, k.transpose(-1, -2)), NEG_INF)
    m3 = sim.amax(dim=-1)
    p = torch.where(valid, torch.exp(sim - m3[..., None]), 0.0)
    s3 = p.sum(dim=-1)
    v = torch.where(mask[:, None, :, None], v, 0.0)
    return _mm3(p, v) / s3.clamp_min(1e-30)[..., None], m3, s3


def _pass_b_3xtf32(q, k, mask, kl, lm_mask, mid, ql, rp, m3):
    lm = lm_mask[:, None, None, :]
    sim1 = torch.where(lm, _mm3(q, kl.transpose(-1, -2)), NEG_INF)
    p1 = torch.where(lm, torch.exp(sim1 - sim1.amax(dim=-1, keepdim=True)), 0.0)
    out = _mm3(p1, mid) / p1.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    sim3 = _mm3(ql, k.transpose(-1, -2))
    cls = (torch.exp(sim3 - m3[..., None]) * rp[..., None]).sum(dim=-2)
    return torch.where(mask[:, None, :, None], out, 0.0), torch.where(mask[:, None, :], cls, 0.0)


def _margin(got, want, rtol, atol):
    """max |got − want| / (atol + rtol·|want|): below 1 passes, and its
    inverse is the room left."""
    return ((got.double() - want).abs() / (atol + rtol * want.abs())).max().item()


def _operands(seed, scaled):
    """K1/K2 operands as chip_smoke.py makes them (q·dh^-½) or as
    kernel_check feeds them (unscaled normals): B 1, H 2, N 4,096, dh 64,
    m 256, 80% of the tokens valid; the glue of flash_nystrom_infer between
    the passes, in fp32."""
    b, h, n, dh, m = 1, 2, 4096, 64, 256
    q, k, v, _, _ = _tensors(seed, b, h, n, dh, m, (int(n * 0.8),), dh ** -0.5 if scaled else 1.0)
    mask = torch.arange(n)[None] < int(n * 0.8)
    q_l, k_l, lm_mask, pinv = fn.landmarks(q, k, mask, m)
    attn3v, m3, s3 = fn.pass_a_plain(q_l, k, v, mask)
    mid, rp = fn.pass_b_operands(q, k_l, mask, lm_mask, pinv, attn3v, s3)
    return dict(q=q, k=k, v=v, mask=mask, q_l=q_l, k_l=k_l, lm_mask=lm_mask, mid=mid, rp=rp, m3=m3)


@pytest.mark.parametrize("scaled", [True, False], ids=["flagship_scaling", "kernel_check_unscaled"])
def test_3xtf32_passes_hold_the_kernel_tolerances(scaled):
    """The 3×TF32 emulation of K1 and K2 against their fp64 plain versions
    at chip_smoke.py's tolerances: attn3v, m3, s3 and out at rtol 1e-4, atol
    1e-5, cls at 1e-4·max|ref|. Margins measured (error over tolerance, below
    1 passes), largest of the outputs: 4.0e-3 at the flagship scaling, 0.130
    (K2's out) at kernel_check's unscaled inputs, where the fp32 plain
    version itself is at 0.185 against fp64: the split is as exact as fp32."""
    o = _operands(1, scaled)
    a_args = (o["q_l"], o["k"], o["v"], o["mask"])
    want_a = fn.pass_a_plain(*(t.double() if t.is_floating_point() else t for t in a_args))
    got_a = _pass_a_3xtf32(*a_args)
    margins = {name: _margin(g, w, 1e-4, 1e-5) for name, g, w in zip(("attn3v", "m3", "s3"), got_a, want_a)}
    b_args = (o["q"], o["k"], o["mask"], o["k_l"], o["lm_mask"], o["mid"], o["q_l"], o["rp"], o["m3"])
    want_out, want_cls = fn.pass_b_plain(*(t.double() if t.is_floating_point() else t for t in b_args))
    got_out, got_cls = _pass_b_3xtf32(*b_args)
    margins["out"] = _margin(got_out, want_out, 1e-4, 1e-5)
    margins["cls"] = (got_cls.double() - want_cls).abs().max().item() / (1e-4 * want_cls.abs().max().item())
    assert max(margins.values()) < 0.5, margins


def test_single_tf32_fails_the_kernel_tolerances():
    """Why three products: K1 with each operand rounded once to TF32 misses
    chip_smoke.py's tolerance at the flagship scaling."""
    o = _operands(1, True)
    ql, k, v, mask = o["q_l"], o["k"], o["v"], o["mask"]
    valid = mask[:, None, None, :]
    sim = torch.where(valid, _tf32(ql) @ _tf32(k).transpose(-1, -2), NEG_INF)
    m3 = sim.amax(dim=-1)
    want = fn.pass_a_plain(ql.double(), k.double(), v.double(), mask)[1]
    assert _margin(m3, want, 1e-4, 1e-5) > 1


def test_3xtf32_flash_nystrom_infer_holds_kernel_checks_tolerance(monkeypatch):
    """kernel_check's flash_nystrom_infer case (1 × 8 × 4,096, dh 64, 256
    landmarks, 80% valid, unscaled normals) with both passes in emulated
    3×TF32, against nystrom_attention: out and attn at rtol 1e-4, atol 1e-5,
    as the check holds the kernels. Margin measured: 0.41, where the fp32
    plain passes give 0.20 (the pseudo-inverse amplifies both)."""
    rng = np.random.default_rng(0)
    b, h, n, dh, m = 1, 8, 4096, 64, 256
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, dh)).astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy(np.arange(n)[None] < int(n * 0.8))
    want_out, want_attn = nystrom_attention(q, k, v, mask, m, return_attn=True)
    monkeypatch.setattr(fn, "pass_a", _pass_a_3xtf32)
    monkeypatch.setattr(fn, "pass_b", _pass_b_3xtf32)
    got_out, got_attn = fn.flash_nystrom_infer(q, k, v, mask, m)
    margin = max(_margin(got_out, want_out.double(), 1e-4, 1e-5),
                 _margin(got_attn, want_attn.double(), 1e-4, 1e-5))
    assert margin < 1, margin
