"""K3p's arithmetic on the CPU: the Newton–Schulz pseudo-inverse as the
kernel runs it (four fused products an iteration, eight in the reverse
sweep, ``ops/nystrom_pinv.py`` with the plain product ``pinv_product_plain``
in place of the kernel) against the JAX package's ``moore_penrose_pinv``
(``mhim_mil_tpu/ops/nystrom.py:33``) and ``jax.vjp`` of it, and
``NewtonSchulz`` against torch autograd through the port's
``moore_penrose_pinv``.

Inputs: random [2, 3, 32, 32] matrices; the masked attn2 of the glue from a
ragged mask with empty landmark groups; m 40 zero-padded to a 64-column
tile. Against JAX: rtol 1e-4, atol 1e-5 on the pseudo-inverse (fp32 in both
frameworks, sums in other orders, amplified a little by 6 iterations), and
the gradient at max|d| <= 1e-4·max|ref|. The attn2 given to JAX has its
rows scaled apart (``_untied``): a softmax's row sums tie or nearly tie at 1, and
the initial scale's max would send its gradient to whichever rows tie in
each framework's own rounding. Against torch autograd: fp64, where the two
orders of the same products agree to 1e-12 of max|ref|.

The kernel gate's ``flash_nystrom_infer`` criterion (``kernel_check``:
``vjp_close`` against the fp64 plain attention) at its full shape and draws:
it passes the fp32 plain path and K3p's products in emulated 3×TF32, and
rejects both of its controls (the pinv's products in single TF32, 5
iterations for 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_torch.ops import flash_nystrom as fn
from mhim_mil_torch.ops import nystrom_pinv as npv
from mhim_mil_torch.ops.masked import masked_softmax
from mhim_mil_torch.ops.nystrom import _landmark_mean, moore_penrose_pinv, nystrom_attention, pinv_start
from mhim_mil_torch.utils import kernel_check
from mhim_mil_tpu.ops import nystrom as jny
from test_torch_flash_passes import _mm3

RTOL, ATOL = 1e-4, 1e-5


def _attn2(b, h, n, dh, m, lengths, seed, dtype=torch.float32):
    """The glue's attn2 = masked softmax(q_l·k_lᵀ) over the valid landmarks."""
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(b, h, n, dh, generator=g, dtype=torch.float64) for _ in range(2))
    mask = torch.arange(n)[None] < torch.tensor(lengths)[:, None]
    mv = mask[:, None, :, None]
    q_l, lm_mask = _landmark_mean(torch.where(mv, q * dh ** -0.5, 0.0), mask, m)
    k_l, _ = _landmark_mean(torch.where(mv, k, 0.0), mask, m)
    x = masked_softmax(q_l @ k_l.transpose(-1, -2), lm_mask[:, None, None, :]).to(dtype)
    return x, lm_mask


def _untied(x):
    """x with the rows of all its matrices scaled apart, row r of the
    flattened batch by 1 + r/(4·rows): one argmax for the initial scale,
    whose max runs over every matrix of the batch."""
    rows = x.numel() // x.shape[-1]
    return x * (1 + torch.arange(rows, dtype=x.dtype) / (4 * rows)).reshape(*x.shape[:-1], 1)


def _inputs(kind):
    if kind == "random":
        return torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 32, 32)).astype(np.float32))
    if kind == "masked attn2":  # bag 1 is 150 of 300 tokens: its last landmark groups are empty
        x, lm_mask = _attn2(2, 3, 300, 16, 32, (300, 150), seed=1)
        assert not lm_mask.all()
        return _untied(x)
    x, _ = _attn2(2, 2, 333, 16, 40, (333, 101), seed=2)  # m 40
    return _untied(x)


def _pinv_through_the_mirror(x, iters=6):
    """The pseudo-inverse as K3p runs it: the start, then newton_schulz."""
    x, z0 = pinv_start(x)
    return npv.newton_schulz(x, z0, iters)[0]


def _grad_through_the_mirror(x, cot, iters=6):
    """The VJP as K3p runs it: newton_schulz_backward's sweep for x and z0,
    and autograd through the start for z0's share."""
    xx = x.clone().requires_grad_()
    x1, z0 = pinv_start(xx)
    _, saved = npv.newton_schulz(x1.detach(), z0.detach(), iters, keep=True)
    dx, dz0 = npv.newton_schulz_backward(x1.detach(), saved, cot)
    (g,) = torch.autograd.grad((x1, z0), xx, (dx, dz0))
    return g


@pytest.mark.parametrize("kind", ["random", "masked attn2", "m 40"])
def test_the_mirror_matches_jax_moore_penrose_pinv(kind):
    """The four fused products of each iteration against JAX's
    moore_penrose_pinv: rtol 1e-4, atol 1e-5."""
    x = _inputs(kind)
    got = _pinv_through_the_mirror(x)
    want = jny.moore_penrose_pinv(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=RTOL * float(jnp.abs(want).max()))


@pytest.mark.parametrize("kind", ["random", "masked attn2", "m 40"])
def test_the_reverse_sweep_matches_jax_vjp(kind):
    """The 8-product reverse sweep, with autograd through the initial scale
    for z0's share, against jax.vjp of JAX's moore_penrose_pinv under the
    same random cotangent: max|d| <= 1e-4·max|ref| at every nonzero entry
    of x. At x = 0 (attn2's empty landmarks) |x| has no derivative: torch
    takes 0 there and JAX 1, so the scale's share differs by convention
    (and the softmax before attn2 passes neither on)."""
    x = _inputs(kind)
    cot = torch.from_numpy(np.random.default_rng(5).normal(size=x.shape).astype(np.float32))
    got = _grad_through_the_mirror(x, cot).numpy()
    _, vjp = jax.vjp(jny.moore_penrose_pinv, jnp.asarray(x.numpy()))
    (want,) = vjp(jnp.asarray(cot.numpy()))
    want = np.asarray(want)
    nz = x.numpy() != 0
    assert (kind == "random") == nz.all()
    assert np.abs(got - want)[nz].max() <= 1e-4 * np.abs(want).max()


def test_zero_padding_to_the_tile_is_exact():
    """m 40 padded with zeros to 64, as the kernel's edge tiles read it: the
    padded rows and columns stay zero through every c·I − M of the forward
    and the reverse sweep, and the 40 × 40 block is the unpadded result
    (fp64: to 1e-12 of max|ref|, sums over other lengths)."""
    x = _inputs("m 40").double()
    cot = torch.from_numpy(np.random.default_rng(6).normal(size=x.shape))
    pad = lambda t: torch.nn.functional.pad(t, (0, 24, 0, 24))
    x1, z0 = pinv_start(x)
    z, saved = npv.newton_schulz(x1, z0, 6, keep=True)
    zp, saved_p = npv.newton_schulz(pad(x1), pad(z0), 6, keep=True)
    dx, dz0 = npv.newton_schulz_backward(x1, saved, cot)
    dxp, dz0p = npv.newton_schulz_backward(pad(x1), saved_p, pad(cot))
    for got, want in ((zp, z), (dxp, dx), (dz0p, dz0)):
        assert torch.all(got[..., 40:, :] == 0) and torch.all(got[..., :, 40:] == 0)
        assert (got[..., :40, :40] - want).abs().max() <= 1e-12 * want.abs().max()
    for t in (t for s in saved_p for t in s):
        assert torch.all(t[..., 40:, :] == 0) and torch.all(t[..., :, 40:] == 0)


@pytest.mark.parametrize("kind", ["random", "softmax attn2", "m 30"])
def test_newton_schulz_matches_autograd_through_moore_penrose_pinv(kind):
    """newton_schulz_pinv (pinv_start under autograd, then NewtonSchulz on
    the plain products; m 30 zero-padded to 32 as on the card) against the
    port's moore_penrose_pinv and torch autograd through it, in fp64: the
    pseudo-inverse and the gradient for x, through z0 and the scale's max
    included (the softmax attn2's row sums tie: the same torch ops give the
    same ties), to 1e-12 of max|ref|."""
    if kind == "random":
        x = _inputs("random").double()
    else:
        x, _ = _attn2(2, 3, 300, 16, 32 if kind == "softmax attn2" else 30, (300, 150), seed=3,
                      dtype=torch.float64)
    cot = torch.from_numpy(np.random.default_rng(7).normal(size=x.shape))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = npv.newton_schulz_pinv(xa), moore_penrose_pinv(xb)
    (g,) = torch.autograd.grad(got, xa, cot)
    (w,) = torch.autograd.grad(want, xb, cot)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    assert (g - w).abs().max() <= 1e-12 * w.abs().max()


def test_the_iterations_are_products_only(monkeypatch):
    """The forward is one program of four products an iteration and the
    backward one of eight, and nothing else touches the matrices between
    them: 24 and 48 at the default 6 iterations; no iterate is kept without
    a gradient."""
    programs = []
    run = npv.pinv_program
    monkeypatch.setattr(npv, "pinv_program", lambda products: programs.append(len(products)) or run(products))
    x = _inputs("random").double().requires_grad_()
    with torch.no_grad():
        z, saved = npv.newton_schulz(*pinv_start(x), 6, keep=False)
    assert programs == [24] and saved.shape[0] == 0
    z = npv.newton_schulz_pinv(x)
    assert programs == [24, 24]
    z.backward(torch.ones_like(z))
    assert programs == [24, 24, 48]


def test_pinv_plan_fills_the_card():
    """The tile plan: 64 × 64 where its grid has a block for three quarters
    of the H100's SMs (128 blocks and more: m 256 at batch 1, 2 and 4, the
    gate's m 128 at G 32), 32 × 32 below (m 128 at G 16 and 8, m 40)."""
    assert npv.TILES == ((64, 64), (32, 32))
    for g, m, tile in ((32, 256, 64), (16, 256, 64), (8, 256, 64), (32, 128, 64), (16, 128, 32),
                       (8, 128, 32), (8, 40, 32)):
        assert npv.pinv_plan(g, m) == (tile, tile), (g, m)
        assert (g * ((m + 63) // 64) ** 2 >= 99) == (tile == 64)


def test_pseudo_inverse_on_the_cpu_is_moore_penrose_pinv():
    """CPU tensors keep the plain pseudo-inverse, bit for bit."""
    x = _inputs("masked attn2")
    assert torch.equal(npv.pseudo_inverse(x), moore_penrose_pinv(x))


@pytest.fixture(scope="module")
def infer_full_case():
    """kernel_check's flash_nystrom_infer draws (1 × 8 × 4,096, dh 64, 256
    landmarks, 80% valid) on the CPU, and the fp64 plain attention on them."""
    q, k, v, mask, m = kernel_check.infer_case(False, "cpu")
    want64 = nystrom_attention(q.double(), k.double(), v.double(), mask, m, return_attn=True)
    return q, k, v, mask, m, want64


def _product_3xtf32(a, b, alpha=1.0, diag=0.0, ta=False, tb=False, c=None, beta=0.0):
    """pinv_product_plain with its product on the kernel's 3×TF32 operands."""
    a = a.transpose(-1, -2) if ta else a
    b = b.transpose(-1, -2) if tb else b
    if diag:
        b = b + diag * torch.eye(b.shape[-1], dtype=b.dtype)
    d = alpha * _mm3(a, b)
    return d + beta * c if beta else d


@pytest.mark.parametrize("pinv", ["fp32 plain", "K3p in 3xTF32"])
def test_infer_criterion_passes_the_fp32_path_and_k3p_arithmetic(monkeypatch, infer_full_case, pinv):
    """flash_nystrom_infer on the CPU (the plain passes) with the fp32
    moore_penrose_pinv, or with K3p's products in emulated 3×TF32, passes
    the gate's criterion on out and attn against fp64 (measured: 0.240 and
    0.226 of the allowance on out)."""
    q, k, v, mask, m, want64 = infer_full_case
    if pinv == "K3p in 3xTF32":
        monkeypatch.setattr(fn, "pseudo_inverse", npv.newton_schulz_pinv)
        monkeypatch.setattr(npv, "pinv_product_plain", _product_3xtf32)
    for g, g64 in zip(fn.flash_nystrom_infer(q, k, v, mask, m), want64):
        r = kernel_check.vjp_close(g, g64)
        assert r["ok"] and r["of_allowance"] < 0.5, r


def test_infer_criterion_rejects_its_controls(infer_full_case):
    """Each control of the gate's infer check misses the criterion on out in
    more than 100,000 of its 2,097,152 entries (measured: 1,276,402 in
    single TF32 at 56.7 times the allowance, 1,676,562 at 5 iterations)."""
    controls = kernel_check.infer_controls(*infer_full_case)
    assert set(controls) == {"pinv products in single TF32", "pinv of 5 iterations"}
    for name, parts in controls.items():
        assert parts["out"]["n_bad"] > 100_000 and parts["out"]["of_allowance"] > 10, (name, parts["out"])
