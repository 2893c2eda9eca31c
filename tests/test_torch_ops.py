"""The port's attention ops against the JAX package on the same numpy inputs.

fp32 on the CPU, where the kernel wrappers run their plain versions.
Tolerance rtol 1e-4, atol 1e-5 unless a test says otherwise: the two
frameworks sum in other orders, and the pseudo-inverse's 6 Newton–Schulz
iterations amplify that a little.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mhim_mil_tpu.ops import masked as jmasked
from mhim_mil_tpu.ops import nystrom as jny
from mhim_mil_tpu.ops.pallas_nystrom import flash_nystrom_infer as j_flash
from mhim_mil_torch.ops import flash_nystrom as fn
from mhim_mil_torch.ops import masked, nystrom

RTOL, ATOL = 1e-4, 1e-5


def _qkv(seed, b, h, n, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, dh)).astype(np.float32) for _ in range(3)]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_masked_softmax_matches_jax_and_zeroes_fully_masked_rows():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7)).astype(np.float32) * 5
    mask = rng.random((3, 7)) > 0.4
    mask[1] = False  # a fully masked row
    got = masked.masked_softmax(torch.from_numpy(logits), torch.from_numpy(mask))
    want = jmasked.masked_softmax(jnp.asarray(logits), jnp.asarray(mask))
    _close(got, want)
    assert torch.all(got[1] == 0)
    assert torch.isfinite(got).all()
    _close(got[[0, 2]].sum(-1), np.ones(2))


def test_pinv_couples_the_bags_of_a_batch():
    """The initial scale is a max over the whole batch: a bag's pseudo-inverse
    depends on the other bags, in the port exactly as in JAX."""
    rng = np.random.default_rng(1)
    small = rng.random((1, 2, 8, 8)).astype(np.float32)
    large = 20 * rng.random((1, 2, 8, 8)).astype(np.float32)
    batch = np.concatenate([small, large])
    got = nystrom.moore_penrose_pinv(torch.from_numpy(batch))
    _close(got, jny.moore_penrose_pinv(jnp.asarray(batch)))
    alone = nystrom.moore_penrose_pinv(torch.from_numpy(small))
    _close(alone, jny.moore_penrose_pinv(jnp.asarray(small)))
    assert (got[0] - alone[0]).abs().max() > 1e-3  # coupled, not per bag


def test_landmark_mean_with_empty_leading_groups():
    """n=41, m=8: l=6 and pad=7, so group 0 is empty even for a full bag."""
    b, h, n, d, m = 2, 2, 41, 4, 8
    t, _, _ = _qkv(2, b, h, n, d)
    mask = np.arange(n)[None] < np.array([[n], [13]])
    t = np.where(mask[:, None, :, None], t, 0).astype(np.float32)
    got, got_lm = nystrom._landmark_mean(torch.from_numpy(t), torch.from_numpy(mask), m)
    want, want_lm = jny._landmark_mean(jnp.asarray(t), jnp.asarray(mask), m)
    _close(got, want)
    np.testing.assert_array_equal(got_lm.numpy(), np.asarray(want_lm))
    assert not got_lm[:, 0].any()
    assert got_lm.sum(1).tolist() == [7, 3]  # tokens 0-4, 5-10, 11-12


@pytest.mark.parametrize("n_valid", [96, 128])
@pytest.mark.parametrize("return_attn", [False, True])
def test_nystrom_attention_matches_jax(n_valid, return_attn):
    b, h, n, dh, m = 2, 2, 128, 32, 16
    q, k, v = _qkv(0, b, h, n, dh)
    mask = np.arange(n)[None] < np.array([[n_valid], [n]])
    got_out, got_attn = nystrom.nystrom_attention(
        *(torch.from_numpy(x) for x in (q, k, v, mask)), m, return_attn=return_attn
    )
    want_out, want_attn = jny.nystrom_attention(
        *(jnp.asarray(x) for x in (q, k, v, mask)), num_landmarks=m, return_attn=return_attn
    )
    _close(got_out, want_out)
    if return_attn:
        _close(got_attn, want_attn)
    else:
        assert got_attn is None


def test_nystrom_attention_unported_modes_raise():
    """The parity and no_norm modes, which raised until they were ported,
    now return out and the cls attention of the right shapes (their values
    against JAX's: tests/test_torch_teacher_stage.py)."""
    q, k, v = (torch.zeros(1, 1, 8, 4) for _ in range(3))
    mask = torch.ones(1, 8, dtype=torch.bool)
    for kw in ({"parity": True}, {"no_norm": True}):
        out, attn = nystrom.nystrom_attention(q, k, v, mask, 4, return_attn=True, **kw)
        assert out.shape == (1, 1, 8, 4) and attn.shape == (1, 1, 8)
        assert torch.isfinite(out).all() and torch.isfinite(attn).all()


@pytest.mark.parametrize(
    "b,h,n,dh,m,lengths",
    [
        (2, 2, 128, 32, 16, (96, 128)),
        (2, 2, 128, 32, 16, (128, 128)),
        (1, 2, 100, 32, 8, (100,)),  # N not a multiple of the TPU kernel's tile
    ],
)
def test_flash_nystrom_infer_matches_jax_interpret(b, h, n, dh, m, lengths):
    """The CPU path (the kernels' plain versions and the torch glue) against
    the Pallas kernels in interpreter mode, at tests/test_pallas_nystrom.py's shapes."""
    q, k, v = _qkv(1, b, h, n, dh)
    mask = np.arange(n)[None] < np.array(lengths)[:, None]
    got_out, got_attn = fn.flash_nystrom_infer(*(torch.from_numpy(x) for x in (q, k, v, mask)), m)
    want_out, want_attn = j_flash(
        *(jnp.asarray(x) for x in (q, k, v, mask)), num_landmarks=m, tile=64, interpret=True
    )
    _close(got_out, want_out)
    _close(got_attn, want_attn)


def test_flash_nystrom_infer_ignores_values_at_masked_tokens():
    """q/k/v may hold anything at masked tokens, even non-finite values."""
    b, h, n, dh, m = 2, 2, 64, 16, 8
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, b, h, n, dh))
    mask = torch.arange(n)[None] < torch.tensor([[40], [64]])
    out, attn = fn.flash_nystrom_infer(q, k, v, mask, m)
    poisoned = [torch.where(mask[:, None, :, None], t, float("nan")) for t in (q, k, v)]
    out2, attn2 = fn.flash_nystrom_infer(*poisoned, mask, m)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    torch.testing.assert_close(attn2, attn, rtol=0, atol=0)


def test_kernel_wrappers_take_the_plain_path_only_on_cpu():
    """On the CPU the wrappers run the plain versions and launch nothing; any
    other device that is not CUDA raises rather than falling back."""
    b, h, n, dh, m = 1, 2, 40, 16, 8
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, b, h, n, dh))
    mask = torch.ones(b, n, dtype=torch.bool)
    before = (fn.pass_a.launches, fn.pass_b.launches)
    fn.flash_nystrom_infer(q, k, v, mask, m)
    assert (fn.pass_a.launches, fn.pass_b.launches) == before
    ql = torch.zeros(b, h, m, dh, device="meta")
    with pytest.raises(ValueError):
        fn.pass_a(ql, k.to("meta"), v.to("meta"), mask.to("meta"))
