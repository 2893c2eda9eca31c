"""The port's streamed Nystrom attention and ``NystromMSA``'s dispatch
against the JAX package on the CPU.

The same numpy inputs go through JAX's ``nystrom_attention_streamed`` and
the port's: ``out`` and the cls row within atol 1e-5, the gradients of a
weighted sum of both with respect to q, k and v within 1e-4 of max|g|, at
windows of 16 tokens whose last one is clamped onto the one before, on
ragged bags; against the port's materialising op at the same tolerance;
under a bf16 compute dtype within 2e-2. Then ``NystromMSA`` with its
``stream_min_len`` lowered to the bag's length against JAX's layer (which
takes its streamed path there), and the paths it selects. Small widths:
2 heads of 8, 8 landmarks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_tpu.models import transformer as jtransformer
from mhim_mil_tpu.ops import nystrom as jnystrom
from mhim_mil_torch.models import transformer
from mhim_mil_torch.ops import nystrom
from mhim_mil_torch.utils import weights

H, DH, M = 2, 8, 8


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qkv(seed, n, lengths):
    """Sequence-major q (scaled), k, v ``[B, N, H, dh]`` zero at masked tokens, and the mask."""
    rng = np.random.default_rng(seed)
    mask = np.arange(n)[None] < np.array(lengths)[:, None]
    q, k, v = (np.where(mask[:, :, None, None], rng.normal(size=(len(lengths), n, H, DH)), 0).astype(np.float32)
               for _ in range(3))
    return q * DH ** -0.5, k, v, mask


CASES = {  # (n, lengths, chunk)
    "clamped-tail": (50, (50, 31), 16),  # windows at 0, 16, 32 and 34
    "whole-windows": (48, (48, 17), 16),
    "one-window": (21, (21, 9), 1024),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pre_masked", [True, False], ids=["pre-masked", "masked-here"])
def test_streamed_matches_jax(case, pre_masked):
    """out, the cls row and their gradients against JAX's streamed op, and
    out and the cls row against the port's materialising op."""
    n, lengths, chunk = CASES[case]
    q, k, v, mask = _qkv(n, n, lengths)
    rng = np.random.default_rng(1)
    w_out = rng.normal(size=(len(lengths), n, H * DH)).astype(np.float32)
    w_cls = rng.normal(size=(len(lengths), H, n)).astype(np.float32)

    def j_loss(q_, k_, v_):
        out, cls = jnystrom.nystrom_attention_streamed(q_, k_, v_, jnp.asarray(mask), M, return_attn=True,
                                                       chunk=chunk, pre_masked=pre_masked)
        return jnp.sum(out * w_out) + jnp.sum(cls * w_cls), (out, cls)

    jgrads, (want_out, want_cls) = jax.grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out, cls = nystrom.nystrom_attention_streamed(tq, tk, tv, _t(mask), M, return_attn=True, chunk=chunk,
                                                  pre_masked=pre_masked)
    assert out.shape == (len(lengths), n, H * DH) and cls.shape == (len(lengths), H, n)
    assert cls.dtype == torch.float32 and torch.all(out[1, lengths[1]:] == 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cls.detach().numpy(), np.asarray(want_cls), rtol=0, atol=1e-5)
    ((out * _t(w_out)).sum() + (cls * _t(w_cls)).sum()).backward()
    for name, t, g in zip("qkv", (tq, tk, tv), jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=name)

    ref_out, ref_cls = nystrom.nystrom_attention(*(_t(a).transpose(1, 2) for a in (q, k, v)), _t(mask), M,
                                                 return_attn=True)
    np.testing.assert_allclose(out.detach().numpy(), ref_out.transpose(1, 2).reshape(out.shape).numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(cls.detach().numpy(), ref_cls.numpy(), rtol=0, atol=1e-5)


def test_streamed_casts_to_the_compute_dtype():
    """``compute_dtype=bfloat16``: q, k, v and attn1 in bf16, out in bf16,
    the cls row in fp32, both within 2e-2 of JAX's under the same cast."""
    q, k, v, mask = _qkv(3, 50, (50, 31))
    want_out, want_cls = jnystrom.nystrom_attention_streamed(
        *(jnp.asarray(a) for a in (q, k, v, mask)), M, return_attn=True, chunk=16, compute_dtype=jnp.bfloat16)
    out, cls = nystrom.nystrom_attention_streamed(*(_t(a) for a in (q, k, v, mask)), M, return_attn=True,
                                                  chunk=16, compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and cls.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want_out, np.float32), rtol=0, atol=2e-2)
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), rtol=0, atol=2e-2)


def test_landmark_means_match_the_head_major_ones():
    """``_landmark_mean_seq`` gives ``_landmark_mean``'s groups on the
    transposed tensor, fewer tokens than landmarks included."""
    for n, lengths in ((50, (50, 31)), (5, (5, 2))):
        q, _, _, mask = _qkv(n, n, lengths)
        got, got_m = nystrom._landmark_mean_seq(_t(q), _t(mask), M)
        want, want_m = nystrom._landmark_mean(_t(q).transpose(1, 2), _t(mask), M)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        assert torch.equal(got_m, want_m)
        np.testing.assert_allclose(got.numpy(), np.asarray(jnystrom._landmark_mean_seq(
            jnp.asarray(q), jnp.asarray(mask), M)[0]), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def msa_pair():
    """JAX's NystromMSA (dim 32, 2 heads of 16, 8 landmarks) streaming from
    32 tokens, its params, and the port's layer on the same weights."""
    x = np.random.default_rng(0).normal(size=(2, 40, 32)).astype(np.float32)
    mask = np.arange(40)[None] < np.array([40, 33])[:, None]
    jm = jtransformer.NystromMSA(dim=32, heads=2, dim_head=16, num_landmarks=8, stream_min_len=32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"])
    sd = {}
    weights._linear(sd, "to_qkv", params["to_qkv"])
    weights._linear(sd, "to_out.0", params["to_out"])
    weights._conv(sd, "res_conv", params["res_conv"])
    port = transformer.NystromMSA(32, 2, 16, 8, stream_min_len=32)
    port.load_state_dict(sd)
    return jm, params, port, x, mask


@pytest.mark.parametrize("return_attn", [False, True], ids=["out", "attn"])
def test_nystrom_msa_streams_as_jax_does(msa_pair, monkeypatch, return_attn):
    """At 40 tokens, ``stream_min_len`` 32: the port's layer takes the
    streamed op (the materialising op and the kernels refuse to run) and
    gives JAX's out, cls row, values and scored values within 1e-5."""
    jm, params, port, x, mask = msa_pair
    assert port.path(40, on_cuda=False) == "streamed"

    def refuse(*a, **k):
        raise AssertionError("not the streamed path")

    for name in ("nystrom_attention", "flash_nystrom", "flash_nystrom_infer"):
        monkeypatch.setattr(transformer, name, refuse)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), return_attn=return_attn)
    with torch.no_grad():
        got = port(_t(x), _t(mask), return_attn)
    for g, w in zip((got,) if not return_attn else got, (want,) if not return_attn else want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_nystrom_msa_paths():
    """Which path the layer takes: the kernels with ``use_flash`` on CUDA
    tensors; then the streamed op from ``stream_min_len`` tokens; below it
    the kernels' wrappers under ``use_flash`` (their plain versions on the
    CPU), else the materialising op, which ``parity`` and ``no_norm``
    always take."""
    msa = transformer.NystromMSA(32, 2, 16, 8)
    assert msa.stream_min_len == 4096
    assert [msa.path(n, cuda) for n, cuda in ((4096, True), (100, True), (4096, False), (4095, False))] == \
        ["kernels", "kernels", "streamed", "kernels"]
    assert msa.path(10_000, True, no_norm=True) == msa.path(10_000, False, no_norm=True) == "materialising"
    plain = transformer.NystromMSA(32, 2, 16, 8, use_flash=False)
    assert [plain.path(n, True) for n in (4096, 4095)] == ["streamed", "materialising"]
    parity = transformer.NystromMSA(32, 2, 16, 8, parity=True)
    assert parity.path(10_000, True) == parity.path(10_000, False) == "materialising"
