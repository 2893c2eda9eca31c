"""K4's one-launch arithmetic on the CPU: ``abmil_pool_chunked_plain``, the
ticketed single pass as the kernel orders it (each block a chunk of a bag,
the last block of the bag merging the chunks in chunk order and writing
pooled and attn), against the JAX package's ``fused_abmil_pool`` in
interpreter mode (as ``tests/test_torch_abmil.py`` runs it) and against
``abmil_pool_plain``; and the chunk plan.

Ragged bags, a fake bag (mask all False), chunk sizes that do not divide N,
NaN at every masked row (never read). Tolerances: pooled rtol 1e-5, atol
1e-5 and attn rtol 1e-5, atol 1e-6, the JAX kernel test's; against
``abmil_pool_plain``, the same function summed in another order, the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.ops.pallas_abmil as jpa
from mhim_mil_torch.ops import abmil_pool


def _bag(seed, b, n, d, lengths, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mask = np.arange(n)[None] < np.array(lengths)[:, None]
    x = np.where(mask[..., None], rng.normal(size=(b, n, d)), np.nan).astype(dtype)
    logits = (3 * rng.normal(size=(b, n))).astype(np.float32)
    return x, logits, mask


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("n,chunk", [(100, 64), (333, 80), (128, 64), (70, 1024), (1000, 16)])
def test_the_single_pass_matches_jax_and_the_plain_pool(n, chunk):
    """The chunked single pass against JAX's kernel (interpreter mode) and
    abmil_pool_plain: the fake bag pools to zero with zero attention, and
    nothing is NaN though every masked row is."""
    b, d = 4, 48
    x, logits, mask = _bag(n, b, n, d, (n, n // 2 + 1, 0, n - 7))
    pooled, attn = abmil_pool.abmil_pool_chunked_plain(*(torch.from_numpy(t) for t in (x, logits, mask)), chunk)
    want_pooled, want_attn = jpa.fused_abmil_pool(jnp.asarray(np.nan_to_num(x)), jnp.asarray(logits),
                                                  jnp.asarray(mask), tile=64, interpret=True)
    _close(pooled, want_pooled, 1e-5)
    _close(attn, want_attn, 1e-6)
    plain_pooled, plain_attn = abmil_pool.abmil_pool_plain(*(torch.from_numpy(t) for t in (x, logits, mask)))
    _close(pooled, plain_pooled.numpy(), 1e-5)
    _close(attn, plain_attn.numpy(), 1e-6)
    assert torch.all(pooled[2] == 0) and torch.all(attn[2] == 0)
    assert torch.isfinite(pooled).all() and torch.isfinite(attn).all()


def test_the_single_pass_takes_bf16_rows():
    """bf16 x, read in its own type and summed in fp32, against JAX's kernel
    on the same bf16 values."""
    x, logits, mask = _bag(5, 3, 200, 32, (200, 64, 199))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    pooled, attn = abmil_pool.abmil_pool_chunked_plain(xb, torch.from_numpy(logits), torch.from_numpy(mask), 48)
    want_pooled, want_attn = jpa.fused_abmil_pool(jnp.asarray(np.nan_to_num(xb.float().numpy())),
                                                  jnp.asarray(logits), jnp.asarray(mask), tile=64, interpret=True)
    _close(pooled, want_pooled, 1e-5)
    _close(attn, want_attn, 1e-6)


@pytest.mark.parametrize("b,n", [(4, 10240), (1, 10240), (4, 6000), (16, 10240), (1, 100), (2, 3_000_000)])
def test_the_chunk_plan(b, n):
    """Chunks of 16 tokens' multiples from 64 to 1,024, at most 4,096 a bag,
    and at the flagship's batch 4 × 10,240 about two blocks an SM of the
    H100 (256 blocks: 160 tokens, 64 chunks a bag)."""
    chunk = abmil_pool.abmil_plan(b, n)
    nchunks = -(-n // chunk)
    assert chunk % 16 == 0 or chunk == -(-n // abmil_pool.MAX_CHUNKS)
    assert abmil_pool.MIN_CHUNK <= chunk <= abmil_pool.MAX_CHUNK and nchunks <= abmil_pool.MAX_CHUNKS
    if (b, n) == (4, 10240):
        assert (chunk, nchunks, b * nchunks) == (160, 64, 256)


def test_the_chunk_plan_refuses_bags_past_its_reach():
    with pytest.raises(ValueError, match="instances a bag"):
        abmil_pool.abmil_plan(1, abmil_pool.MAX_CHUNK * abmil_pool.MAX_CHUNKS + 1)


def test_the_card_branch_is_one_launch_for_the_pool_and_attn(monkeypatch):
    """The wrapper's card branch, its launch replaced by the chunked single
    pass at the planned chunk: pooled and attn both come from the launch
    (nothing recomputed after it), one call counted, against JAX."""
    calls = []

    def launch(x, logits, mask):
        calls.append(x.shape)
        return abmil_pool.abmil_pool_chunked_plain(x, logits, mask, abmil_pool.abmil_plan(*x.shape[:2]))

    monkeypatch.setattr(abmil_pool, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(abmil_pool, "_launch", launch)
    x, logits, mask = _bag(9, 3, 700, 40, (700, 333, 0))
    before = abmil_pool.fused_abmil_pool.launches
    with torch.no_grad():
        pooled, attn = abmil_pool.fused_abmil_pool(*(torch.from_numpy(t) for t in (x, logits, mask)))
    assert abmil_pool.fused_abmil_pool.launches == before + 1 and calls == [(3, 700, 40)]
    want_pooled, want_attn = jpa.fused_abmil_pool(jnp.asarray(np.nan_to_num(x)), jnp.asarray(logits),
                                                  jnp.asarray(mask), tile=64, interpret=True)
    _close(pooled, want_pooled, 1e-5)
    _close(attn, want_attn, 1e-6)
