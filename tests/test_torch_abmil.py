"""The port's ABMIL pooling (K4 and the two pools), its DAttention baseline
and the MHIM ``attn`` path against the JAX package on the same numpy inputs.

fp32 on the CPU, where ``fused_abmil_pool`` runs its plain version; the JAX
side runs the Pallas kernel in interpreter mode. Ragged bags and a fake bag
(mask all False). K4 at rtol 1e-5 (atol 1e-5 pooled, 1e-6 attn), the JAX
kernel test's tolerance; modules at rtol 1e-4, atol 1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.ops.pallas_abmil as jpa
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.baselines import DAttentionBaseline as JDAttention
from mhim_mil_tpu.models.layers import GatedAttentionPool as JGated, TanhAttentionPool as JTanh
from mhim_mil_tpu.models.mhim import MHIM as JMHIM
from mhim_mil_torch.config import load_config
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.models.baselines import DAttentionBaseline
from mhim_mil_torch.models.layers import GatedAttentionPool, TanhAttentionPool
from mhim_mil_torch.ops import abmil_pool
from mhim_mil_torch.utils.serving import Scorer
from mhim_mil_torch.utils.weights import state_dict_from_flax

RTOL, ATOL = 1e-4, 1e-5
DIM, IN_DIM = 32, 16


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _bags(seed, b, n, d, lengths):
    g = np.random.default_rng(seed)
    x = g.normal(size=(b, n, d)).astype(np.float32)
    return x, np.arange(n)[None] < np.array(lengths)[:, None]


def _lin(p):
    sd = {"weight": torch.from_numpy(np.array(p["kernel"]).T.copy())}
    if "bias" in p:
        sd["bias"] = torch.from_numpy(np.array(p["bias"]))
    return sd


def _load(module, named):
    sd = {f"{name}.{k}": v for name, p in named.items() for k, v in _lin(p).items()}
    module.load_state_dict(sd)
    return module


@pytest.mark.parametrize("n,tile", [(128, 64), (100, 64)])
def test_abmil_pool_plain_matches_the_pallas_kernel(n, tile):
    """K4's plain version against fused_abmil_pool in interpreter mode (a
    remainder tile at n=100), ragged bags and a fake bag, which pools to zero
    with zero attention and no NaN."""
    b, d = 4, 32
    x, mask = _bags(0, b, n, d, (n, n // 2, 0, n - 7))
    logits = (3 * np.random.default_rng(1).normal(size=(b, n))).astype(np.float32)
    want_pooled, want_attn = jpa.fused_abmil_pool(jnp.asarray(x), jnp.asarray(logits), jnp.asarray(mask),
                                                  tile=tile, interpret=True)
    pooled, attn = abmil_pool.fused_abmil_pool(torch.from_numpy(x), torch.from_numpy(logits),
                                               torch.from_numpy(mask))
    _close(pooled, want_pooled, rtol=1e-5, atol=1e-5)
    _close(attn, want_attn, rtol=1e-5, atol=1e-6)
    assert torch.all(pooled[2] == 0) and torch.all(attn[2] == 0)
    assert torch.isfinite(pooled).all() and torch.isfinite(attn).all()


def test_abmil_pool_ignores_masked_instances():
    x, mask = _bags(2, 2, 96, 16, (60, 96))
    logits = np.random.default_rng(3).normal(size=(2, 96)).astype(np.float32)
    p1, a1 = abmil_pool.fused_abmil_pool(*(torch.from_numpy(t) for t in (x, logits, mask)))
    x2 = np.where(mask[..., None], x, np.nan).astype(np.float32)
    l2 = np.where(mask, logits, 1e3).astype(np.float32)
    p2, a2 = abmil_pool.fused_abmil_pool(*(torch.from_numpy(t) for t in (x2, l2, mask)))
    torch.testing.assert_close(p2, p1, rtol=0, atol=0)
    torch.testing.assert_close(a2, a1, rtol=0, atol=0)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("training,branches", [(False, 1), (True, 1), (False, 2)])
def test_attention_pools_match_jax(monkeypatch, gated, training, branches):
    """Both pools, on the K4 path (eval, one branch) and the differentiable
    plain path (training, or two branches); the JAX side runs its kernel in
    interpreter mode where it would on a TPU."""
    x, mask = _bags(4, 3, 70, DIM, (70, 33, 0))
    jcls, cls = (JGated, GatedAttentionPool) if gated else (JTanh, TanhAttentionPool)
    jm = jcls(attn_dim=16, n_branches=branches, act="gelu", use_flash=True)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    p = jax.tree.map(np.asarray, v["params"])
    names = ({"attention_a.0": p["attn_a"], "attention_b.0": p["attn_b"], "attention_c": p["attn_c"]} if gated
             else {"attention.0": p["attn_a"], "attention.2": p["attn_c"]})
    port = _load(cls(DIM, attn_dim=16, n_branches=branches, act="gelu"), names)
    monkeypatch.setattr(jpa, "FORCE_INTERPRET", True)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), training=training)
    got = port(torch.from_numpy(x), torch.from_numpy(mask), training, torch.Generator())
    for g, w in zip(got, want):
        _close(g, w)


def test_dattention_baseline_matches_jax():
    x, mask = _bags(5, 3, 64, DIM, (64, 20, 0))
    jm = JDAttention(DIM, "gelu")
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))
    p = jax.tree.map(np.asarray, v["params"])["attention"]
    port = _load(DAttentionBaseline(DIM, "gelu"), {"attention.attention.0": p["attn_a"],
                                                   "attention.attention.2": p["attn_c"]})
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), return_attn=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask), return_attn=True)
    for key in ("cls_feat", "attn", "act"):
        _close(got[key], want[key])
    assert "bias" not in dict(port.attention.attention[0].named_parameters())


@pytest.fixture(scope="module")
def attn_pair():
    """A flax MHIM-attn and the port's, on the same weights (global_q included)."""
    kw = dict(baseline="attn", input_dim=IN_DIM, inner_dim=DIM, n_heads=2, compute_dtype="float32")
    jcfg = j_load_config(["-c", "config/mhim_c16.yaml"], use_flash_attn=True, **kw)
    jmodel, _ = j_build_model(jcfg)
    x, mask = _bags(6, 2, 64, IN_DIM, (64, 40))
    rngs = {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    variables = jax.jit(partial(jmodel.init, training=True))(
        rngs, jnp.asarray(x), jnp.asarray(mask), jnp.zeros(mask.shape, jnp.float32))
    params = jax.tree.map(np.asarray, variables["params"])
    cfg = load_config(["-c", "config/mhim_c16.yaml"], **kw)
    model, _ = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, jax.tree.map(np.asarray, variables["buffers"])))
    return jmodel, params, model, cfg


def test_mhim_attn_eval_paths_run_k4_and_match_jax(attn_pair, monkeypatch):
    """forward_test and the eval-mode teacher of MHIM-attn go through
    fused_abmil_pool once each and match JAX's kernel path (interpreter
    mode); the fake bag gets zero attention."""
    jmodel, params, model, _ = attn_pair
    calls = []
    monkeypatch.setattr(layers, "fused_abmil_pool", lambda *a: calls.append(1) or abmil_pool.fused_abmil_pool(*a))
    monkeypatch.setattr(jpa, "FORCE_INTERPRET", True)
    x, mask = _bags(7, 3, 90, IN_DIM, (90, 57, 0))
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), return_attn=True,
                        method=JMHIM.forward_test)
    got = model.forward_test(torch.from_numpy(x), torch.from_numpy(mask), return_attn=True)
    _close(got["logits"], want["logits"])
    _close(got["attn"], want["attn"])
    assert torch.all(got["attn"][2] == 0)
    want_cls, want_score = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                                        method=JMHIM.forward_teacher)
    got_cls, got_score = model.forward_teacher(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got_cls, want_cls)
    _close(got_score, want_score)
    assert len(calls) == 2


def test_scorer_serves_mhim_attn(attn_pair):
    """The Scorer serves the attn baseline as it serves selfattn: the request
    padded into its bucket equals forward_test on the padded batch."""
    jmodel, params, model, cfg = attn_pair
    x, mask = _bags(8, 2, 50, IN_DIM, (50, 31))
    got = Scorer(cfg, model, buckets=(64,), device="cpu").score(x, mask)["logits"]
    xp = np.concatenate([x, np.zeros((2, 14, IN_DIM), np.float32)], axis=1)
    mp = np.concatenate([mask, np.zeros((2, 14), bool)], axis=1)
    want = jmodel.apply({"params": params}, jnp.asarray(xp), jnp.asarray(mp), method=JMHIM.forward_test)
    _close(got, want["logits"])
