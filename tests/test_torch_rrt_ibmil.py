"""The port's RRT-MIL and IBMIL against the JAX package's, fp32 on the CPU.

The JAX weights are initialised by flax and carried into the port by
``rrtmil_state_from_flax`` / ``ibmil_state_from_flax``. Covered: the port's
copy of the k-means confounder builder (equal to the JAX package's bit for
bit); RRT's region partition and its inverse; the attention within a
region with its EPEG convolution (odd and even kernels); RRT-MIL with the
tanh and the gated pool, ``region_num`` 2 (at 48 tokens ``region_num`` 8
leaves one token a region); two SGD steps of RRT-MIL through the generic
train step against JAX's (dropout patched to the identity); IBMIL with and
without a bank; the ``--confounder_path`` resolution (a file, a directory,
its ``0/``, a list); the weight maps both ways; and the ``Scorer`` of IBMIL
against JAX's serving closure. Small widths: input_dim 16, inner_dim 32,
2 heads, bags of up to 48 instances with ragged and empty bags. Tolerance
rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models import rrt as jrrt
from mhim_mil_tpu.utils import confounders as jconf
from mhim_mil_tpu.utils.torch_import import IMPORTERS
from mhim_mil_torch.config import load_config
from mhim_mil_torch.models import build_model, rrt
from mhim_mil_torch.models.ibmil import IBMIL
from mhim_mil_torch.utils import confounders, weights
from test_torch_clam_dtfd import (CFG, DIM, IN_DIM, N, _assert_trees_equal, _batch, _close, _np, _t,
                                  two_sgd_steps_match_jax)

RRT = dict(region_num=2, rrt_n_heads=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: beside the other test workers its
    thread pool spins against theirs, and a tiny run takes 10–100× longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_dropout(monkeypatch):
    import flax.linen

    from mhim_mil_torch.models import layers

    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)


# ---- the confounder bank ------------------------------------------------------------------


@pytest.mark.parametrize("n,k,seed", [(60, 8, 0), (5, 8, 1), (40, 3, 7)], ids=["60-in-8", "5-in-8-jitter", "40-in-3"])
def test_kmeans_equals_jax_bit_for_bit(tmp_path, n, k, seed):
    x = np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32)
    got = confounders.kmeans(x, k, seed=seed)
    want = jconf.kmeans(x, k, seed=seed)
    assert got.dtype == np.float32 and got.shape == (k, 6)
    np.testing.assert_array_equal(got, want)
    out = confounders.build_confounders(x, k, str(tmp_path / "bank.npy"), seed=seed)
    np.testing.assert_array_equal(np.load(tmp_path / "bank.npy"), out)
    np.testing.assert_array_equal(out, want)


# ---- RRT ---------------------------------------------------------------------------------


@pytest.mark.parametrize("n,region_num", [(48, 2), (50, 3), (64, 8), (10, 4)])
def test_region_partition_and_reverse_match_jax(n, region_num):
    g = np.random.default_rng(n)
    x = g.normal(size=(3, n, 5)).astype(np.float32)
    mask = np.arange(n)[None] < np.array([n, n // 2, 0])[:, None]
    jx, jm, jgeo = jrrt.region_partition(jnp.asarray(x), jnp.asarray(mask), region_num)
    px, pm, geo = rrt.region_partition(_t(x), _t(mask), region_num)
    assert geo == jgeo
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    back = rrt.region_reverse(px, geo, n)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jrrt.region_reverse(jx, jgeo, n)))
    np.testing.assert_array_equal(back.numpy(), x * mask[..., None])


@pytest.mark.parametrize("epeg_k", [5, 4])
def test_inner_attention_with_epeg_matches_jax(epeg_k):
    """The depthwise convolution over the query axis of the logits, padded
    as XLA's SAME pads (one more row below for an even kernel), through
    ``_conv``'s weight layout."""
    g = np.random.default_rng(epeg_k)
    x = g.normal(size=(3, 9, DIM)).astype(np.float32)
    mask = np.arange(9)[None] < np.array([9, 4, 0])[:, None]
    jm = jrrt.InnerAttention(DIM, 2, epeg=True, epeg_k=epeg_k)
    p = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"])
    port = rrt.InnerAttention(DIM, 2, epeg=True, epeg_k=epeg_k)
    sd = {}
    weights._rrt_inner_attention(sd, "x", p)
    port.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(_t(x), _t(mask))
    _close(got, jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)))
    assert torch.all(got[2] == 0)


def _rrt_pair(seed, **kw):
    jm, jfam = j_build_model(j_load_config([], model="rrtmil", **CFG, **RRT, **kw))
    b = _batch(seed)
    params = _np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(b["feats"]), jnp.asarray(b["mask"]))["params"])
    port, fam = build_model(load_config([], model="rrtmil", **CFG, **RRT, **kw), device="cpu")
    assert fam == jfam == "default"
    port.load_state_dict(weights.rrtmil_state_from_flax(params))
    return jm, params, port, b


@pytest.mark.parametrize("da_gated", [False, True])
def test_rrtmil_matches_jax(da_gated):
    """Eval outputs, bags of 48, 29, 5 and 0 tokens on a 8 × 8 grid of four
    regions, one R-MSA and one CR-MSA layer (8 heads of 4)."""
    jm, params, port, b = _rrt_pair(12, da_gated=da_gated)
    want = jm.apply({"params": params}, jnp.asarray(b["feats"]), jnp.asarray(b["mask"]), return_attn=True)
    with torch.no_grad():
        got = port(_t(b["feats"]), _t(b["mask"]), return_attn=True)
    for key in ("logits", "bag_feat", "attn"):
        _close(got[key], want[key], msg=key)
    assert torch.all(got["attn"][3] == 0)


def test_rrtmil_train_step_matches_jax(no_dropout):
    two_sgd_steps_match_jax("rrtmil", _batch(13), **RRT)


def test_rrtmil_pool_runs_no_kernel(monkeypatch):
    """RRT's pool is built off its kernel path, as JAX's: the eval forward
    pools without calling K4's wrapper."""
    from mhim_mil_torch.ops import abmil_pool

    def refuse(*a, **k):
        raise AssertionError("K4 called")

    monkeypatch.setattr("mhim_mil_torch.models.layers.fused_abmil_pool", refuse)
    monkeypatch.setattr(abmil_pool, "fused_abmil_pool", refuse)
    _, _, port, b = _rrt_pair(14)
    assert port.pool_fn.attention.use_flash is False
    with torch.no_grad():
        assert torch.isfinite(port(_t(b["feats"]), _t(b["mask"]))["logits"]).all()


# ---- IBMIL -------------------------------------------------------------------------------


def _bank(seed, k=4):
    return np.random.default_rng(seed).normal(size=(k, DIM)).astype(np.float32)


@pytest.mark.parametrize("with_bank", [False, True])
def test_ibmil_matches_jax(with_bank):
    from mhim_mil_tpu.models.ibmil import IBMIL as JIBMIL

    bank = _bank(15) if with_bank else None
    b = _batch(16)
    x, mask = jnp.asarray(b["feats"]), jnp.asarray(b["mask"])
    jm = JIBMIL(input_dim=IN_DIM, inner_dim=DIM, confounders=bank)
    p = _np(jm.init(jax.random.PRNGKey(17), x, mask)["params"])
    port = IBMIL(input_dim=IN_DIM, inner_dim=DIM, confounders=bank).eval()
    port.load_state_dict(weights.ibmil_state_from_flax(p, bank))
    want = jm.apply({"params": p}, x, mask, return_attn=True)
    with torch.no_grad():
        got = port(_t(b["feats"]), _t(b["mask"]), return_attn=True)
    for key in ("logits", "bag_feat", "attn"):
        _close(got[key], want[key], msg=key)
    assert got["bag_feat"].shape == (len(b["mask"]), 2 * DIM if with_bank else DIM)


def _confounder_layouts(tmp_path):
    """``--confounder_path`` values and the bank each resolves to: a file, a
    directory holding the k-file, a directory whose ``0/`` holds it, and a
    list of a file and a directory (concatenated). One file holds its bank
    as ``[1, K, D]``, which the loader reshapes to rows of ``inner_dim``."""
    banks = [_bank(20 + i) for i in range(3)]
    f = tmp_path / "bank.npy"
    np.save(f, banks[0][None])
    d1 = tmp_path / "d1"
    d1.mkdir()
    np.save(d1 / "train_bag_cls_agnostic_feats_proto_4.npy", banks[1])
    d2 = tmp_path / "d2" / "0"
    d2.mkdir(parents=True)
    np.save(d2 / "train_bag_cls_agnostic_feats_proto_4.npy", banks[2])
    return [(str(f), banks[0]), (str(d1), banks[1]), (str(tmp_path / "d2"), banks[2]),
            ([str(f), str(d1)], np.concatenate(banks[:2]))]


def test_ibmil_confounder_path_resolution_matches_jax(tmp_path):
    for path, bank in _confounder_layouts(tmp_path):
        kw = dict(CFG, model="ibmil", confounder_path=path, confounder_k=4)
        jm, jfam = j_build_model(j_load_config([], **kw))
        port, fam = build_model(load_config([], **kw), device="cpu")
        assert fam == jfam == "default"
        np.testing.assert_array_equal(np.asarray(jm.confounders), bank)
        np.testing.assert_array_equal(port.confounder_feat.numpy(), bank)
    port, _ = build_model(load_config([], model="ibmil", **CFG), device="cpu")
    assert not hasattr(port, "confounder_feat") and not hasattr(port, "W_q")


# ---- the weight maps and the scorer ---------------------------------------------------------


def _params(model, bank=None, **kw):
    extra = {}
    if bank is not None:
        extra = dict(confounder_path=bank)
    jm, _ = j_build_model(j_load_config([], model=model, **CFG, **extra, **kw))
    b = _batch(18)
    return jm, _np(jm.init(jax.random.PRNGKey(19), jnp.asarray(b["feats"]), jnp.asarray(b["mask"]))["params"])


@pytest.mark.parametrize("case", ["rrtmil", "ibmil", "ibmil-bank"])
def test_weights_map_both_ways(tmp_path, case):
    """flax → port by the port's function: exactly the port's tensors, shapes
    equal; port → flax by the JAX package's importer, back onto the same
    tree bit for bit; IBMIL's bank as the ``confounder_feat`` buffer."""
    model = case.split("-")[0]
    bank_path = None
    if case.endswith("bank"):
        bank_path = str(tmp_path / "bank.npy")
        np.save(bank_path, _bank(21))
    kw = RRT if model == "rrtmil" else {}
    jm, params = _params(model, bank_path, **kw)
    port, _ = build_model(load_config([], model=model, **CFG, **kw,
                                      **({"confounder_path": bank_path} if bank_path else {})), device="cpu")
    if model == "rrtmil":
        sd = weights.rrtmil_state_from_flax(params)
    else:
        sd = weights.ibmil_state_from_flax(params, None if bank_path is None else np.load(bank_path))
    assert set(sd) == set(port.state_dict())
    for k, t in port.state_dict().items():
        assert tuple(t.shape) == tuple(sd[k].shape), k
    port.load_state_dict(sd)
    psd = {k: v.numpy() for k, v in port.state_dict().items()}
    _assert_trees_equal(IMPORTERS[model](psd), params)
    if bank_path:
        np.testing.assert_array_equal(psd["confounder_feat"], np.asarray(jm.confounders))


def test_rrtmil_gated_pool_weights_beyond_the_importer():
    """``da_gated``: ``import_rrtmil`` reads only the tanh pool; the port's
    map gives the gated pool as ``pool_fn.attention.attention_a.0``,
    ``attention_b.0`` and ``attention_c``, and the importer (on the tanh
    pool's names) plus ``attn_b`` by hand maps everything back bit for bit."""
    _, params = _params("rrtmil", **RRT, da_gated=True)
    port, _ = build_model(load_config([], model="rrtmil", **CFG, **RRT, da_gated=True), device="cpu")
    sd = weights.rrtmil_state_from_flax(params)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    psd = {k: v.numpy() for k, v in port.state_dict().items()}
    pre = "pool_fn.attention."
    renamed = {k: v for k, v in psd.items() if not k.startswith(pre)}
    renamed[pre + "attention.0.weight"] = psd[pre + "attention_a.0.weight"]
    renamed[pre + "attention.2.weight"] = psd[pre + "attention_c.weight"]
    back = IMPORTERS["rrtmil"](renamed)
    back["pool_fn"]["attn_b"] = {"kernel": psd[pre + "attention_b.0.weight"].T}
    _assert_trees_equal(back, params)


def test_ibmil_scorer_matches_jax_infer_fn(tmp_path):
    """The ``Scorer`` of IBMIL with a bank against JAX's serving closure on
    the same bucket-padded request."""
    from mhim_mil_tpu.utils.serving import _infer_fn
    from mhim_mil_torch.utils.serving import Scorer

    bank_path = str(tmp_path / "bank.npy")
    np.save(bank_path, _bank(22))
    jcfg = j_load_config([], model="ibmil", confounder_path=bank_path, **CFG)
    jm, family = j_build_model(jcfg)
    b = _batch(23)
    params = _np(jm.init(jax.random.PRNGKey(24), jnp.asarray(b["feats"]), jnp.asarray(b["mask"]))["params"])
    cfg = load_config([], model="ibmil", confounder_path=bank_path, **CFG)
    port, fam = build_model(cfg, device="cpu")
    port.load_state_dict(weights.ibmil_state_from_flax(params, np.load(bank_path)))
    feats, mask = b["feats"][:, :40], b["mask"][:, :40]
    out = Scorer(cfg, port, buckets=(N,), device="cpu", family=fam).score(feats, mask)
    pad = ((0, 0), (0, N - 40))
    want = _infer_fn(jcfg, jm, family, {"params": params})(
        jnp.asarray(np.pad(feats, pad + ((0, 0),))), jnp.asarray(np.pad(mask, pad)))
    assert set(out) == set(want) == {"logits"}
    _close(out["logits"], want["logits"])
