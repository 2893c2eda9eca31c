"""The port's CLAM and DTFD against the JAX package's, fp32 on the CPU.

The JAX weights are initialised by flax and carried into the port by
``clam_state_from_flax`` / ``dtfd_state_from_flax``. Covered: the smooth
top-1 SVM; the top-k of the instance loss on planted ties and on a bag with
fewer valid instances than ``k_sample``, whose padding ties among itself
(the indices must be ``lax.top_k``'s); CLAM SB and MB, gated and not,
subtyping on and off, eval outputs and the training forward's instance
loss; DTFD's pseudo-bag ids against ``np.array_split`` at 0, 3, 7, 29 and
48 valid instances in 5 groups; DTFD in its three distillations, eval
outputs and the training forward's pseudo-bag predictions; two SGD steps of
the generic train step against JAX's (dropout patched to the identity on
both sides): loss, meters, first-step gradients and parameters; and the
weight maps both ways through the JAX package's ``IMPORTERS``. Small widths:
input_dim 16, inner_dim 32, bags of up to 48 instances with ragged and
empty bags. Tolerance rtol 1e-4, atol 1e-5.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.losses import build_criterion as j_build_criterion, cross_entropy as j_cross_entropy
from mhim_mil_tpu.engine.steps import make_train_step as j_make_train_step
from mhim_mil_tpu.engine.train_state import MILTrainState, make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.clam import CLAM as JCLAM, smooth_top1_svm as j_smooth_top1_svm
from mhim_mil_tpu.models.dtfd import DTFD as JDTFD
from mhim_mil_tpu.utils.schedules import make_lr_schedule as j_make_lr_schedule
from mhim_mil_tpu.utils.torch_import import IMPORTERS
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import make_train_step
from mhim_mil_torch.engine.train_state import create_train_state
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.models.clam import CLAM, smooth_top1_svm, top_k_indices
from mhim_mil_torch.models.dtfd import DTFD, pseudo_bag_ids
from mhim_mil_torch.utils import weights

RTOL, ATOL = 1e-4, 1e-5
IN_DIM, DIM = 16, 32
N, LENGTHS = 48, (48, 29, 5, 0)  # ragged, fewer than k_sample = 8, and empty
SPE = 2
CFG = dict(input_dim=IN_DIM, inner_dim=DIM, n_heads=2, compute_dtype="float32")
TRAIN_CFG = dict(CFG, opt="sgd", lr=0.1, lr_sche="const", weight_decay=0.0, batch_size=len(LENGTHS),
                 num_epoch=1, model_ema=True, model_ema_decay=0.9, aux_alpha=0.5)


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
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(seed, lengths=LENGTHS, n=N, n_classes=2):
    g = np.random.default_rng(seed)
    return {"feats": g.normal(size=(len(lengths), n, IN_DIM)).astype(np.float32),
            "mask": np.arange(n)[None] < np.array(lengths)[:, None],
            "target": (np.arange(len(lengths)) % n_classes).astype(np.int32)[::-1].copy(),
            "bag_valid": np.array(lengths) > 0}


# ---- CLAM -------------------------------------------------------------------------------


@pytest.mark.parametrize("c,tau", [(2, 1.0), (3, 0.5)])
def test_smooth_top1_svm_matches_jax(c, tau):
    g = np.random.default_rng(c)
    logits = (3 * g.normal(size=(7, 5, c))).astype(np.float32)
    labels = g.integers(0, c, size=(7, 5)).astype(np.int32)
    _close(smooth_top1_svm(_t(logits), _t(labels), tau), j_smooth_top1_svm(jnp.asarray(logits), jnp.asarray(labels), tau))


def _planted_scores():
    """Scores [B, C, N] with planted ties: equal top values at 3, 9 and 17
    and equal bottom values at 4 and 30 in bag 0; bag 1 with 5 valid
    instances, so its top-8 and bottom-8 reach into the NEG_INF padding."""
    g = np.random.default_rng(1)
    s = np.round(g.normal(size=(2, 3, N)), 1).astype(np.float32)  # rounding plants more ties
    s[0, :, [3, 9, 17]] = 4.0
    s[0, :, [4, 30]] = -4.0
    mask = np.arange(N)[None] < np.array([N, 5])[:, None]
    return np.where(mask[:, None], s, -1e30).astype(np.float32), mask


def test_top_k_indices_take_lax_top_k_order_on_ties():
    """The top-8 of the planted scores and of their negation, masked as the
    instance loss masks them: the indices equal ``lax.top_k``'s, ties in
    index order, the padding of the short bag taken from its lowest index."""
    s, mask = _planted_scores()
    neg = np.where(mask[:, None], -s, -1e30).astype(np.float32)
    for scores in (s, neg):
        want = np.asarray(jax.lax.top_k(jnp.asarray(scores), 8)[1])
        got = top_k_indices(_t(scores), 8).numpy()
        np.testing.assert_array_equal(got, want)
    assert list(top_k_indices(_t(s), 8)[0, 0, :3]) == [3, 9, 17]
    assert list(top_k_indices(_t(s), 8)[1, 0, 5:]) == [5, 6, 7]


@pytest.mark.parametrize("subtyping", [False, True])
def test_clam_instance_loss_on_planted_ties_matches_jax(subtyping):
    """``inst_loss`` on the planted attention logits against JAX's
    ``_inst_loss`` on the same instance classifiers: the tie order decides
    which instances' features are classified (``h`` is not masked, so the
    padding picked matters too), and reversing it moves the loss."""
    s, mask = _planted_scores()
    attn_logits = s.transpose(0, 2, 1)  # [B,N,C=3]
    h = np.random.default_rng(2).normal(size=(2, N, DIM)).astype(np.float32)
    label = np.array([2, 0], np.int32)
    jm = JCLAM(input_dim=IN_DIM, n_classes=3, inner_dim=DIM, multi_branch=True, subtyping=subtyping)
    p = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, N, IN_DIM)), jnp.asarray(mask))["params"])
    want = jm.apply({"params": p}, jnp.asarray(attn_logits), jnp.asarray(h), jnp.asarray(mask), jnp.asarray(label),
                    jnp.asarray(p["inst_classifiers_w"]), jnp.asarray(p["inst_classifiers_b"]), method=JCLAM._inst_loss)
    port = CLAM(input_dim=IN_DIM, n_classes=3, inner_dim=DIM, multi_branch=True, subtyping=subtyping)
    port.load_state_dict(weights.clam_state_from_flax(p))
    with torch.no_grad():
        got = port.inst_loss(_t(attn_logits), _t(h), _t(mask), _t(label))
        _close(got, want)
        flipped = port.inst_loss(_t(attn_logits[:, ::-1]), _t(h[:, ::-1]), _t(mask[:, ::-1]), _t(label))
    assert abs(float(flipped) - float(got)) > 1e-6


CLAM_CASES = [
    dict(multi_branch=False, gate=True),
    dict(multi_branch=True, gate=True),
    dict(multi_branch=False, gate=False, subtyping=True, n_classes=3),
    dict(multi_branch=True, gate=False, subtyping=True, n_classes=3),
    dict(multi_branch=False, gate=True, dropout=0.0, mil_norm="ln", mil_bias=False),
]


@pytest.mark.parametrize("kw", CLAM_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_clam_matches_jax(no_dropout, kw):
    """Eval outputs (``logits``, ``bag_feat``, ``attn``) and, in training
    with the label, ``aux_loss`` (dropout off on both sides)."""
    c = kw.get("n_classes", 2)
    b = _batch(3, n_classes=c)
    x, mask, label = jnp.asarray(b["feats"]), jnp.asarray(b["mask"]), jnp.asarray(b["target"])
    jm = JCLAM(input_dim=IN_DIM, inner_dim=DIM, **kw)
    p = _np(jm.init(jax.random.PRNGKey(4), x, mask)["params"])
    port = CLAM(input_dim=IN_DIM, inner_dim=DIM, **kw).eval()
    port.load_state_dict(weights.clam_state_from_flax(p, dropout=kw.get("dropout", 0.25) > 0))
    want = jm.apply({"params": p}, x, mask, return_attn=True)
    want_train = jm.apply({"params": p}, x, mask, label, training=True, rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = port(_t(b["feats"]), _t(b["mask"]), return_attn=True)
        got_train = port(_t(b["feats"]), _t(b["mask"]), _t(b["target"]), training=True)
        assert "aux_loss" not in port(_t(b["feats"]), _t(b["mask"]), _t(b["target"]))
    for key in ("logits", "bag_feat", "attn"):
        _close(got[key], want[key], msg=key)
    _close(got_train["aux_loss"], want_train["aux_loss"], msg="aux_loss")
    assert float(got_train["aux_loss"]) > 0 and torch.all(got["attn"][3] == 0)


# ---- DTFD -------------------------------------------------------------------------------


@pytest.mark.parametrize("n_valid", [0, 3, 7, 29, 48])
def test_dtfd_pseudo_bag_ids_follow_array_split(n_valid):
    """The ids of the valid positions are ``np.array_split`` of their ranks
    into 5 chunks (the valid instances scattered among masked ones)."""
    g = np.random.default_rng(n_valid)
    mask = np.zeros(N, bool)
    mask[np.sort(g.choice(N, n_valid, replace=False))] = True
    ids = pseudo_bag_ids(_t(mask)[None], 5)[0].numpy()
    assert ids.dtype == np.int64 and ids.min() >= 0 and ids.max() <= 4
    want = np.empty(n_valid, np.int64)
    for gid, chunk in enumerate(np.array_split(np.arange(n_valid), 5)):
        want[chunk] = gid
    np.testing.assert_array_equal(ids[mask], want)


DTFD_LENGTHS = (48, 29, 7, 3, 0)


@pytest.mark.parametrize("distill", ["AFS", "MaxS", "MaxMinS"])
def test_dtfd_matches_jax(no_dropout, distill):
    """Eval outputs and, in training, ``sub_preds`` and ``sub_preds_mask``,
    on bags of 48, 29, 7, 3 and 0 valid instances (the last two fill fewer
    than the 5 pseudo-bags)."""
    b = _batch(5, DTFD_LENGTHS)
    x, mask = jnp.asarray(b["feats"]), jnp.asarray(b["mask"])
    jm = JDTFD(input_dim=IN_DIM, inner_dim=DIM, distill=distill)
    p = _np(jm.init(jax.random.PRNGKey(6), x, mask)["params"])
    port = DTFD(input_dim=IN_DIM, inner_dim=DIM, distill=distill).eval()
    port.load_state_dict(weights.dtfd_state_from_flax(p))
    want = jm.apply({"params": p}, x, mask, return_attn=True)
    want_train = jm.apply({"params": p}, x, mask, training=True, rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = port(_t(b["feats"]), _t(b["mask"]), return_attn=True)
        got_train = port(_t(b["feats"]), _t(b["mask"]), training=True)
    for key in ("logits", "bag_feat", "attn"):
        _close(got[key], want[key], msg=key)
    _close(got_train["sub_preds"], want_train["sub_preds"], msg="sub_preds")
    np.testing.assert_array_equal(got_train["sub_preds_mask"].numpy(), np.asarray(want_train["sub_preds_mask"]))
    assert got_train["sub_preds_mask"].sum(-1).tolist() == [5, 5, 5, 3, 0]


def test_dtfd_rejects_an_unknown_distillation():
    with pytest.raises(ValueError):
        DTFD(input_dim=IN_DIM, inner_dim=DIM, distill="MinS")


# ---- the generic train step ---------------------------------------------------------------


TO_PORT = {"clam_sb": weights.clam_state_from_flax, "clam_mb": weights.clam_state_from_flax,
           "dtfd": weights.dtfd_state_from_flax, "rrtmil": weights.rrtmil_state_from_flax}


def _jax_grads(jcfg, jm, family, params, jbatch):
    """The gradient of JAX's train-step loss (``steps.py:55-101``): the label
    into CLAM's forward, DTFD's pseudo-bag cross-entropy in aux."""
    criterion = j_build_criterion(jcfg)
    args = (jbatch["feats"], jbatch["mask"]) + ((jbatch["target"],) if family == "clam" else ())

    def loss(p):
        out = jm.apply({"params": p}, *args, training=True, rngs={"dropout": jax.random.PRNGKey(0)})
        aux = out.get("aux_loss", 0.0)
        if "sub_preds" in out:
            sp = out["sub_preds"]
            tgt = jnp.broadcast_to(jbatch["target"][:, None], sp.shape[:2])
            w = out["sub_preds_mask"] & jbatch["bag_valid"][:, None]
            aux = aux + j_cross_entropy(sp.reshape(-1, sp.shape[-1]), tgt.reshape(-1), w.reshape(-1))
        return jcfg.main_alpha * criterion(out["logits"], jbatch) + jcfg.aux_alpha * aux

    return jax.grad(loss)(params)


def two_sgd_steps_match_jax(model, batch, seed=0, **kw):
    """Two SGD steps of the port's generic train step against JAX's
    ``make_train_step`` from flax's initial weights (dropout patched off by
    the caller), under ``model_ema``: the metrics of each step, the first
    step's gradients and the student's and the EMA teacher's parameters
    after each. Returns the port's metrics of the two steps."""
    jcfg = j_load_config([], model=model, **TRAIN_CFG, **kw)
    jm, family = j_build_model(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = jm.init(jax.random.PRNGKey(seed), jbatch["feats"], jbatch["mask"])["params"]
    cfg = load_config([], model=model, **TRAIN_CFG, **kw)
    port, fam = build_model(cfg, device="cpu")
    assert fam == family
    to_port = TO_PORT[model]
    port.load_state_dict(to_port(_np(params)))
    jgrads = _jax_grads(jcfg, jm, family, params, jbatch)
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, SPE))
    jstate = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state={},
                           teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(3), tx=tx, apply_fn=jm.apply)
    jstep = j_make_train_step(jcfg, jm, family, SPE)
    state = create_train_state(cfg, port, SPE, device="cpu")
    step = make_train_step(cfg, family, SPE, "cpu")
    seen = []
    for i in range(2):
        jstate, jmetrics = jstep(jstate, jbatch)
        metrics = step(state, tbatch)
        seen.append(metrics)
        assert set(jmetrics) <= set(metrics)
        for k, v in jmetrics.items():
            _close(metrics[k], v, msg=k)
        if i == 0:
            want = to_port(_np(jgrads))
            for name, p in port.named_parameters():
                _close(p.grad, want[name], msg=f"grad {name}")
        for module, p in ((state.model, jstate.params), (state.teacher, jstate.teacher_params)):
            want = to_port(_np(p))
            for k, t in module.state_dict().items():
                _close(t, want[k], msg=k)
    return seen


@pytest.mark.parametrize("model", ["clam_sb", "dtfd"])
def test_generic_train_step_matches_jax(no_dropout, model):
    """clam_sb pays its instance loss (the label into the forward), dtfd its
    tier-1 pseudo-bag loss; both in ``aux_loss``, nonzero."""
    seen = two_sgd_steps_match_jax(model, _batch(7))
    assert all(float(m["aux_loss"]) > 0 for m in seen)


# ---- the weight maps ----------------------------------------------------------------------


def _jax_params(model, **kw):
    jm, _ = j_build_model(j_load_config([], model=model, **CFG, **kw))
    b = _batch(8)
    return _np(jm.init(jax.random.PRNGKey(9), jnp.asarray(b["feats"]), jnp.asarray(b["mask"]))["params"])


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("model,to_port", [
    ("clam_sb", weights.clam_state_from_flax),
    ("clam_mb", weights.clam_state_from_flax),
    ("dtfd", weights.dtfd_state_from_flax),
])
def test_weights_map_both_ways(model, to_port):
    """flax → port by the port's function: every tensor of the port's
    ``state_dict`` and nothing else, shapes equal; port → flax by the JAX
    package's importer, back onto the same tree bit for bit."""
    params = _jax_params(model)
    port, _ = build_model(load_config([], model=model, **CFG), device="cpu")
    sd = to_port(params)
    assert set(sd) == set(port.state_dict())
    for k, t in port.state_dict().items():
        assert tuple(t.shape) == tuple(sd[k].shape), k
    port.load_state_dict(sd)
    _assert_trees_equal(IMPORTERS[model]({k: v.numpy() for k, v in port.state_dict().items()}), params)


@pytest.mark.parametrize("kw", [dict(gate=False, dropout=0.0), dict(gate=False), dict(mil_norm="ln")],
                         ids=["ungated-nodrop", "ungated", "ln"])
def test_clam_weights_beyond_the_importer(kw):
    """The CLAMs ``import_clam`` reads only in part: ungated without dropout
    (the reference's layout, which it reads whole); ungated with dropout,
    whose last scorer layer the reference holds at ``module.3`` (the
    importer reads ``module.2``); ``mil_norm="ln"``, whose ``LayerNorm_0``
    the importer does not read (the port's ``in_norm``). The port's map
    gives exactly the port's tensors, and the importer plus those by hand
    map them back bit for bit."""
    jm = JCLAM(input_dim=IN_DIM, inner_dim=DIM, **kw)
    b = _batch(10)
    params = _np(jm.init(jax.random.PRNGKey(11), jnp.asarray(b["feats"]), jnp.asarray(b["mask"]))["params"])
    dropout = kw.get("dropout", 0.25) > 0
    port = CLAM(input_dim=IN_DIM, inner_dim=DIM, **kw)
    sd = weights.clam_state_from_flax(params, dropout=dropout)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    psd = {k: v.numpy() for k, v in port.state_dict().items()}
    if not kw.get("gate", True) and dropout:
        assert "attention_net.3.module.3.weight" in psd
        psd["attention_net.3.module.2.weight"] = psd.pop("attention_net.3.module.3.weight")
        psd["attention_net.3.module.2.bias"] = psd.pop("attention_net.3.module.3.bias")
    back = IMPORTERS["clam_sb"](psd)
    if "in_norm.weight" in psd:
        back["LayerNorm_0"] = {"scale": psd["in_norm.weight"], "bias": psd["in_norm.bias"]}
    _assert_trees_equal(back, params)
