"""The port's data parallelism over bags for the rest of the zoo against the
JAX package's mesh, on the CPU: CLAM SB and MB, DSMIL, DTFD, IBMIL,
RRT-MIL, mambamil (simple, srmamba, bimamba), 2dmamba and MHIM (and the
teacher stage ``mhim_pure``) with the ``dsmil`` baseline.

As ``tests/test_torch_parallel.py``: one ``torch.distributed.run`` gloo
world of 4 ranks (``tests/torch_dp_worker.py``) runs every step, eval and
control case in one launch; JAX's side runs in this process on the virtual
CPU mesh of ``tests/conftest.py``, ``make_mesh(dp=4, sp=1)`` with
``shard_batch(..., shard_instances=False)``. Both sides start from flax's
initial weights (carried into the port by ``utils/weights.py``) and take
the same uniform draws; dropout is the identity on both sides, except in
the case that holds the port's dropout draws against its own one-process
step. Small widths: input and inner dim 32, bags of 64 instances with a
padding bag last; 2dmamba on an 8 × 8 grid with ``pos``, ``nll_surv`` over
4 bins.

MHIM-dsmil's consistency loss weighs its ``[B, C]`` per-class losses by a
bag weight: the port's ``[B, 1]`` counts each bag once, JAX's ``[B]``
broadcasts against the class axis (ROADMAP's kept behaviours), so the two
agree where B = C and every bag is valid. That case is held against JAX's
mesh step; a batch with a padding bag is held against the port's own
one-process step.

Tolerances: loss rtol 1e-5; Adam's first moments (the gradients) within
1e-5 of max|g| (of the tensor, or of the model where the tensor's whole
gradient lies within that of zero); parameters by ``_check_params`` (rtol
1e-4 / atol 1e-6, 2·lr where a gradient lies within tolerance of zero);
the evaluation's AUC, accuracy, c-index and DSMIL's fused logits atol 1e-6;
the port's dp step against its one-process step atol 2e-6.
"""

import json
import os
import re
from functools import partial

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.models.merge as jmerge_mod
import mhim_mil_tpu.ops.masking as jmasking_mod
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.steps import make_eval_step as j_make_eval_step, make_train_step as j_make_train_step
from mhim_mil_tpu.engine.train_state import MILTrainState, make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.mhim import make_mhim_train_step as j_make_mhim_step
from mhim_mil_tpu.ops import masked as jmasked
from mhim_mil_tpu.parallel import make_mesh as j_make_mesh
from mhim_mil_tpu.parallel import replicate_tree as j_replicate_tree, shard_batch as j_shard_batch
from mhim_mil_tpu.utils import schedules as jsched
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import make_train_step
from mhim_mil_torch.engine.train_state import create_train_state
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.utils import weights
from mhim_mil_torch.utils.weights import state_dict_from_flax
from test_torch_parallel import (GRAD_TOL, MHIM_CFG, SPE, WORKER, WORLD, _check_against_jax,
                                 _check_against_one_process, _check_params, _close, _group, _jax_mu, _mhim_batch,
                                 _mhim_draws, _np_params, _port_one_process, _torchrun)

ZOO_CFG = dict(input_dim=32, inner_dim=32, n_classes=2, batch_size=8, dropout=0.0, lr=1e-3, lr_sche="const",
               num_epoch=1, aux_alpha=0.5, compute_dtype="float32")
MAMBAMIL = dict(model="mambamil", mambamil_dim=32, mambamil_state_dim=8, mambamil_rate=4)
GRID = 8  # 2dmamba's grid side
SURV = dict(loss="nll_surv", n_classes=4, mamba_2d_max_h=GRID, mamba_2d_max_w=GRID, mambamil_dim=32)
# name: (config overrides, the weight map, attributes set on both models after they are built)
ZOO = {
    "clam_sb": (dict(model="clam_sb"), partial(weights.clam_state_from_flax, dropout=False), {}),
    "clam_mb": (dict(model="clam_mb", n_classes=3), partial(weights.clam_state_from_flax, dropout=False),
                {"subtyping": True}),
    "dsmil": (dict(model="dsmil"), weights.dsmil_state_from_flax, {}),
    "dtfd": (dict(model="dtfd"), weights.dtfd_state_from_flax, {}),
    "ibmil": (dict(model="ibmil"), None, {}),  # the map takes the bank: _to_port
    "rrtmil": (dict(model="rrtmil", region_num=2, rrt_n_heads=2), weights.rrtmil_state_from_flax, {}),
    "mambamil_simple": (dict(MAMBAMIL, mambamil_type="SimpleMamba"), weights.mambamil_state_from_flax, {}),
    "mambamil_srmamba": (dict(MAMBAMIL, mambamil_type="SRMamba"), weights.mambamil_state_from_flax, {}),
    "mambamil_bimamba": (dict(MAMBAMIL, mambamil_type="BiMamba"), weights.mambamil_state_from_flax, {}),
    "2dmamba": (dict(model="2dmamba", **SURV), weights.mamba2d_state_from_flax, {}),
}
# the evaluation over make_synthetic_dataset's (survival: make_synthetic_survival_dataset's) slides: the
# metrics held against JAX's
EVAL_CASES = {"clam_sb": ("auc", "acc"), "dtfd": ("auc", "acc"), "dsmil": ("auc", "acc"), "2dmamba": ("cindex",)}
EVAL_CFG = dict(batch_size=4, bucket_sizes=[64], num_bootstrap=5)
EVAL_SLIDES = dict(n_slides=12, bag_size=64, feat_dim=32, seed=3)
MHIM_DSMIL = dict(MHIM_CFG, baseline="dsmil", n_classes=WORLD, batch_size=WORLD)  # B = C, every bag valid


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout_in_jax(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)


# ---- inputs ---------------------------------------------------------------------------------


def _zoo_batch(n_classes: int, survival: bool = False):
    """8 ragged bags of up to 64 instances, the last a padding bag; for
    survival the bin, censorship and event of each bag and each bag's
    instances at distinct cells of the 8 × 8 grid (``pos``: column, row)."""
    rng = np.random.default_rng(4)
    b, n = 8, 64
    lengths = rng.integers(40, n + 1, (b,))
    lengths[-1] = 0
    mask = np.arange(n)[None] < lengths[:, None]
    out = {"feats": np.where(mask[..., None], rng.normal(size=(b, n, 32)), 0.0).astype(np.float32), "mask": mask,
           "bag_valid": lengths > 0, "target": (np.arange(b) % n_classes).astype(np.int32)[::-1].copy()}
    if survival:
        cells = np.stack([rng.permutation(GRID * GRID)[:n] for _ in range(b)])
        out["pos"] = np.stack([cells % GRID, cells // GRID], -1).astype(np.int32)
        out["censorship"] = (np.arange(b) % 3 == 0).astype(np.int32)
        out["event"] = rng.uniform(0.5, 3.0, b).astype(np.float32)
    return out


def _bank_path(tmp) -> str:
    path = os.path.join(str(tmp), "bank.npy")
    if not os.path.exists(path):
        np.save(path, np.random.default_rng(5).normal(size=(4, 32)).astype(np.float32))
    return path


def _cfg(name: str, tmp) -> dict:
    """The case's config, the same dict for JAX's and the port's loader."""
    cfg = {**ZOO_CFG, **ZOO[name][0]}
    if cfg["model"] == "ibmil":
        cfg["confounder_path"] = _bank_path(tmp)
    return cfg


def _jax_model(name: str, cfg: dict):
    jcfg = j_load_config([], **cfg)
    jm, family = j_build_model(jcfg)
    attrs = ZOO[name][2]
    return jcfg, (jm.clone(**attrs) if attrs else jm), family


def _jax_state(jcfg, jm, batch):
    """JAX's initial train state, flax's init on the batch's first 8 slots
    of its first bag (the params do not depend on the sample's shape; a
    small one compiles faster)."""
    from mhim_mil_tpu.engine.train_state import create_train_state as j_create_train_state

    sample = {k: jnp.asarray(v[:1, :8] if v.ndim > 1 else v[:1]) for k, v in batch.items()}
    return j_create_train_state(jcfg, jm, jax.random.PRNGKey(0), sample, jsched.make_lr_schedule(jcfg, SPE))


def _to_port(name: str, cfg: dict, params) -> dict:
    """The port's state_dict of JAX's ``params``, by the case's weight map."""
    if name == "ibmil":
        return weights.ibmil_state_from_flax(params, np.load(cfg["confounder_path"]))
    return ZOO[name][1](params)


def _weights(sd) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def _mhim_dsmil_params(kind: str, n_classes: int, seed: int = 0):
    """Flax's initial params and the Merge's buffers of MHIM-dsmil (``kind``
    mhim or mhim_pure), and the port's model and config on them."""
    cfg = dict(MHIM_DSMIL, model=kind, n_classes=n_classes)
    jm, _ = j_build_model(j_load_config([], **cfg))
    b = _mhim_batch()
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    v = jax.jit(partial(jm.init, training=True))(rngs, jnp.asarray(b["feats"]), jnp.asarray(b["mask"]),
                                                 jnp.zeros(b["mask"].shape, jnp.float32))
    v = jax.tree.map(np.asarray, v)
    port_cfg = load_config([], **cfg)
    port, _ = build_model(port_cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(v["params"], v.get("buffers")))
    return cfg, v, port


@pytest.fixture(scope="module")
def zoo_tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("dp_zoo")


@pytest.fixture(scope="module")
def inits(zoo_tmp):
    """JAX's initial state of each case (``(cfg, jcfg, jm, family, state)``)
    and MHIM-dsmil's params (``("mhim_dsmil", kind, n_classes)``), each made
    once: the world, the steps and the evaluations share them."""
    cache = {}

    def get(key):
        if key not in cache:
            if isinstance(key, tuple):
                cache[key] = _mhim_dsmil_params(*key[1:])
            else:
                cfg = _cfg(key, zoo_tmp)
                jcfg, jm, family = _jax_model(key, cfg)
                state = _jax_state(jcfg, jm, _zoo_batch(cfg["n_classes"], survival=key == "2dmamba"))
                cache[key] = (cfg, jcfg, jm, family, state)
        return cache[key]

    return get


def _all_valid_batch(b: int):
    """``b`` full bags of 64 instances, each of its own class (B = C)."""
    rng = np.random.default_rng(6)
    return {"feats": rng.normal(size=(b, 64, 32)).astype(np.float32), "mask": np.ones((b, 64), bool),
            "bag_valid": np.ones(b, bool), "target": np.arange(b, dtype=np.int32)[::-1].copy()}


@pytest.fixture(scope="module")
def world(zoo_tmp, inits):
    """One gloo world of WORLD ranks running every case; returns the cases'
    inputs and rank 0's results, by case."""
    specs, arrays, inputs = [], {}, {}

    def add(spec, **groups):
        specs.append(spec)
        inputs[spec["name"]] = groups
        for g, d in groups.items():
            for k, v in d.items():
                arrays[f"{spec['name']}/{g}/{k}"] = np.asarray(v)

    for name in ZOO:
        cfg, _, _, _, jstate = inits(name)
        batch = _zoo_batch(cfg["n_classes"], survival=name == "2dmamba")
        w = _weights(_to_port(name, cfg, _np_params(jstate.params)))
        spec = {"name": name, "kind": "generic_step", "cfg": cfg, "dp": WORLD, "spe": SPE, "dropout": False,
                "attrs": ZOO[name][2], "scramble": ["confounder_feat"] if name == "ibmil" else []}
        add(spec, w=w, batch=batch)
        if name == "clam_sb":
            add({**spec, "name": "control_clam_count", "control": "clam_count"}, w=w, batch=batch)
        if name == "dtfd":  # DTFD's dropout is 0.25 at its three places, whatever the config says
            add({**spec, "name": "dropout", "dp": 2, "dropout": True}, w=w, batch=batch)
        if name in EVAL_CASES:
            ecfg = {**cfg, **EVAL_CFG}
            add({"name": f"eval_{name}", "kind": "eval", "cfg": ecfg, "dp": WORLD, "attrs": ZOO[name][2],
                 "survival": name == "2dmamba", "slides": _eval_slides(name)}, w=w)
    for kind in ("mhim", "mhim_pure"):
        cfg, _, port = inits(("mhim_dsmil", kind, WORLD))
        batch = _all_valid_batch(WORLD)
        add({"name": f"{kind}_dsmil", "kind": "mhim_step", "cfg": cfg, "dp": WORLD, "spe": SPE, "dropout": False},
            w=_weights(port.state_dict()), batch=batch,
            draw=_mhim_draws(port, batch) if kind == "mhim" else {})
    cfg, _, port = inits(("mhim_dsmil", "mhim", WORLD))  # the weights of the B = C case, on 8 bags
    batch = _mhim_batch()
    add({"name": "mhim_dsmil_padded", "kind": "mhim_step", "cfg": {**cfg, "batch_size": 8}, "dp": WORLD, "spe": SPE,
         "dropout": False}, w=_weights(port.state_dict()), batch=batch, draw=_mhim_draws(port, batch))
    arrays["spec"] = np.asarray(json.dumps(specs))
    np.savez(zoo_tmp / "in.npz", **arrays)
    _torchrun(WORLD, [WORKER, str(zoo_tmp / "in.npz"), str(zoo_tmp / "out.npz")])
    out = np.load(zoo_tmp / "out.npz")
    results = {}
    for k in out.files:
        case, rest = k.split("/", 1)
        results.setdefault(case, {})[rest] = out[k]
    return inputs, results


def _eval_slides(name: str) -> dict:
    return {**EVAL_SLIDES, "n_bins": 4} if name == "2dmamba" else {**EVAL_SLIDES, "n_classes": 2}


# ---- the generic steps against JAX's mesh step -----------------------------------------------


def _jax_mesh_step(monkeypatch, init, batch):
    """JAX's generic step of the case on ``make_mesh(dp=4, sp=1)`` from
    flax's initial weights (``init``, the case's entry of ``inits``),
    dropout off: its config, the state after it and its metrics."""
    _no_dropout_in_jax(monkeypatch)
    _, jcfg, jm, family, state = init
    step = j_make_train_step(jcfg, jm, family, SPE, donate=False)
    mesh = j_make_mesh(dp=WORLD, sp=1)
    with mesh:
        s2, m = step(j_replicate_tree(mesh, state), j_shard_batch(mesh, batch, shard_instances=False))
        jax.block_until_ready(m)
    return jcfg, s2, {k: float(v) for k, v in m.items()}


def _check_generic_against_jax(name, cfg, res, s2, jmetrics, lr, to_port=None):
    """The dp (or sp) step's loss (rtol 1e-5), gradients (Adam's first
    moments, GRAD_TOL of the tensor's max|g|, or of the model's where the
    tensor's whole gradient is within that of zero) and parameters
    (``_check_params``) against JAX's step; ``to_port`` maps JAX's params
    to the port's names (this file's ``_to_port`` by default)."""
    to_port = to_port or _to_port
    _close(res["m/loss"], jmetrics["loss"], rtol=1e-5, atol=0, msg=f"{name} loss")
    _close(res["m/aux_loss"], jmetrics["aux_loss"], rtol=1e-5, atol=1e-7, msg=f"{name} aux_loss")
    moments = [x for x in jax.tree.leaves(s2.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu")]
    mu = {k: v.numpy() for k, v in to_port(name, cfg, _np_params(moments[0].mu)).items()}
    want = to_port(name, cfg, _np_params(s2.params))
    got_g = _group(res, "g")
    assert set(got_g) == {k for k in want if k != "confounder_feat"}, name
    top = max(np.abs(mu[k]).max() for k in got_g)
    for k, v in want.items():
        if k not in got_g:  # a buffer (IBMIL's bank)
            _close(res[f"s/{k}"], v, rtol=0, atol=0, msg=f"{name} {k}")
            continue
        scale = np.abs(mu[k]).max() if np.abs(mu[k]).max() > GRAD_TOL * top else top
        _close(got_g[k], mu[k], rtol=0, atol=GRAD_TOL * scale, msg=f"{name} gradient {k}")
        _check_params(f"{name} {k}", res[f"s/{k}"], v, mu[k], lr, rtol=1e-4, atol=1e-6, scale=scale)


@pytest.fixture(scope="module")
def jax_steps(world, inits):
    """JAX's mesh step of each case, made once (the control reads clam_sb's)."""
    inputs, _ = world
    cache = {}

    def get(name):
        if name not in cache:
            with pytest.MonkeyPatch.context() as mp:
                cache[name] = _jax_mesh_step(mp, inits(name), inputs[name]["batch"])
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_dp_step_matches_jax_mesh_step(world, jax_steps, inits, name):
    """Each family's generic step on 4 gloo ranks, 2 bags each (the last a
    padding bag), against JAX's on ``make_mesh(dp=4, sp=1)``: CLAM's
    instance loss (clam_mb with subtyping, 3 classes), DSMIL's instance
    loss, DTFD's pseudo-bag loss, IBMIL with its bank (scrambled on ranks
    1-3 before the state is broadcast from rank 0), RRT-MIL, mambamil's
    three variants, 2dmamba's survival loss over 4 bins with ``pos``."""
    _, results = world
    jcfg, s2, jmetrics = jax_steps(name)
    res = results[name]
    _check_generic_against_jax(name, inits(name)[0], res, s2, jmetrics, jcfg.lr)
    if name.startswith("clam") or name in ("dsmil", "dtfd"):
        assert float(res["m/aux_loss"]) > 0, name


def test_control_clam_count_per_rank_misses_jax(world, jax_steps, inits):
    """The test sees CLAM's coupling: the same dp step with the count of
    bags of its instance loss taken per rank misses JAX's tolerance."""
    _, results = world
    jcfg, s2, jmetrics = jax_steps("clam_sb")
    with pytest.raises(AssertionError):
        _check_generic_against_jax("clam_sb", inits("clam_sb")[0], results["control_clam_count"], s2, jmetrics,
                                   jcfg.lr)


def test_dtfd_dp_dropout_draws_equal_one_process(world, inits):
    """DTFD's three dropouts on (0.25): a dp world of 2, each rank drawing
    the global shape and keeping its rows, equals the port's one-process
    step within atol 2e-6: metrics, gradients and parameters (by
    ``_check_params``, at the model's gradient scale where a tensor's whole
    gradient is within GRAD_TOL of it of zero)."""
    inputs, results = world
    cfg = load_config([], **inits("dtfd")[0])
    w, batch = inputs["dropout"]["w"], inputs["dropout"]["batch"]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def one(dropout_on):
        model, family = build_model(cfg, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
        state = create_train_state(cfg, model, SPE, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            if not dropout_on:
                mp.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)
            metrics = make_train_step(cfg, family, SPE, device="cpu")(state, tb)
        return metrics, state

    metrics, state = one(True)
    off, _ = one(False)
    assert abs(float(metrics["loss"]) - float(off["loss"])) > 1e-4  # the dropout draws matter
    res = results["dropout"]
    for k, v in metrics.items():
        _close(res[f"m/{k}"], v, rtol=0, atol=2e-6, msg=k)
    grads = {k: state.optimizer.opt.state[p]["exp_avg"].numpy() for k, p in state.model.named_parameters()}
    top = max(np.abs(g).max() for g in grads.values())
    for k, p in state.model.named_parameters():
        g = grads[k]
        _close(res[f"g/{k}"], g, rtol=0, atol=2e-6, msg=f"gradient {k}")
        # the attention-logit biases: a softmax is blind to a shift, their gradient is 0 in exact arithmetic
        scale = np.abs(g).max() if np.abs(g).max() > GRAD_TOL * top else top
        _check_params(k, res[f"s/{k}"], p.detach().numpy(), g, cfg.lr, rtol=0, atol=2e-6, scale=scale)


# ---- MHIM with the dsmil baseline ----------------------------------------------------------


def _jax_mhim_dsmil_step(monkeypatch, kind, v, batch, draws):
    """JAX's MHIM-dsmil step (``kind`` mhim or mhim_pure) on ``make_mesh(dp=4,
    sp=1)`` from flax's params ``v``, fed ``draws``, dropout off."""
    params = jax.tree.map(jnp.asarray, v["params"])
    model_state = {"buffers": v["buffers"]} if "buffers" in v else {}
    jcfg = j_load_config([], **dict(MHIM_DSMIL, model=kind))
    jmodel, _ = j_build_model(jcfg)
    tx = j_make_optimizer(jcfg, jsched.make_lr_schedule(jcfg, SPE))
    state = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=model_state,
                          teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                          rng=jax.random.PRNGKey(0), tx=tx, apply_fn=jmodel.apply)
    order = iter([draws[k] for k in sorted(draws) if k.startswith("mask")] + [draws["merge"]] if draws else [])

    def fed(rng, pool, k):
        u = next(order)
        assert u.shape == pool.shape
        return jmasked.topk_mask(jnp.asarray(u), pool, k, largest=True)

    monkeypatch.setattr(jmasking_mod, "random_subset_mask", fed)
    monkeypatch.setattr(jmerge_mod, "random_subset_mask", fed)
    _no_dropout_in_jax(monkeypatch)
    step = j_make_mhim_step(jcfg, jmodel, SPE)
    mesh = j_make_mesh(dp=WORLD, sp=1)
    with mesh:
        s2, m = step(j_replicate_tree(mesh, state), j_shard_batch(mesh, batch, shard_instances=False))
        jax.block_until_ready(m)
    assert next(order, None) is None  # every draw was taken
    return jax.tree.map(np.asarray, s2), {k: float(m[k]) for k in m}


@pytest.mark.parametrize("kind", ["mhim", "mhim_pure"])
def test_mhim_dsmil_dp_step_matches_jax_mesh_step(world, inits, monkeypatch, kind):
    """MHIM-dsmil (teacher, mining, student, consistency loss on the
    ``[B, C, D]`` bag feature, Adam, EMA) and its teacher stage on 4 ranks,
    one bag each, B = C = 4, every bag valid, against JAX's mesh step:
    loss rtol 1e-5, keep_num and patch_num, gradients, student, Merge's
    ``global_q_mm`` and teacher (``_check_against_jax``)."""
    inputs, results = world
    name = f"{kind}_dsmil"
    _, v, _ = inits(("mhim_dsmil", kind, WORLD))
    jstate, jmetrics = _jax_mhim_dsmil_step(monkeypatch, kind, v, inputs[name]["batch"], inputs[name].get("draw"))
    ref = {"name": name, "jstate": jstate, "jmetrics": jmetrics, "jmu": _jax_mu(jstate)}
    _check_against_jax(results[name], ref, loss_rtol=1e-5)
    if kind == "mhim":
        assert float(results[name]["m/aux_loss"]) > 0


def test_mhim_dsmil_dp_step_with_a_padding_bag_equals_one_process(world):
    """MHIM-dsmil on 8 bags, the last a padding bag, 4 classes: the dp step
    on 4 ranks equals the port's one-process step within atol 2e-6 (the
    consistency loss's weight sum counts every rank's valid bags once)."""
    inputs, results = world
    i = inputs["mhim_dsmil_padded"]
    metrics, state = _port_one_process("dsmil", i["w"], i["batch"], i["draw"], n_classes=WORLD, batch_size=8)
    assert float(metrics["aux_loss"]) > 0
    _check_against_one_process(results["mhim_dsmil_padded"], metrics, state)


# ---- the evaluation against JAX's mesh evaluation ----------------------------------------------


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_zoo_dp_eval_matches_jax_mesh_eval(world, inits, name):
    """``evaluate`` over the staged rows of 4 ranks, the logits gathered,
    against JAX's mesh evaluation of the same weights: CLAM's and DTFD's
    AUC and accuracy, DSMIL's with its fused logits, 2dmamba's c-index on
    survival slides (its raster grid), all within 1e-6."""
    from mhim_mil_tpu.data import make_synthetic_dataset, make_synthetic_survival_dataset
    from mhim_mil_tpu.engine.driver import device_eval_batches as j_device_eval_batches
    from mhim_mil_tpu.engine.driver import evaluate as j_evaluate

    _, results = world
    cfg, _, jm, family, state = inits(name)
    jcfg = j_load_config([], **{**cfg, **EVAL_CFG, "bucket_sizes": tuple(EVAL_CFG["bucket_sizes"])})
    slides = (make_synthetic_survival_dataset if name == "2dmamba" else make_synthetic_dataset)(**_eval_slides(name))
    mesh = j_make_mesh(dp=WORLD, sp=1)
    with mesh:
        staged = j_device_eval_batches(jcfg, slides, mesh, shard_instances=False)
        row = j_evaluate(jcfg, j_make_eval_step(jcfg, jm, family), j_replicate_tree(mesh, state), staged, 0, False)
    res = results[f"eval_{name}"]
    for k in EVAL_CASES[name]:
        np.testing.assert_allclose(res[k], row[k], atol=1e-6, err_msg=f"{name} {k}")
    if name == "dsmil":
        np.testing.assert_allclose(res["logits"], row["_logits"], rtol=0, atol=1e-6, err_msg="dsmil fused logits")
    assert res["logits"].shape == row["_logits"].shape


# ---- the driver through its command line ----------------------------------------------


DRIVER_BASE = ["--input_dim", "32", "--inner_dim", "32", "--synth_n_slides", "16", "--synth_bag_size", "64",
               "--bucket_sizes", "64", "--batch_size", "4", "--cv_fold", "2", "--num_epoch", "2", "--max_epoch", "2",
               "--lr", "1e-3", "--lr_sche", "const", "--num_bootstrap", "5", "--compute_dtype", "float32"]
DRIVER_CASES = {
    "clam_sb": (["--datasets", "synth", "--model", "clam_sb", "--aux_alpha", "0.5"], ("auc", "acc")),
    "2dmamba": (["-c", "config/feat_surv.yaml", "--datasets", "surv_synth", "--model", "2dmamba", "--mambamil_dim",
                 "32"], ("cindex",)),
}


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_zoo_driver_dp_with_an_idle_rank_matches_one_process(tmp_path, case):
    """``torch.distributed.run --nproc_per_node 3`` with ``--mesh_dp 2``
    (rank 2 idles), 2 folds × 2 epochs of clam_sb, and of 2dmamba on a
    synthetic survival set: the test rows' AUC and accuracy, or c-index,
    within 1e-6 of the one-process run; the same files; rank 0 alone
    printed and wrote."""
    from mhim_mil_torch.main import main

    extra, keys = DRIVER_CASES[case]
    argv = [*extra, *DRIVER_BASE, "--title", "dp"]
    out_dp, out_one = tmp_path / "dp", tmp_path / "one"
    res = _torchrun(3, ["-m", "mhim_mil_torch.main", "--device", "cpu", *argv, "--mesh_dp", "2",
                        "--output_path", str(out_dp)])
    one = main(["--device", "cpu", *argv, "--output_path", str(out_one)])
    with open(out_dp / "dp_results.json") as f:
        dp = json.load(f)
    assert len(dp["folds"]) == len(one["folds"]) == 2
    for f_dp, f_one in zip(dp["folds"], one["folds"]):
        for row in ("test", "test_ema"):
            if row in f_one:
                for key in keys:
                    assert np.isfinite(f_one[row][key]), (row, key)
                    np.testing.assert_allclose(f_dp[row][key], f_one[row][key], atol=1e-6, err_msg=f"{row} {key}")
    assert sorted(os.listdir(out_dp)) == sorted(os.listdir(out_one))
    lines = res.stdout.splitlines()
    for rank in (1, 2):
        said = [line for line in lines if re.match(rf"\[\w*{rank}\]:", line)]
        assert not [line for line in said if "fold" in line or "results written" in line], said
    assert any(re.match(r"\[\w*0\]:.*results written", line) for line in lines)
