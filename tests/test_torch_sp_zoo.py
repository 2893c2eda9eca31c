"""Sequence parallelism (``mesh_sp > 1``) of the pooling and selection
families against the JAX package's single-device functions on the CPU:
transmil (every positional module), gabmil, meanmil, maxmil, ibmil,
clam_sb, clam_mb, dsmil, and MHIM with the ``dsmil`` baseline and with the
``selfattn`` one and the PEG positional module.

One launch of a gloo world of 4 processes (``tests/torch_dp_worker.py``)
runs every case on its own mesh: the sp row's primitives at ``dp=1, sp=4``
(``sp_pick`` of rows on different ranks; ``sp_argmax`` and the top-k of the
gathered scores with ties that straddle two ranks; ``sp_amax`` with ties on
two ranks), PEG on 4 blocks whose edges fall inside grid rows, each
family's train step at ``dp=2, sp=2``, each family's evaluation forward at
``dp=1, sp=4``, clam_sb's step with its dropouts on at ``dp=1, sp=2``
against the port's one process, and two controls: the row max's cotangent
split among one rank's ties only, and DSMIL's critical instance and CLAM's
top-k chosen on each rank's own block. JAX's side runs in this process on
one device, which JAX's own tests hold equal to its ``(dp, sp)`` mesh.
Both sides start from flax's initial weights (mapped by
``utils/weights.py``); MHIM's uniform draws are fed to both; dropout is
the identity on both sides except in clam_sb's dropout case.

Small widths: input and model dim 32 (MHIM: 64, 4 heads), bags of 64
instance slots, ragged (45 and 30 valid among them: the last block of 16
at sp 4, and of 32 at sp 2, holds only padding), the last a padding bag.
maxmil's batch holds a bag whose valid instances are all zero, so that
its logits tie exactly across both sp ranks (the max's gradient is then
split over the whole bag's ties, as JAX's ``reduce_max`` splits it).

Tolerances are ``tests/test_torch_sp.py``'s: the primitives' outputs bit
for bit (the picks, the indices, the max) and their gradients within 1e-5
of max|g|; PEG's output rtol 1e-5 / atol 1e-5, its gradients 1e-5 of
max|g|; the generic steps' loss rtol 1e-5, Adam's first moments within
1e-5 of max|g| (of the tensor, or of the model where the tensor's whole
gradient lies within that of zero), the parameters by ``_check_params``;
the MHIM steps by ``_check_against_jax`` (loss rtol 1e-5, keep_num and
patch_num rtol 1e-6); the evaluation's logits and attention rtol 1e-4,
atol 1e-5·max|ref|; the dropout case atol 2e-6 against one process; the
driver's test rows within 1e-6 of one process's.
"""

import json
import os
import re
from functools import partial
from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.models.merge as jmerge_mod
import mhim_mil_tpu.ops.masking as jmasking_mod
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.steps import make_train_step as j_make_train_step
from mhim_mil_tpu.engine.train_state import MILTrainState, create_train_state as j_create_train_state
from mhim_mil_tpu.engine.train_state import make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.registry import MODEL_REGISTRY
from mhim_mil_tpu.models.mhim import MHIM as JMHIM, make_mhim_train_step as j_make_mhim_step
from mhim_mil_tpu.models.positional import PEG as JPEG
from mhim_mil_tpu.ops import masked as jmasked
from mhim_mil_tpu.utils import schedules as jsched
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import make_train_step
from mhim_mil_torch.engine.train_state import create_train_state
from mhim_mil_torch.models import build_model
from mhim_mil_torch.models.registry import NOT_PORTED
from mhim_mil_torch.utils import weights
from mhim_mil_torch.utils.weights import state_dict_from_flax
from test_torch_parallel import _check_against_jax, _jax_mu
from test_torch_parallel_zoo import _check_generic_against_jax as _check_zoo_step
from test_torch_sp import GRAD_TOL, SPE, WORKER, _check_params, _close, _grad_close, _group, _np_params, _torchrun

WORLD = 4
ZOO_CFG = dict(input_dim=32, inner_dim=32, n_classes=2, batch_size=8, dropout=0.0, lr=1e-3, lr_sche="const",
               num_epoch=1, aux_alpha=0.5, compute_dtype="float32")
# name: (config overrides, the weight map, attributes set on both models after they are built)
ZOO = {
    "transmil": (dict(model="transmil"), weights.transmil_state_from_flax, {}),
    "transmil_peg": (dict(model="transmil", pos="peg"), weights.transmil_state_from_flax, {}),
    "transmil_sincos": (dict(model="transmil", pos="sincos"), weights.transmil_state_from_flax, {}),
    "transmil_none": (dict(model="transmil", pos="none"), weights.transmil_state_from_flax, {}),
    "gabmil": (dict(model="gabmil"), weights.abmil_state_from_flax, {}),
    "meanmil": (dict(model="meanmil"), weights.mean_max_state_from_flax, {}),
    "maxmil": (dict(model="maxmil"), weights.mean_max_state_from_flax, {}),
    "ibmil": (dict(model="ibmil"), None, {}),  # the map takes the bank: _to_port
    "clam_sb": (dict(model="clam_sb"), partial(weights.clam_state_from_flax, dropout=False), {}),
    "clam_mb": (dict(model="clam_mb", n_classes=3), partial(weights.clam_state_from_flax, dropout=False),
                {"subtyping": True}),
    "dsmil": (dict(model="dsmil"), weights.dsmil_state_from_flax, {}),
}
STEPS = ("transmil", "gabmil", "meanmil", "maxmil", "ibmil", "clam_sb", "clam_mb", "dsmil")  # at dp 2 x sp 2
# MHIM, mining and merge on (tests/test_parallel.py:97-148): the dsmil baseline with B = C = 4, every
# bag valid (JAX's consistency weights broadcast against the class axis: ROADMAP's kept behaviours),
# and the selfattn baseline with PEG between its TransLayers
MHIM_BASE = dict(model="mhim", input_dim=32, inner_dim=64, n_heads=4, batch_size=8, num_epoch=2, lr=1e-3,
                 lr_sche="const", mask_ratio=0.5, mask_ratio_h=0.1, mask_ratio_hr=0.5, merge_enable=True,
                 merge_ratio=0.25, merge_k=2, aux_alpha=0.5, attn2score=True, dropout=0.0, compute_dtype="float32")
MHIM = {"mhim_dsmil": dict(MHIM_BASE, baseline="dsmil", n_classes=WORLD, batch_size=WORLD),
        "mhim_peg": dict(MHIM_BASE, baseline="selfattn", pos="peg")}
# every model the registry builds, at small widths, for the evaluation at sp 2 against one process
REGISTRY = sorted(set(MODEL_REGISTRY) - set(NOT_PORTED))
REGISTRY_CFG = {"mhim": dict(MHIM_BASE, n_classes=2), "mhim_pure": dict(MHIM_BASE, model="mhim_pure", n_classes=2),
                "mambamil": dict(mambamil_dim=32, mambamil_state_dim=8, mambamil_rate=4),
                "2dmamba": dict(mambamil_dim=32, mambamil_state_dim=8), "rrtmil": dict(region_num=2, rrt_n_heads=2)}
LENGTHS = (45, 30, 60, 64, 52, 41, 58, 0)  # 45 and 30: a last block of padding only at sp 4 and at sp 2
ZERO_BAG = 2  # maxmil's bag whose valid instances are all zero: its logits tie across both sp ranks
PEG_N, PEG_C = 1001, 16  # PEG's bag: hw 32, blocks 251/250/250/250 end inside grid rows
PRIM_N = 50  # the primitives' instance axis: blocks 13/13/12/12


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---- inputs ---------------------------------------------------------------------------------


def _batch(name: str, n_classes: int):
    """8 bags of LENGTHS valid instances in 64 slots, the last a padding
    bag; for maxmil bag ZERO_BAG's valid instances all zero."""
    rng = np.random.default_rng(4)
    b, n = len(LENGTHS), 64
    mask = np.arange(n)[None] < np.asarray(LENGTHS)[:, None]
    feats = np.where(mask[..., None], rng.normal(size=(b, n, 32)), 0.0).astype(np.float32)
    if name == "maxmil":
        feats[ZERO_BAG] = 0.0
    return {"feats": feats, "mask": mask, "bag_valid": np.asarray(LENGTHS) > 0,
            "target": (np.arange(b) % n_classes).astype(np.int32)[::-1].copy()}


def _bank_path(tmp) -> str:
    path = os.path.join(str(tmp), "bank.npy")
    if not os.path.exists(path):
        np.save(path, np.random.default_rng(5).normal(size=(4, 32)).astype(np.float32))
    return path


def _to_port(name: str, cfg: dict, params) -> dict:
    if name == "ibmil":
        return weights.ibmil_state_from_flax(params, np.load(cfg["confounder_path"]))
    return ZOO[name][1](params)


def _weights(sd) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def _mhim_batch(name: str):
    rng = np.random.default_rng(6)
    if name == "mhim_dsmil":  # B = C full bags, each of its own class
        b = WORLD
        return {"feats": rng.normal(size=(b, 64, 32)).astype(np.float32), "mask": np.ones((b, 64), bool),
                "bag_valid": np.ones(b, bool), "target": np.arange(b, dtype=np.int32)[::-1].copy()}
    batch = _batch(name, 2)
    batch["target"] = batch["target"] % 2
    return batch


def _registry_model(name: str):
    """The config of the registry's model ``name`` at small widths and the
    port's model of it, from the seed 0."""
    cfg = {**ZOO_CFG, "model": name, **REGISTRY_CFG.get(name, {})}
    model, _ = build_model(load_config([], **cfg), device="cpu", generator=torch.Generator().manual_seed(0))
    return cfg, model


def _mhim_draws(port, batch):
    rng = np.random.default_rng(1)
    b, n = batch["mask"].shape
    d = {f"mask{i}": rng.random((b, n), dtype=np.float32) for i, s in enumerate(port.sched.stages(False)) if s}
    d["merge"] = rng.random((b, port.static_survivors(n)), dtype=np.float32)
    return d


@pytest.fixture(scope="module")
def zoo_tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("sp_zoo")


@pytest.fixture(scope="module")
def inits(zoo_tmp):
    """JAX's initial state of each case, made once: ``(cfg, jcfg, jm,
    family, state, batch)`` for the zoo (transmil's other positional
    modules take its weights, PEG its PPEG's ``proj``; only their
    evaluation reads them), ``(cfg, variables, port model, batch)`` for
    MHIM."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        if name in MHIM:
            cfg = MHIM[name]
            jm, _ = j_build_model(j_load_config([], **cfg))
            batch = _mhim_batch(name)
            rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
            v = jax.jit(partial(jm.init, training=True))(rngs, jnp.asarray(batch["feats"][:1, :16]),
                                                         jnp.asarray(batch["mask"][:1, :16]),
                                                         jnp.zeros((1, 16), jnp.float32))
            v = jax.tree.map(np.asarray, v)
            port, _ = build_model(load_config([], **cfg), device="cpu")
            port.load_state_dict(state_dict_from_flax(v["params"], v.get("buffers")))
            cache[name] = (cfg, v, port, batch)
        elif name.startswith("transmil_"):  # transmil's weights, with the positional module's own
            cfg = {**ZOO_CFG, **ZOO[name][0]}
            _, _, _, family, state, batch = get("transmil")
            jcfg = j_load_config([], **cfg)
            jm, _ = j_build_model(jcfg)
            params = {k: v for k, v in state.params.items() if k != "pos_layer"}
            if cfg["pos"] == "peg":
                params["pos_layer"] = {"proj": state.params["pos_layer"]["proj"]}
            cache[name] = (cfg, jcfg, jm, family, SimpleNamespace(params=params, model_state={}), batch)
        else:
            cfg = {**ZOO_CFG, **ZOO[name][0]}
            if cfg["model"] == "ibmil":
                cfg["confounder_path"] = _bank_path(zoo_tmp)
            jcfg = j_load_config([], **cfg)
            jm, family = j_build_model(jcfg)
            if ZOO[name][2]:
                jm = jm.clone(**ZOO[name][2])
            batch = _batch(name, cfg["n_classes"])
            sample = {k: jnp.asarray(v[:1, :8] if v.ndim > 1 else v[:1]) for k, v in batch.items()}
            state = j_create_train_state(jcfg, jm, jax.random.PRNGKey(0), sample, jsched.make_lr_schedule(jcfg, SPE))
            cache[name] = (cfg, jcfg, jm, family, state, batch)
        return cache[name]

    return get


def _prim_inputs():
    """The primitives' inputs on 2 bags of PRIM_N instances, 3 channels:
    ``x`` with ties planted at the max across ranks (bag 0 channel 0 at 5
    and 40, ranks 0 and 3; bag 1 channel 2 at 12, 13 and 30, ranks 0, 1
    and 2), the rows ``idx`` to pick (on every rank) and the cotangents."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, PRIM_N, 3)).astype(np.float32)
    x[0, [5, 40], 0] = 9.0
    x[1, [12, 13, 30], 2] = 7.0
    x[1, 13, 1] = x[1, 12, 1] = 8.0  # the argmax's tie at the block edge 12 | 13: the lower index wins
    idx = np.array([[0, 13, 26, 49, 13], [38, 12, 25, 1, 37]], np.int64)
    return {"x": x, "idx": idx, "cot_pick": rng.normal(size=(2, 5, 3)).astype(np.float32),
            "cot_max": rng.normal(size=(2, 3)).astype(np.float32)}


def _peg():
    """JAX's PEG at width PEG_C on a bag of PEG_N instances, its params and
    the port's state."""
    rng = np.random.default_rng(3)
    mask = np.arange(PEG_N)[None] < np.array([[PEG_N], [640]])
    x = rng.normal(size=(2, PEG_N, PEG_C)).astype(np.float32)
    jm = JPEG(PEG_C)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))
    sd = {}
    weights.pos_state(sd, "", jax.tree.map(np.asarray, variables["params"]))
    d = {"x": x, "mask": mask, "cot": rng.normal(size=(2, PEG_N, PEG_C)).astype(np.float32)}
    d.update({f"w.{k}": np.asarray(v) for k, v in sd.items()})
    return jm, variables, d


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

    prim = _prim_inputs()
    mops = dict(kind="mesh_ops", dp=1, sp=WORLD)
    add({"name": "pick", "op": "pick", **mops}, **{"in": {"x": prim["x"], "idx": prim["idx"], "cot": prim["cot_pick"]}})
    add({"name": "argmax", "op": "argmax", "k": 4, **mops}, **{"in": {"x": prim["x"]}})
    add({"name": "amax", "op": "amax", **mops}, **{"in": {"x": prim["x"], "cot": prim["cot_max"]}})
    add({"name": "control_local_ties", "op": "amax", "control": "local_ties", **mops},
        **{"in": {"x": prim["x"], "cot": prim["cot_max"]}})
    add({"name": "peg", "kind": "ops", "op": "peg", "dp": 1, "sp": WORLD}, **{"in": _peg()[2]})
    for name in ZOO:
        cfg, _, _, _, jstate, batch = inits(name)
        w = _weights(_to_port(name, cfg, _np_params(jstate.params)))
        common = {"cfg": cfg, "attrs": ZOO[name][2]}
        if name in STEPS:
            add({"name": name, "kind": "generic_step", "dp": 2, "sp": 2, "spe": SPE, "dropout": False, **common},
                w=w, batch=batch)
        add({"name": f"eval_{name}", "kind": "forward", "dp": 1, "sp": WORLD, "gather_attn": True, **common},
            w=w, batch=batch)
        if name == "clam_sb":  # with its dropouts the Sequentials hold one more layer
            w_drop = _weights(weights.clam_state_from_flax(_np_params(jstate.params), dropout=True))
            add({"name": "clam_sb_dropout", "kind": "generic_step", "dp": 1, "sp": 2, "spe": SPE,
                 "cfg": {**cfg, "dropout": 0.25}, "attrs": {}}, w=w_drop, batch=batch)
            add({"name": "control_local_topk", "kind": "generic_step", "dp": 2, "sp": 2, "spe": SPE,
                 "dropout": False, "control": "local_pick", **common}, w=w, batch=batch)
        if name == "dsmil":
            add({"name": "control_local_argmax", "kind": "forward", "dp": 1, "sp": WORLD, "gather_attn": True,
                 "control": "local_pick", **common}, w=w, batch=batch)
    for name in MHIM:
        cfg, _, port, batch = inits(name)
        w = _weights(port.state_dict())
        add({"name": name, "kind": "mhim_step", "cfg": cfg, "dp": 2, "sp": 2, "spe": SPE, "dropout": False}, w=w,
            batch=batch, draw=_mhim_draws(port, batch))
        add({"name": f"eval_{name}", "kind": "forward", "cfg": cfg, "dp": 1, "sp": WORLD, "gather_attn": True}, w=w,
            batch=batch)
    for name in REGISTRY:
        cfg, model = _registry_model(name)
        add({"name": f"registry_{name}", "kind": "forward", "cfg": cfg, "dp": 1, "sp": 2},
            w=_weights(model.state_dict()), batch=_batch(name, 2))
    arrays["spec"] = np.asarray(json.dumps(specs))
    np.savez(zoo_tmp / "in.npz", **arrays)
    _torchrun(WORLD, [WORKER, str(zoo_tmp / "in.npz"), str(zoo_tmp / "out.npz")])
    out = np.load(zoo_tmp / "out.npz")
    results = {}
    for k in out.files:
        case, rest = k.split("/", 1)
        results.setdefault(case, {})[rest] = out[k]
    return inputs, results


# ---- the sp row's primitives and PEG on sp 4 against JAX ----------------------------------------


def test_pick_fetches_rows_from_their_owners(world):
    """``sp_pick`` of rows that sit on all 4 ranks (13 twice), the result
    on every rank, against ``jnp.take_along_axis``: the rows bit for bit,
    and the gradient of Σ rows·cot (a row picked twice gets both
    cotangents) against JAX's VJP."""
    inputs, results = world
    d, res = inputs["pick"]["in"], results["pick"]
    fn = lambda x: jnp.take_along_axis(x, jnp.asarray(d["idx"])[..., None], axis=1)  # noqa: E731
    want, vjp = jax.vjp(fn, jnp.asarray(d["x"]))
    np.testing.assert_array_equal(res["out/y"], np.asarray(want))
    _grad_close(res["grad/x"], vjp(jnp.asarray(d["cot"]))[0], "d x")


def test_argmax_and_topk_break_ties_to_the_lower_global_index(world):
    """``sp_argmax`` over 4 blocks against ``jnp.argmax`` (bag 1 channel 1
    ties at 12 and 13, on ranks 0 and 1: 12 wins; channel 2 ties at 12, 13
    and 30); the top-4 of the gathered scores against ``lax.top_k``, index
    for index."""
    inputs, results = world
    x = jnp.asarray(inputs["argmax"]["in"]["x"])
    res = results["argmax"]
    np.testing.assert_array_equal(res["out/argmax"], np.asarray(jnp.argmax(x, axis=1)))
    assert res["out/argmax"][1, 1] == 12 and res["out/argmax"][1, 2] == 12
    np.testing.assert_array_equal(res["out/topk"], np.asarray(jax.lax.top_k(jnp.swapaxes(x, 1, 2), 4)[1]))


def _check_amax(res, d):
    want, vjp = jax.vjp(lambda x: jnp.max(x, axis=1), jnp.asarray(d["x"]))
    np.testing.assert_array_equal(res["out/y"], np.asarray(want))
    _grad_close(res["grad/x"], vjp(jnp.asarray(d["cot"]))[0], "d x")


def test_row_max_splits_the_cotangent_among_the_rows_ties(world):
    """``sp_amax`` over 4 blocks against ``jnp.max``: the max bit for bit,
    and the cotangent split evenly among the entries tied at it over the
    whole row (bag 0 channel 0: two, on ranks 0 and 3; bag 1 channel 2:
    three, on ranks 0, 1 and 2), as JAX's ``reduce_max`` VJP splits it."""
    inputs, results = world
    _check_amax(results["amax"], inputs["amax"]["in"])


def test_control_row_max_with_per_rank_tie_counts_misses_jax(world):
    """The test sees the tie rule: each rank dividing by its own count of
    ties (the sum over the row then gives tied entries more than the
    cotangent) misses JAX's VJP."""
    inputs, results = world
    with pytest.raises(AssertionError):
        _check_amax(results["control_local_ties"], inputs["control_local_ties"]["in"])


def test_peg_blocks_match_jax(world):
    """PEG (one depthwise 7 × 7 convolution plus identity on the whole
    bag's 32 × 32 grid) on 4 blocks of 1,001 instances whose edges fall
    inside grid rows, the halo rows read from the neighbours, against JAX's
    PEG: out rtol 1e-5 / atol 1e-5, the gradients for x and the convolution
    within 1e-5 of max|g|."""
    inputs, results = world
    d, res = inputs["peg"]["in"], results["peg"]
    jm, variables, _ = _peg()
    fn = lambda p, x: jm.apply({"params": p}, x, jnp.asarray(d["mask"]))  # noqa: E731
    want_out, vjp = jax.vjp(fn, variables["params"], jnp.asarray(d["x"]))
    d_params, want_dx = vjp(jnp.asarray(d["cot"]))
    want_p = {}
    weights.pos_state(want_p, "", jax.tree.map(np.asarray, d_params))
    _close(res["out/out"], want_out, rtol=1e-5, atol=1e-5, msg="out")
    _grad_close(res["grad/x"], want_dx, "d x")
    assert set(_group(res, "pgrad")) == set(want_p)
    for k, g in want_p.items():
        _grad_close(res[f"pgrad/{k}"], g, f"d {k}")


# ---- the steps at dp 2 x sp 2 against JAX's single-device step ------------------------------------


def _check_generic_against_jax(name, cfg, res, s2, jmetrics, lr):
    _check_zoo_step(name, cfg, res, s2, jmetrics, lr, to_port=_to_port)


@pytest.fixture(scope="module")
def jax_steps(inits):
    """JAX's single-device generic step of each case, made once."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, jcfg, jm, family, state, batch = inits(name)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
                s2, m = j_make_train_step(jcfg, jm, family, SPE, donate=False)(
                    state, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[name] = (jcfg, s2, {k: float(v) for k, v in m.items()})
        return cache[name]

    return get


@pytest.mark.parametrize("name", STEPS)
def test_zoo_sp_step_matches_jax(world, inits, jax_steps, name):
    """The generic train step at dp 2 × sp 2 (each rank 4 bags' halves of
    the instances) against JAX's single-device step: transmil (K3's plain
    versions on the blocks, the cls token on rank 0), gabmil's gated pool,
    meanmil's sums and counts, maxmil's row max with a bag tied across
    both ranks, ibmil's pool, CLAM's pool and instance loss (the top-k
    from the gathered logits, the features fetched; clam_mb with 3 classes
    and subtyping), DSMIL's critical instance, softmax, bag sum and
    instance max. Loss and aux loss rtol 1e-5, gradients, parameters."""
    _, results = world
    jcfg, s2, jmetrics = jax_steps(name)
    _check_generic_against_jax(name, inits(name)[0], results[name], s2, jmetrics, jcfg.lr)
    if name.startswith("clam") or name == "dsmil":
        assert float(results[name]["m/aux_loss"]) > 0, name


def test_control_per_rank_topk_misses_jax(world, inits, jax_steps):
    """The test sees the picks: clam_sb's step with its top-k and bottom-k
    chosen on each rank's block, their features read there, misses JAX."""
    _, results = world
    jcfg, s2, jmetrics = jax_steps("clam_sb")
    with pytest.raises(AssertionError):
        _check_generic_against_jax("clam_sb", inits("clam_sb")[0], results["control_local_topk"], s2, jmetrics,
                                   jcfg.lr)


def test_clam_sp_dropout_draws_equal_one_process(world, inits):
    """clam_sb's dropouts on (0.25 after the embed and in the gated
    attention): dp 1 × sp 2, each rank keeping its block of the global
    draw (``rand_rows`` with the layout), equals the port's one-process
    step within atol 2e-6: metrics, gradients and parameters."""
    inputs, results = world
    cfg = load_config([], **{**inits("clam_sb")[0], "dropout": 0.25})
    w, batch = inputs["clam_sb_dropout"]["w"], inputs["clam_sb_dropout"]["batch"]
    model, family = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    state = create_train_state(cfg, model, SPE, device="cpu")
    metrics = make_train_step(cfg, family, SPE, device="cpu")(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    res = results["clam_sb_dropout"]
    for k, v in metrics.items():
        _close(res[f"m/{k}"], v, rtol=0, atol=2e-6, msg=k)
    grads = {k: state.optimizer.opt.state[p]["exp_avg"].numpy() for k, p in state.model.named_parameters()}
    top = max(np.abs(g).max() for g in grads.values())
    for k, p in state.model.named_parameters():
        g = grads[k]
        _close(res[f"g/{k}"], g, rtol=0, atol=2e-6, msg=f"gradient {k}")
        scale = np.abs(g).max() if np.abs(g).max() > GRAD_TOL * top else top
        _check_params(k, res[f"s/{k}"], p.detach().numpy(), g, cfg.lr, rtol=0, atol=2e-6, scale=scale)


def _jax_mhim_step(monkeypatch, cfg, v, batch, draws):
    """JAX's MHIM step on one device from flax's params ``v``, fed
    ``draws``, dropout off."""
    params = jax.tree.map(jnp.asarray, v["params"])
    model_state = {"buffers": v["buffers"]} if "buffers" in v else {}
    jcfg = j_load_config([], **cfg)
    jmodel, _ = j_build_model(jcfg)
    tx = j_make_optimizer(jcfg, jsched.make_lr_schedule(jcfg, SPE))
    state = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=model_state,
                          teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                          rng=jax.random.PRNGKey(0), tx=tx, apply_fn=jmodel.apply)
    order = iter([draws[k] for k in sorted(draws) if k.startswith("mask")] + [draws["merge"]])

    def fed(rng, pool, k):
        u = next(order)
        assert u.shape == pool.shape
        return jmasked.topk_mask(jnp.asarray(u), pool, k, largest=True)

    monkeypatch.setattr(jmasking_mod, "random_subset_mask", fed)
    monkeypatch.setattr(jmerge_mod, "random_subset_mask", fed)
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    s2, m = j_make_mhim_step(jcfg, jmodel, SPE)(state, {k: jnp.asarray(x) for k, x in batch.items()})
    assert next(order, None) is None  # every draw was taken
    return jax.tree.map(np.asarray, s2), {k: float(m[k]) for k in m}


@pytest.mark.parametrize("name", list(MHIM))
def test_mhim_sp_step_matches_jax(world, inits, monkeypatch, name):
    """MHIM with mining and merge on at dp 2 × sp 2 against JAX's
    single-device step: the dsmil baseline (the teacher's and the student's
    DSMIL heads on the blocks, the merged tokens on the last rank, the
    consistency loss on the ``[B, C, D]`` bag feature) and the selfattn
    baseline with PEG (its halo rows on the blocks): loss, keep_num,
    patch_num, gradients, student, Merge's ``global_q_mm`` and teacher
    (``_check_against_jax``)."""
    inputs, results = world
    _, v, _, batch = inits(name)
    jstate, jmetrics = _jax_mhim_step(monkeypatch, MHIM[name], v, batch, inputs[name]["draw"])
    ref = {"name": name, "jstate": jstate, "jmetrics": jmetrics, "jmu": _jax_mu(jstate)}
    _check_against_jax(results[name], ref, loss_rtol=1e-5)
    assert float(results[name]["m/aux_loss"]) > 0


# ---- the evaluation at dp 1 x sp 4 against JAX's forward -----------------------------------------


def _jax_forward(name, inits):
    if name in MHIM:
        _, v, _, batch = inits(name)
        jm, _ = j_build_model(j_load_config([], **MHIM[name]))
        return jax.jit(lambda f, m: jm.apply(v, f, m, return_attn=True, method=JMHIM.forward_test))(
            batch["feats"], batch["mask"])
    _, _, jm, _, state, batch = inits(name)
    return jax.jit(lambda p, f, m: jm.apply({"params": p, **state.model_state}, f, m, training=False,
                                            return_attn=True))(state.params, batch["feats"], batch["mask"])


def _check_forward(res, want):
    for k in ("logits", "inst_logits_bag", "attn"):
        if k in want:
            _close(res[k], want[k], rtol=1e-4, atol=1e-5 * float(jnp.abs(want[k]).max()), msg=k)
        else:
            assert k not in res, k


@pytest.mark.parametrize("name", [*ZOO, *MHIM])
def test_sp_eval_matches_jax(world, inits, name):
    """The evaluation forward (``forward_test`` for MHIM) with
    ``return_attn`` at dp 1 × sp 4, against JAX's on one device: the
    logits, DSMIL's max-pooled instance logits, and the attention gathered
    from the blocks where the model gives it (transmil with each
    positional module: its cls row of layer 2 over the instances; the
    pools' weights; DSMIL's instance scores)."""
    _, results = world
    _check_forward(results[f"eval_{name}"], _jax_forward(name, inits))


def test_control_per_rank_argmax_misses_jax(world, inits):
    """The test sees the critical instance: DSMIL's forward with each rank
    taking the argmax of its own block and reading its features there
    misses JAX's logits."""
    _, results = world
    with pytest.raises(AssertionError):
        _check_forward(results["control_local_argmax"], _jax_forward("dsmil", inits))


# ---- the gate, and the driver through its command line --------------------------------------------


@pytest.mark.parametrize("name", REGISTRY)
def test_sp_gate_admits_this_slice_and_names_6d_iii(world, name):
    """Every model the registry builds (the JAX registry's names, none left
    unported) runs its evaluation forward (MHIM's ``forward_test``) at dp 1
    × sp 2 on the ragged batch, its logits within rtol 1e-4, atol
    1e-5·max|ref| of the port's one process on the whole bags."""
    inputs, results = world
    _, model = _registry_model(name)
    batch = {k: torch.from_numpy(v) for k, v in inputs[f"registry_{name}"]["batch"].items()}
    with torch.no_grad():
        fwd = model.forward_test if name in ("mhim", "mhim_pure") else partial(model, training=False)
        want = fwd(batch["feats"], batch["mask"])["logits"].numpy()
    _close(results[f"registry_{name}"]["logits"], want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()),
           msg=f"{name} logits")


def test_driver_sp_transmil_matches_one_process(tmp_path):
    """``torch.distributed.run --nproc_per_node 4`` with ``--mesh_dp 2
    --mesh_sp 2``: 2 folds × 2 epochs of transmil on synthetic bags of 64
    instances: the test rows' AUC and accuracy within 1e-6 of the
    one-process run, the same files, rank 0 alone printed and wrote."""
    from mhim_mil_torch.main import main

    argv = ["--datasets", "synth", "--model", "transmil", "--input_dim", "32", "--inner_dim", "32",
            "--synth_n_slides", "16", "--synth_bag_size", "64", "--bucket_sizes", "64", "--batch_size", "4",
            "--cv_fold", "2", "--num_epoch", "2", "--max_epoch", "2", "--lr", "1e-3", "--lr_sche", "const",
            "--num_bootstrap", "5", "--compute_dtype", "float32", "--title", "sp"]
    out_sp, out_one = tmp_path / "sp", tmp_path / "one"
    res = _torchrun(WORLD, ["-m", "mhim_mil_torch.main", "--device", "cpu", *argv, "--mesh_dp", "2", "--mesh_sp", "2",
                            "--output_path", str(out_sp)])
    one = main(["--device", "cpu", *argv, "--output_path", str(out_one)])
    with open(out_sp / "sp_results.json") as f:
        sp = json.load(f)
    assert len(sp["folds"]) == len(one["folds"]) == 2
    for f_sp, f_one in zip(sp["folds"], one["folds"]):
        for row in ("test", "test_ema"):
            if row in f_one:
                for key in ("auc", "acc"):
                    assert np.isfinite(f_one[row][key]), (row, key)
                    np.testing.assert_allclose(f_sp[row][key], f_one[row][key], atol=1e-6, err_msg=f"{row} {key}")
    assert sorted(os.listdir(out_sp)) == sorted(os.listdir(out_one))
    lines = res.stdout.splitlines()
    for rank in (1, 2, 3):
        said = [line for line in lines if re.match(rf"\[\w*{rank}\]:", line)]
        assert not [line for line in said if "fold" in line or "results written" in line], said
    assert any(re.match(r"\[\w*0\]:.*results written", line) for line in lines)
