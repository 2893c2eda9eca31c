"""Sequence parallelism (``mesh_sp > 1``) of the last three paths against
the JAX package's single-device functions on the CPU: DTFD (``AFS``,
``MaxS``, ``MaxMinS``), RRT-MIL and the ``parity`` Nystrom path; and two
sp configurations that no other file holds: ``mhim_pure`` with the
``dsmil`` baseline and with the ``selfattn`` one and PEG.

One launch of a gloo world of 4 processes (``tests/torch_dp_worker.py``)
runs every case on its own mesh: ``nystrom_attention(parity=True)`` at
``dp=1, sp=4`` on a length whose front padding is 14 tokens (the padding in
front of rank 0's block) and on one that needs none, and MHIM's selfattn
module built with ``parity`` (cls token and padding on rank 0); DTFD's
train step for each distillation at ``dp=2, sp=2`` and its evaluation at
``dp=1, sp=4``; RRT-MIL's train step at ``dp=2, sp=2`` with 2 × 2 regions
(each 4 × 4 region's rows fall in two instance blocks) and with one
region (sp rank 1 owns none), its evaluation at ``dp=1, sp=4`` with 2 × 2,
3 × 3 (3, 2, 2 and 2 regions a rank) and one region (ranks 1-3 own none);
RRT-MIL's step with its dropouts on at ``dp=1, sp=2`` (3 × 3 regions, 5
and 4 a rank) against the port's one process; ``mhim_pure``'s steps at
``dp=2, sp=2``; and two controls: DTFD's
pseudo-bags taken from each rank's own valid instances, and RRT-MIL's
regions cut from each rank's own block. JAX's references are computed
while the world runs.

DTFD's batch: 8 bags of 64 instance slots, one of 3 valid instances (fewer
than its 5 pseudo-bags), one of 45 (a last block of padding only at sp 4),
a padding bag, and one whose 6 valid instances sit at 20 and 52-56: its
first pseudo-bag is {20, 52}, one instance on each sp rank. Their
features differ only in a column that ``dimReduction`` weighs by zero, so
their CAM scores tie bit for bit on both sides and ``MaxS`` and
``MaxMinS`` must pick 20, the lowest global index, as ``jnp.argmax`` and
``jnp.argmin`` do; the column's gradient tells the two apart.

Tolerances are ``tests/test_torch_sp_zoo.py``'s: the steps' loss rtol 1e-5,
Adam's first moments within 1e-5 of max|g| (of the tensor, or of the model
where the tensor's whole gradient lies within that of zero), the
parameters by ``_check_params``; the MHIM steps by ``_check_against_jax``
(loss rtol 1e-5, keep_num and patch_num rtol 1e-6); the evaluation's
logits and attention rtol 1e-4, atol 1e-5·max|ref|; the Nystrom op and the
selfattn module rtol 1e-4, atol 1e-5·max|ref| with their gradients within
1e-5 of max|g|; the dropout case atol 2e-6 against one process.
"""

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.steps import make_train_step as j_make_train_step
from mhim_mil_tpu.engine.train_state import MILTrainState, create_train_state as j_create_train_state
from mhim_mil_tpu.engine.train_state import make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import baselines as jbaselines
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.mhim import make_mhim_train_step as j_make_mhim_step
from mhim_mil_tpu.models.transformer import TransLayer as JTransLayer
from mhim_mil_tpu.ops import nystrom as jnys
from mhim_mil_tpu.utils import schedules as jsched
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import make_train_step
from mhim_mil_torch.engine.train_state import create_train_state
from mhim_mil_torch.models import build_model
from mhim_mil_torch.models.rrt import region_index, region_layout, row_major_index
from mhim_mil_torch.utils import weights
from mhim_mil_torch.utils.weights import state_dict_from_flax
from test_torch_parallel import _check_against_jax, _jax_mu
from test_torch_parallel_zoo import _check_generic_against_jax as _check_zoo_step, _no_dropout_in_jax
from test_torch_sp import (GRAD_TOL, REPO, SPE, TIMEOUT_S, WORKER, _check_params, _close, _env, _grad_close, _group,
                           _np_params)
from test_torch_sp_zoo import MHIM, ZOO_CFG, _batch, _check_forward, _mhim_batch, _weights

WORLD = 4
DISTILLS = ("AFS", "MaxS", "MaxMinS")
DTFD_LENGTHS = (45, 3, 0, 64, 52, 30, 58, 0)  # bag 2's valid instances are planted: TIE_BAG
TIE_BAG, TIE_AT, TIE_COL = 2, (20, 52), 5  # bag 2's first pseudo-bag, one instance on each sp rank
RRT_CFG = {**ZOO_CFG, "model": "rrtmil", "region_num": 2, "rrt_n_heads": 2}
RRT_STEPS = {"rrtmil": 2, "rrtmil_one_region": 1}  # case: region_num, at dp 2 x sp 2
RRT_EVALS = (2, 3, 1)  # region_num of the evaluations at dp 1 x sp 4
RRT_DROPOUT_REGIONS = 3
PURE = {"mhim_pure_dsmil": dict(MHIM["mhim_dsmil"], model="mhim_pure"),
        "mhim_pure_peg": dict(MHIM["mhim_peg"], model="mhim_pure")}
PARITY = {"parity_pad": dict(b=2, n=50, h=2, dh=8, m=16, lengths=(50, 37)),  # front padding 14
          "parity_even": dict(b=2, n=64, h=2, dh=8, m=16, lengths=(64, 45))}  # none
JAX_THREADS = 4  # JAX's inits and references compile in this many threads, the references while the world runs
SATT = dict(dim=32, heads=4, n=45, lengths=(45, 33))  # 46 tokens with the cls token, 16 landmarks: padding 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---- inputs ---------------------------------------------------------------------------------


def _dtfd_batch():
    """8 bags of DTFD_LENGTHS valid instances in 64 slots, the last a padding
    bag; bag TIE_BAG holds 6 valid instances at 20 and 52-56, the two of
    TIE_AT equal but in column TIE_COL."""
    rng = np.random.default_rng(8)
    b, n = len(DTFD_LENGTHS), 64
    mask = np.arange(n)[None] < np.asarray(DTFD_LENGTHS)[:, None]
    mask[TIE_BAG, [TIE_AT[0], *range(TIE_AT[1], TIE_AT[1] + 5)]] = True
    feats = np.where(mask[..., None], rng.normal(size=(b, n, 32)), 0.0).astype(np.float32)
    feats[TIE_BAG, TIE_AT[1]] = feats[TIE_BAG, TIE_AT[0]]
    feats[TIE_BAG, TIE_AT, TIE_COL] = (3.0, -3.0)
    return {"feats": feats, "mask": mask, "bag_valid": mask.any(axis=1),
            "target": (np.arange(b) % 2).astype(np.int32)[::-1].copy()}


def _jax_init(cfg: dict, batch):
    jcfg = j_load_config([], **cfg)
    jm, family = j_build_model(jcfg)
    sample = {k: jnp.asarray(v[:1, :8] if v.ndim > 1 else v[:1]) for k, v in batch.items()}
    state = j_create_train_state(jcfg, jm, jax.random.PRNGKey(0), sample, jsched.make_lr_schedule(jcfg, SPE))
    return jcfg, jm, family, state


def _parity_inputs(name: str):
    p = PARITY[name]
    rng = np.random.default_rng(9)
    shape = (p["b"], p["h"], p["n"], p["dh"])
    d = {k: rng.normal(size=shape).astype(np.float32) for k in ("q", "k", "v", "cot_out")}
    d["q"] *= p["dh"] ** -0.5
    d["mask"] = np.arange(p["n"])[None] < np.asarray(p["lengths"])[:, None]
    d["cot_attn"] = rng.normal(size=shape[:3]).astype(np.float32)
    return d


@lru_cache(maxsize=None)
def _sattention():
    """JAX's selfattn module at SATT's width, its params and the inputs (the
    port's weights among them, ``w.<key>``)."""
    rng = np.random.default_rng(10)
    b, n, c = len(SATT["lengths"]), SATT["n"], SATT["dim"]
    mask = np.arange(n)[None] < np.asarray(SATT["lengths"])[:, None]
    x = np.where(mask[..., None], rng.normal(size=(b, n, c)), 0.0).astype(np.float32)
    jm = jbaselines.SAttentionBaseline(dim=c, heads=SATT["heads"])
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask))["params"])
    sd = {}
    weights.sattention_state(sd, "", params)
    d = {"x": x, "mask": mask, "cot": rng.normal(size=(b, c)).astype(np.float32),
         "cot_attn": rng.normal(size=(b, SATT["heads"], n)).astype(np.float32)}
    d.update({f"w.{k}": v.numpy() for k, v in sd.items()})
    return jm, params, d


def _to_port(name: str, cfg: dict, params) -> dict:
    if cfg["model"] == "dtfd":
        return weights.dtfd_state_from_flax(params)
    return weights.rrtmil_state_from_flax(params)


@pytest.fixture(scope="module")
def sp_tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("sp_last")


@pytest.fixture(scope="module")
def inits():
    """JAX's initial states, made once: DTFD's (``dimReduction``'s column
    TIE_COL zeroed) and RRT-MIL's (its params do not depend on
    region_num) as ``(cfg, jcfg, jm, family, state, batch)``; MHIM's flax
    variables as ``(cfg, variables, port model, batch)``."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        if name in PURE:
            cfg = PURE[name]
            jm, _ = j_build_model(j_load_config([], **cfg))
            batch = _mhim_batch(name.replace("_pure", ""))
            rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
            v = jax.jit(partial(jm.init, training=True))(rngs, jnp.asarray(batch["feats"][:1, :16]),
                                                         jnp.asarray(batch["mask"][:1, :16]),
                                                         jnp.zeros((1, 16), jnp.float32))
            v = jax.tree.map(np.asarray, v)
            port, _ = build_model(load_config([], **cfg), device="cpu")
            port.load_state_dict(state_dict_from_flax(v["params"], v.get("buffers")))
            cache[name] = (cfg, v, port, batch)
        elif name == "dtfd":
            cfg = {**ZOO_CFG, "model": "dtfd"}
            batch = _dtfd_batch()
            jcfg, jm, family, state = _jax_init(cfg, batch)
            params = jax.tree.map(jnp.asarray, state.params)
            params["dimReduction"]["kernel"] = params["dimReduction"]["kernel"].at[TIE_COL].set(0.0)
            cache[name] = (cfg, jcfg, jm, family, state.replace(params=params), batch)
        else:
            batch = _batch("rrtmil", 2)
            cache[name] = (RRT_CFG, *_jax_init(RRT_CFG, batch), batch)
        return cache[name]

    return get


def _variant(inits, base: str, **over):
    """The case ``base`` with config overrides ``over`` (DTFD's ``distill``
    set on the model): ``(cfg, jcfg, jm, family, state, batch, attrs)``."""
    cfg, _, _, family, state, batch = inits(base)
    distill = over.pop("distill", None)
    cfg = {**cfg, **over}
    jcfg = j_load_config([], **cfg)
    jm, _ = j_build_model(jcfg)
    attrs = {}
    if distill:
        jm, attrs = jm.clone(distill=distill), {"distill": distill}
    return cfg, jcfg, jm, family, state, batch, attrs


def _launch(nproc: int, args, log):
    """``torch.distributed.run`` of ``nproc`` ranks in the background, its
    output to the file ``log`` (``tests/test_torch_sp.py``'s ``_torchrun``,
    without waiting)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           "--tee", "3", *args]
    with open(log, "w") as f:
        return subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=f, stderr=subprocess.STDOUT, text=True), cmd


def _jax_step(jcfg, jm, family, state, batch):
    """JAX's single-device generic step: the state after it and its metrics."""
    s2, m = j_make_train_step(jcfg, jm, family, SPE, donate=False)(state, {k: jnp.asarray(v) for k, v in
                                                                          batch.items()})
    return s2, {k: float(v) for k, v in m.items()}


def _jax_pure_step(cfg, v, batch):
    """JAX's ``mhim_pure`` step on one device from flax's variables ``v``,
    dropout off (the teacher stage draws nothing else), as
    ``_check_against_jax`` reads it."""
    params = jax.tree.map(jnp.asarray, v["params"])
    model_state = {"buffers": v["buffers"]} if "buffers" in v else {}
    jcfg = j_load_config([], **cfg)
    jmodel, _ = j_build_model(jcfg)
    tx = j_make_optimizer(jcfg, jsched.make_lr_schedule(jcfg, SPE))
    state = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=model_state,
                          teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                          rng=jax.random.PRNGKey(0), tx=tx, apply_fn=jmodel.apply)
    s2, m = j_make_mhim_step(jcfg, jmodel, SPE)(state, {k: jnp.asarray(x) for k, x in batch.items()})
    jstate = jax.tree.map(np.asarray, s2)
    return {"name": cfg["model"], "jstate": jstate, "jmetrics": {k: float(m[k]) for k in m}, "jmu": _jax_mu(jstate)}


def _jax_forward(jm, state, batch):
    return jax.jit(lambda p, f, m: jm.apply({"params": p, **state.model_state}, f, m, training=False,
                                            return_attn=True))(state.params, batch["feats"], batch["mask"])


def _jax_parity(d, m):
    """JAX's parity op on the whole bags: ``(out, attn)`` and the
    gradients for q, k and v of Σ out·cot_out + attn·cot_attn."""
    mask = jnp.asarray(d["mask"])
    fn = jax.jit(lambda q, k, v: jnys.nystrom_attention(q, k, v, mask, m, return_attn=True, parity=True))
    outs, vjp = jax.vjp(fn, *(jnp.asarray(d[k]) for k in ("q", "k", "v")))
    return outs, vjp((jnp.asarray(d["cot_out"]), jnp.asarray(d["cot_attn"])))


def _jax_sattention(d):
    """JAX's selfattn module with its TransLayers built with ``parity``:
    ``(cls_feat, attn)``, and the gradients for its params (by the port's
    names) and x."""
    jm, params, _ = _sattention()
    mask = jnp.asarray(d["mask"])

    def fn(p, x):
        out = jm.apply({"params": p}, x, mask, return_attn=True)
        return out["cls_feat"], out["attn"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbaselines, "TransLayer", partial(JTransLayer, parity=True))
        outs, vjp = jax.vjp(jax.jit(fn), params, jnp.asarray(d["x"]))
        d_params, d_x = vjp((jnp.asarray(d["cot"]), jnp.asarray(d["cot_attn"])))
    want_p = {}
    weights.sattention_state(want_p, "", jax.tree.map(np.asarray, d_params))
    return outs, {k: v.numpy() for k, v in want_p.items()}, d_x


@pytest.fixture(scope="module")
def world(sp_tmp, inits):
    """One gloo world of WORLD ranks running every case, in the background
    while JAX's side computes its references in this process; returns the
    cases' inputs, rank 0's results and JAX's references, by case."""
    specs, arrays, inputs, jobs = [], {}, {}, {}

    def add(spec, ref=None, **groups):
        specs.append(spec)
        inputs[spec["name"]] = groups
        for g, d in groups.items():
            for k, v in d.items():
                arrays[f"{spec['name']}/{g}/{k}"] = np.asarray(v)
        if ref is not None:
            jobs[spec["name"]] = ref

    with ThreadPoolExecutor(JAX_THREADS) as pool:  # JAX's initial states, made once
        list(pool.map(lambda f: f(), [_sattention, *(partial(inits, n) for n in ("rrtmil", "dtfd", *PURE))]))
    for name, p in PARITY.items():
        d = _parity_inputs(name)
        add({"name": name, "kind": "ops", "op": "materialising", "parity": True, "m": p["m"], "dp": 1, "sp": WORLD},
            partial(_jax_parity, d, p["m"]), **{"in": d})
    d = _sattention()[2]
    add({"name": "sattention", "kind": "ops", "op": "sattention", "heads": SATT["heads"], "dp": 1, "sp": WORLD},
        partial(_jax_sattention, d), **{"in": d})
    step = dict(kind="generic_step", dp=2, sp=2, spe=SPE, dropout=False)
    for distill in DISTILLS:
        cfg, jcfg, jm, family, state, batch, attrs = _variant(inits, "dtfd", distill=distill)
        w = _weights(_to_port("dtfd", cfg, _np_params(state.params)))
        add({"name": f"dtfd_{distill}", "cfg": cfg, "attrs": attrs, **step},
            partial(_jax_step, jcfg, jm, family, state, batch), w=w, batch=batch)
        add({"name": f"eval_dtfd_{distill}", "kind": "forward", "cfg": cfg, "attrs": attrs, "dp": 1, "sp": WORLD,
             "gather_attn": True}, partial(_jax_forward, jm, state, batch), w=w, batch=batch)
        if distill == "MaxS":
            add({"name": "control_local_ids", "cfg": cfg, "attrs": attrs, "control": "local_ids", **step}, w=w,
                batch=batch)
    for name, regions in RRT_STEPS.items():
        cfg, jcfg, jm, family, state, batch, _ = _variant(inits, "rrtmil", region_num=regions)
        w = _weights(_to_port("rrtmil", cfg, _np_params(state.params)))
        add({"name": name, "cfg": cfg, **step}, partial(_jax_step, jcfg, jm, family, state, batch), w=w, batch=batch)
    cfg = RRT_CFG
    add({"name": "control_local_regions", "cfg": cfg, "control": "local_regions", **step}, w=w, batch=batch)
    for regions in RRT_EVALS:
        _, _, jm, _, state, _, _ = _variant(inits, "rrtmil", region_num=regions)
        add({"name": f"eval_rrtmil_{regions}", "kind": "forward", "cfg": {**cfg, "region_num": regions}, "dp": 1,
             "sp": WORLD, "gather_attn": True}, partial(_jax_forward, jm, state, batch), w=w, batch=batch)
    add({"name": "rrtmil_dropout", "kind": "generic_step", "dp": 1, "sp": 2, "spe": SPE,
         "cfg": {**cfg, "region_num": RRT_DROPOUT_REGIONS, "dropout": 0.25}}, w=w, batch=batch)
    for name in PURE:
        cfg, v, port, batch = inits(name)
        add({"name": name, "kind": "mhim_step", "cfg": cfg, "dp": 2, "sp": 2, "spe": SPE, "dropout": False},
            partial(_jax_pure_step, cfg, v, batch), w=_weights(port.state_dict()), batch=batch)
    arrays["spec"] = np.asarray(json.dumps(specs))
    np.savez(sp_tmp / "in.npz", **arrays)
    log = sp_tmp / "world.log"
    proc, cmd = _launch(WORLD, [WORKER, str(sp_tmp / "in.npz"), str(sp_tmp / "out.npz")], log)
    try:
        refs = {"sattention": jobs.pop("sattention")()}  # patches JAX's baselines module: alone
        with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(JAX_THREADS) as pool:
            _no_dropout_in_jax(mp)
            refs.update(zip(jobs, pool.map(lambda job: job(), jobs.values())))
        proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"{' '.join(cmd)} failed:\n{log.read_text()[-8000:]}"
    out = np.load(sp_tmp / "out.npz")
    results = {}
    for k in out.files:
        case, rest = k.split("/", 1)
        results.setdefault(case, {})[rest] = out[k]
    return inputs, results, refs


# ---- the parity path on sp 4 against JAX --------------------------------------------------------


@pytest.mark.parametrize("name", list(PARITY))
def test_parity_attention_blocks_match_jax(world, name):
    """``nystrom_attention(parity=True)`` on 4 blocks against JAX's on the
    whole bags: 50 tokens (front padding 14, in front of rank 0's block of
    13; the zeros count as keys) and 64 (none; the ragged bag's padding
    stays masked): out and the cls row rtol 1e-4, atol 1e-5·max|ref|, the
    gradients for q, k and v within 1e-5 of max|g|."""
    _, results, refs = world
    res, ((out, attn), grads) = results[name], refs[name]
    for key, want in (("out", out), ("attn", attn)):
        _close(res[f"out/{key}"], want, rtol=1e-4, atol=1e-5 * float(jnp.abs(want).max()), msg=key)
    for key, want in zip("qkv", grads):
        _grad_close(res[f"grad/{key}"], want, f"d {key}")


def test_parity_sattention_blocks_match_jax(world):
    """MHIM's selfattn module with both TransLayers on the parity path, the
    cls token and the 2 tokens of front padding on rank 0, PPEG's halo rows
    from the neighbours, on 4 blocks of 45 instances against JAX's module
    on one device (its TransLayers built with ``parity``): ``cls_feat`` and
    layer 1's cls row over the instances rtol 1e-4, atol 1e-5·max|ref|, the
    gradients for x and every parameter within 1e-5 of max|g|."""
    _, results, refs = world
    res, ((cls, attn), want_p, d_x) = results["sattention"], refs["sattention"]
    for key, want in (("cls_feat", cls), ("attn", attn)):
        _close(res[f"out/{key}"], want, rtol=1e-4, atol=1e-5 * float(jnp.abs(want).max()), msg=key)
    _grad_close(res["grad/x"], d_x, "d x")
    assert set(_group(res, "pgrad")) == set(want_p)
    for k, g in want_p.items():
        _grad_close(res[f"pgrad/{k}"], g, f"d {k}")


# ---- the steps at dp 2 x sp 2 against JAX's single-device step ------------------------------------


def _check_step(name, cfg, res, ref):
    s2, jmetrics = ref
    _check_zoo_step(name, cfg, res, s2, jmetrics, cfg["lr"], to_port=_to_port)


@pytest.mark.parametrize("distill", DISTILLS)
def test_dtfd_sp_step_matches_jax(world, distill):
    """DTFD's train step at dp 2 × sp 2 (each rank 4 bags' halves of the
    instances) against JAX's single-device step: the pseudo-bags from the
    whole bag's valid ranks (bag 1's 3 instances fill 3 of 5; bag
    TIE_BAG's first straddles the ranks), tier 1's softmaxes and sums over
    the row, ``MaxS``/``MaxMinS``'s picks of the lowest global index among
    the tie (``dimReduction``'s column TIE_COL gradient reads which one)
    fetched from their owners, tier 2 on every rank. Loss and aux loss
    rtol 1e-5, gradients, parameters."""
    _, results, refs = world
    name = f"dtfd_{distill}"
    _check_step(name, {**ZOO_CFG, "model": "dtfd"}, results[name], refs[name])
    assert float(results[name]["m/aux_loss"]) > 0


@pytest.mark.parametrize("name", list(RRT_STEPS))
def test_rrtmil_sp_step_matches_jax(world, name):
    """RRT-MIL's train step at dp 2 × sp 2 against JAX's single-device
    step: each instance moved to its region's rank, R-MSA with its EPEG
    convolution on whole regions, CR-MSA across the gathered summaries,
    the tokens moved back and pooled on the blocks; with 2 × 2 regions (two
    a rank, each across both instance blocks) and with one region (sp rank
    1 owns none and still joins every collective). Loss rtol 1e-5,
    gradients, parameters."""
    _, results, refs = world
    _check_step(name, RRT_CFG, results[name], refs[name])


@pytest.mark.parametrize("name", list(PURE))
def test_mhim_pure_sp_step_matches_jax(world, name):
    """The teacher stage (``mhim_pure``) at dp 2 × sp 2 against JAX's
    single-device step: the dsmil baseline (B = C = 4 full bags) and the
    selfattn baseline with PEG between its TransLayers: loss, keep_num,
    patch_num, gradients, student and teacher (``_check_against_jax``)."""
    _, results, refs = world
    _check_against_jax(results[name], refs[name], loss_rtol=1e-5)


def test_control_dtfd_local_pseudo_bags_miss_jax(world):
    """The test sees the pseudo-bags: ``MaxS``'s step with each rank
    splitting its own block's valid instances (the local ``cumsum`` and
    count) misses JAX."""
    _, results, refs = world
    with pytest.raises(AssertionError):
        _check_step("dtfd_MaxS", {**ZOO_CFG, "model": "dtfd"}, results["control_local_ids"], refs["dtfd_MaxS"])


def test_control_rrtmil_local_regions_miss_jax(world):
    """The test sees the regions: RRT-MIL's step with each rank cutting
    its regions from its own block misses JAX."""
    _, results, refs = world
    with pytest.raises(AssertionError):
        _check_step("rrtmil", RRT_CFG, results["control_local_regions"], refs["rrtmil"])


def test_rrtmil_sp_dropout_draws_equal_one_process(world):
    """RRT-MIL's dropouts on (0.25 after the embed, 0.1 on R-MSA's and
    CR-MSA's maps and outputs) at dp 1 × sp 2 with 3 × 3 regions (5 and 4
    a rank, so that a rank's rows of the flat ``B·R`` axis are not
    contiguous), each rank keeping its regions of the one-process draw,
    equals the port's one-process step within atol 2e-6: metrics,
    gradients and parameters."""
    inputs, results, _ = world
    cfg = load_config([], **{**RRT_CFG, "region_num": RRT_DROPOUT_REGIONS, "dropout": 0.25})
    w, batch = inputs["rrtmil_dropout"]["w"], inputs["rrtmil_dropout"]["batch"]
    model, family = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    state = create_train_state(cfg, model, SPE, device="cpu")
    metrics = make_train_step(cfg, family, SPE, device="cpu")(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    res = results["rrtmil_dropout"]
    for k, v in metrics.items():
        _close(res[f"m/{k}"], v, rtol=0, atol=2e-6, msg=k)
    grads = {k: state.optimizer.opt.state[p]["exp_avg"].numpy() for k, p in state.model.named_parameters()}
    top = max(np.abs(g).max() for g in grads.values())
    for k, p in state.model.named_parameters():
        g = grads[k]
        _close(res[f"g/{k}"], g, rtol=0, atol=2e-6, msg=f"gradient {k}")
        scale = np.abs(g).max() if np.abs(g).max() > GRAD_TOL * top else top
        _check_params(k, res[f"s/{k}"], p.detach().numpy(), g, cfg.lr, rtol=0, atol=2e-6, scale=scale)


# ---- the evaluation at dp 1 x sp 4 against JAX's forward -----------------------------------------


@pytest.mark.parametrize("distill", DISTILLS)
def test_dtfd_sp_eval_matches_jax(world, distill):
    """DTFD's evaluation forward at dp 1 × sp 4 (bag 0's last block and
    most of bag 1's blocks hold only padding; bag TIE_BAG's tie spans ranks
    1 and 3) against JAX's: the logits and the union of the pseudo-bags'
    attentions, gathered from the blocks."""
    _, results, refs = world
    _check_forward(results[f"eval_dtfd_{distill}"], refs[f"eval_dtfd_{distill}"])


@pytest.mark.parametrize("regions", RRT_EVALS)
def test_rrtmil_sp_eval_matches_jax(world, regions):
    """RRT-MIL's evaluation forward at dp 1 × sp 4 against JAX's: 2 × 2
    regions (one a rank), 3 × 3 (3, 2, 2 and 2 a rank) and one region
    (ranks 1-3 own none): the logits and the pool's attention, gathered."""
    _, results, refs = world
    _check_forward(results[f"eval_rrtmil_{regions}"], refs[f"eval_rrtmil_{regions}"])


def test_region_layout_holds_whole_regions():
    """The region layout: whole regions a rank, none past R; the
    region-major places a permutation of the grid that ``row_major_index``
    inverts."""
    assert region_layout(64, 2, 4, 3).seq.counts == (1, 1, 1, 1)
    assert region_layout(64, 3, 4, 0).seq.counts == (3, 2, 2, 2)
    one = region_layout(64, 1, 4, 2)
    assert one.seq.counts == (1, 0, 0, 0) and one.tokens.counts == (64, 0, 0, 0) and one.tokens.local == 0
    for n, r in ((64, 2), (64, 3), (1001, 8)):
        h = region_layout(n, r, 2, 0).size ** 0.5 * r
        i = torch.arange(int(h) ** 2)
        q = region_index(i, n, r)
        assert torch.equal(q.sort().values, i) and torch.equal(row_major_index(q, n, r), i)
