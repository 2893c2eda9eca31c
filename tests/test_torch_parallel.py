"""The port's data parallelism over bags (``mhim_mil_torch/parallel``)
against the JAX package's mesh, on the CPU.

The port's dp world is a set of gloo processes started with
``torch.distributed.run`` (``tests/torch_dp_worker.py``, one launch of 4
ranks for every step, eval and control case); JAX's side runs in this
process on the virtual 8-device CPU mesh of ``tests/conftest.py``, with
``make_mesh(dp=4, sp=1)`` and ``shard_batch(..., shard_instances=False)``.
Both sides start from the same weights and take the same uniform draws
(fed to JAX's ``random_subset_mask``; dropout patched to the identity on
both sides, except in the case that holds the port's dropout draws).

Tolerances: the MHIM step's loss rtol 2e-5 and ``keep_num`` rtol 1e-6
(``tests/test_parallel.py``), every parameter, the teacher and
``global_q_mm`` rtol 1e-4 / atol 1e-6 (``tests/test_torch_train.py``'s
``_check_state``); the abmil step's loss rtol 1e-5; the evaluation's AUC
and accuracy atol 1e-6; the port's dp step against its own one-process
step atol 2e-6. Each subprocess runs under a 120 s timeout, so that a hung
collective fails the test.
"""

import json
import os
import re
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.models.merge as jmerge_mod
import mhim_mil_tpu.ops.masking as jmasking_mod
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.train_state import MILTrainState, make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.mhim import MHIM as JMHIM, make_mhim_train_step as j_make_mhim_step
from mhim_mil_tpu.ops import masked as jmasked
from mhim_mil_tpu.parallel import batch_pspecs as j_batch_pspecs, make_mesh as j_make_mesh
from mhim_mil_tpu.parallel import replicate_tree as j_replicate_tree, shard_batch as j_shard_batch
from mhim_mil_tpu.utils import schedules as jsched
from mhim_mil_tpu.utils.torch_import import import_merge, import_mhim_attn, import_mhim_selfattn
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import make_mhim_train_step, make_train_step
from mhim_mil_torch.engine.train_state import create_mhim_state, create_train_state
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.parallel import batch_pspecs, make_mesh, shard_batch
from mhim_mil_torch.parallel import mesh as pmesh
from mhim_mil_torch.utils import weights
from mhim_mil_torch.utils.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
WORLD = 4
TIMEOUT_S = 120
SPE = 4

# tests/test_parallel.py:97-148, the last bag a padding bag
MHIM_CFG = dict(model="mhim", input_dim=32, inner_dim=64, n_heads=4, batch_size=8, num_epoch=2, lr=1e-3,
                lr_sche="const", mask_ratio=0.5, mask_ratio_h=0.1, mask_ratio_hr=0.5, merge_enable=True,
                merge_ratio=0.25, merge_k=2, aux_alpha=0.5, attn2score=True, dropout=0.0,
                compute_dtype="float32")
# tests/test_parallel.py:18-55, in fp32: under the default bf16 policy the two frameworks round the
# gradients apart by about 1% (test_torch_train.py::test_bf16_step_loss_is_close_to_jax)
GENERIC_CFG = dict(input_dim=32, inner_dim=32, n_classes=2, batch_size=8, dropout=0.0, lr_sche="const",
                   num_epoch=1, compute_dtype="float32")
# the attention-pool and transformer models' generic steps under dp and their weight maps (the rest
# of the zoo: tests/test_torch_parallel_zoo.py)
GENERIC = {"abmil": weights.abmil_state_from_flax, "gabmil": weights.abmil_state_from_flax,
           "meanmil": weights.mean_max_state_from_flax, "maxmil": weights.mean_max_state_from_flax,
           "transmil": weights.transmil_state_from_flax}
# tests/test_parallel.py:151-184
EVAL_CFG = dict(model="abmil", input_dim=32, inner_dim=32, batch_size=4, num_epoch=1, lr=1e-3, lr_sche="const",
                bucket_sizes=[64], compute_dtype="float32", num_bootstrap=5)
EVAL_SLIDES = dict(n_slides=12, bag_size=64, feat_dim=32, seed=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, atol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=msg)


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "JAX_PLATFORMS": "cpu"}


def _torchrun(nproc: int, args, cwd=REPO) -> subprocess.CompletedProcess:
    """``python -m torch.distributed.run --standalone`` (a free port on
    localhost) of ``args`` in ``nproc`` gloo processes, each rank's lines
    prefixed with its rank; fails the test after TIMEOUT_S."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           "--tee", "3", *args]
    res = subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, f"{' '.join(cmd)} failed:\n{res.stdout[-4000:]}\n{res.stderr[-6000:]}"
    return res


# ---- inputs of the world's cases ----------------------------------------------------


def _mhim_batch():
    rng = np.random.default_rng(0)
    b, n = 8, 64
    lengths = rng.integers(40, n + 1, (b,))
    lengths[-1] = 0  # a padding bag: rank 3 holds one real bag, the others two
    return {"feats": np.where((np.arange(n)[None] < lengths[:, None])[..., None],
                              rng.normal(size=(b, n, 32)), 0.0).astype(np.float32),
            "mask": np.arange(n)[None] < lengths[:, None],
            "bag_valid": lengths > 0,
            "target": rng.integers(0, 2, size=(b,)).astype(np.int32)}


def _mhim_draws(model, batch):
    """One step's uniform draws of the global batch: each mining stage
    that runs, then the merge split."""
    rng = np.random.default_rng(1)
    b, n = batch["mask"].shape
    on = model.sched.stages(False)
    d = {f"mask{i}": rng.random((b, n), dtype=np.float32) for i, s in enumerate(on) if s}
    d["merge"] = rng.random((b, model.static_survivors(n)), dtype=np.float32)
    return d


def _port_mhim(baseline, **kw):
    cfg = load_config([], baseline=baseline, **{**MHIM_CFG, **kw})
    model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return cfg, model


def _generic_jax(model):
    """JAX's ``model``, its config, flax's initial params and the batch
    (``tests/test_parallel.py:18-55``)."""
    from mhim_mil_tpu.engine.train_state import create_train_state as j_create_train_state

    jcfg = j_load_config([], model=model, **GENERIC_CFG)
    jm, family = j_build_model(jcfg)
    batch = _generic_batch()
    sample = {k: jnp.asarray(v) for k, v in batch.items()}
    state = j_create_train_state(jcfg, jm, jax.random.PRNGKey(0), sample, jsched.make_lr_schedule(jcfg, SPE))
    return jcfg, jm, family, state, batch


def _generic_batch():
    rng = np.random.default_rng(0)
    b, n = 8, 64
    return {"feats": np.asarray(rng.normal(size=(b, n, 32)), np.float32), "mask": np.ones((b, n), bool),
            "bag_valid": np.ones((b,), bool), "target": np.asarray(rng.integers(0, 2, size=(b,)), np.int32)}


def _eval_state():
    """JAX's eval state of ``tests/test_parallel.py:151-184``."""
    from mhim_mil_tpu.data import batch_bags, make_synthetic_dataset
    from mhim_mil_tpu.engine.train_state import create_train_state as j_create_train_state

    jcfg = j_load_config([], **{**EVAL_CFG, "bucket_sizes": tuple(EVAL_CFG["bucket_sizes"])})
    slides = make_synthetic_dataset(**EVAL_SLIDES)
    jm, family = j_build_model(jcfg)
    sample = {k: jnp.asarray(v) for k, v in next(iter(batch_bags(slides, 4, (64,)))).items()}
    state = j_create_train_state(jcfg, jm, jax.random.PRNGKey(0), sample, jsched.make_lr_schedule(jcfg, 1))
    return jcfg, jm, family, state, slides


def _np_params(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One gloo world of WORLD ranks running every case; returns the cases'
    inputs and rank 0's results, by case."""
    tmp = tmp_path_factory.mktemp("dp")
    specs, arrays, inputs = [], {}, {}

    def add(spec, **groups):
        specs.append(spec)
        inputs[spec["name"]] = groups
        for g, d in groups.items():
            for k, v in d.items():
                arrays[f"{spec['name']}/{g}/{k}"] = np.asarray(v)

    batch = _mhim_batch()
    for baseline in ("selfattn", "attn"):
        cfg, model = _port_mhim(baseline)
        w = {k: v.numpy() for k, v in model.state_dict().items()}
        common = dict(kind="mhim_step", cfg={**MHIM_CFG, "baseline": baseline}, dp=WORLD, spe=SPE, dropout=False)
        draws = _mhim_draws(model, batch)
        add({"name": f"mhim_{baseline}", **common}, w=w, batch=batch, draw=draws)
        if baseline == "selfattn":
            for control in ("pinv", "wmean"):
                add({"name": f"control_{control}", **common, "control": control}, w=w, batch=batch, draw=draws)
            add({"name": "forward_test", "kind": "forward_test", "cfg": common["cfg"], "dp": WORLD}, w=w,
                batch=batch)
            cfg_d, model_d = _port_mhim(baseline, dropout=0.25)
            add({"name": "dropout", "kind": "mhim_step", "cfg": {**common["cfg"], "dropout": 0.25}, "dp": 2,
                 "spe": SPE}, w={k: v.numpy() for k, v in model_d.state_dict().items()}, batch=batch)
    cfg_p, model_p = _port_mhim("selfattn", model="mhim_pure")
    add({"name": "mhim_pure_selfattn", "kind": "mhim_step", "cfg": {**MHIM_CFG, "model": "mhim_pure",
                                                                    "baseline": "selfattn"},
         "dp": WORLD, "spe": SPE, "dropout": False}, w={k: v.numpy() for k, v in model_p.state_dict().items()},
        batch=batch)
    for name, to_port in GENERIC.items():
        _, _, _, jstate, gbatch = _generic_jax(name)
        gw = to_port(_np_params(jstate.params))
        add({"name": name, "kind": "generic_step", "cfg": {"model": name, **GENERIC_CFG}, "dp": WORLD, "spe": SPE,
             "dropout": False}, w={k: v.numpy() for k, v in gw.items()}, batch=gbatch)
    _, _, _, estate, _ = _eval_state()
    ew = weights.abmil_state_from_flax(_np_params(estate.params))
    add({"name": "eval", "kind": "eval", "cfg": EVAL_CFG, "dp": WORLD, "slides": EVAL_SLIDES},
        w={k: v.numpy() for k, v in ew.items()})
    base = ["--datasets", "synth", "--input_dim", "32", "--inner_dim", "32", "--batch_size", "4", "--num_epoch",
            "1", "--cv_fold", "2", "--synth_n_slides", "8", "--synth_bag_size", "64", "--bucket_sizes", "64"]
    for name, argv in (("raise_batch_split", ["--model", "dtfd", "--mesh_dp", "2", "--mesh_sp", "2", "--batch_size",
                                              "3"]),
                       ("raise_no_flags", ["--model", "abmil"]),
                       ("raise_empty_block", ["--model", "rrtmil", "--mesh_dp", "1", "--mesh_sp", "4",
                                              "--synth_bag_size", "2", "--bucket_sizes", "2"])):
        add({"name": name, "kind": "raises", "argv": ["--device", "cpu", *base, *argv]})
    arrays["spec"] = np.asarray(json.dumps(specs))
    np.savez(tmp / "in.npz", **arrays)
    _torchrun(WORLD, [WORKER, str(tmp / "in.npz"), str(tmp / "out.npz")])
    out = np.load(tmp / "out.npz")
    results = {}
    for k in out.files:
        case, rest = k.split("/", 1)
        results.setdefault(case, {})[rest] = out[k]
    return inputs, results


def _group(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items() if k.startswith(prefix + "/")}


# ---- the mesh helpers, in this process ----------------------------------------------


def test_make_mesh_layouts_match_jax():
    """dp=-1 fills the bag axis; dp·sp past the world raises JAX's error;
    dp·sp short of it leaves the last ranks idle, as JAX keeps
    ``devices[:dp*sp]``."""
    assert make_mesh(dp=4, sp=2, world=8).shape == dict(j_make_mesh(dp=4, sp=2).shape) == {"dp": 4, "sp": 2}
    assert make_mesh(sp=2, world=8).shape == dict(j_make_mesh(sp=2).shape)
    assert make_mesh(world=8).shape == dict(j_make_mesh().shape) == {"dp": 8, "sp": 1}
    with pytest.raises(ValueError) as jerr:
        j_make_mesh(dp=4, sp=4)
    with pytest.raises(ValueError) as err:
        make_mesh(dp=4, sp=4, world=8)
    assert str(err.value) == str(jerr.value)
    jm = j_make_mesh(dp=3, sp=2)
    used = {d.id for d in np.asarray(jm.devices).ravel()}
    meshes = [make_mesh(dp=3, sp=2, world=8, rank=r) for r in range(8)]
    assert {r for r, m in enumerate(meshes) if not m.idle} == used == set(range(6))
    assert [m.index for m in meshes] == [0, 0, 1, 1, 2, 2, None, None]
    assert pmesh.active() is None
    with meshes[0]:
        assert pmesh.active() is meshes[0]
    assert pmesh.active() is None
    with pytest.raises(ValueError):
        meshes[7].__enter__()


@pytest.mark.parametrize("shard_instances", [True, False])
def test_batch_pspecs_match_jax(shard_instances):
    want = j_batch_pspecs(shard_instances)
    got = batch_pspecs(shard_instances)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k


def test_shard_batch_rows_match_jax_shards():
    """Each rank's rows are the shard JAX places on that rank's device; on
    a dp 2 × sp 2 mesh each rank's rows and instance block are the shard
    JAX's ``shard_batch(..., shard_instances=True)`` places on the device
    at the rank's place of the mesh; and a batch that dp does not divide
    raises, naming both numbers."""
    batch = _mhim_batch()
    for dp, sp, inst in ((4, 1, False), (2, 2, True)):
        jmesh = j_make_mesh(dp=dp, sp=sp)
        with jmesh:
            sharded = j_shard_batch(jmesh, batch, shard_instances=inst)
        devices = list(np.asarray(jmesh.devices).ravel())
        for rank in range(4):
            mine = shard_batch(make_mesh(dp=dp, sp=sp, world=4, rank=rank), batch, shard_instances=inst)
            for k, v in sharded.items():
                shard = next(s for s in v.addressable_shards if s.device == devices[rank])
                np.testing.assert_array_equal(mine[k], np.asarray(shard.data), err_msg=f"{dp}x{sp} rank {rank} {k}")
    with pytest.raises(ValueError, match=r"\b6\b.*dp=4"):
        shard_batch(make_mesh(dp=4, world=4), {"feats": np.zeros((6, 3))})


def test_no_collective_without_an_active_mesh():
    """Outside ``with mesh:`` the collectives return their input: a
    one-process run does not change by one bit."""
    x = torch.randn(3, 2)
    assert pmesh.batch_sum(x) is x and pmesh.batch_max(x) is x and pmesh.gather_rows(x) is x
    assert pmesh.local_rows(x) is x
    assert pmesh.all_reduce_grads(torch.nn.Linear(2, 2)) == 0
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(pmesh.rand_rows((3, 4), g1, "cpu"), torch.rand((3, 4), generator=g2))


def test_rand_rows_are_the_global_draws_rows():
    """Under a mesh each rank draws the global shape and keeps its rows."""
    want = torch.rand((8, 5), generator=torch.Generator().manual_seed(3))
    for rank in range(4):
        with make_mesh(dp=4, world=4, rank=rank):
            got = pmesh.rand_rows((2, 5), torch.Generator().manual_seed(3), "cpu")
        assert torch.equal(got, want[2 * rank:2 * rank + 2])


# ---- fault 13: the mesh flags in one process ------------------------------------------


def test_mesh_flags_in_one_process_train_as_without_them():
    """Fault 13: with ``mesh_dp=4, mesh_sp=2`` one process trains (JAX's
    ``_maybe_mesh`` is None on one device), and its results equal the run
    without the flags bit for bit (``tests/test_parallel.py:65-94``, one
    fold)."""
    from mhim_mil_torch.engine.driver import run_experiment

    kw = dict(model="abmil", datasets="synth", input_dim=32, inner_dim=32, synth_n_slides=16, synth_bag_size=64,
              bucket_sizes=(64,), batch_size=4, cv_fold=1, num_epoch=2, max_epoch=2, lr=1e-3, lr_sche="const",
              num_bootstrap=5, output_path="")
    plain = run_experiment(load_config([], **kw), device="cpu")
    flagged = run_experiment(load_config([], mesh_dp=4, mesh_sp=2, **kw), device="cpu")
    assert len(flagged["folds"]) == 1 and np.isfinite(flagged["summary"]["auc"]["mean"])
    for f_plain, f_flag in zip(plain["folds"], flagged["folds"]):
        assert f_flag["test"] == f_plain["test"]
        assert [h["train_loss"] for h in f_flag["history"]] == [h["train_loss"] for h in f_plain["history"]]
        assert [h["val"] for h in f_flag["history"]] == [h["val"] for h in f_plain["history"]]


# ---- the MHIM step under dp against JAX's mesh step -------------------------------------


def _jax_mhim_mesh_step(monkeypatch, baseline, port_model, batch, draws, **kw):
    """JAX's MHIM train step (``kw`` overrides the config: ``model="mhim_pure"``)
    on ``make_mesh(dp=4, sp=1)`` from the port model's weights, fed
    ``draws`` in place of its uniform draws, dropout off."""
    sd = {k: v.detach().numpy() for k, v in port_model.state_dict().items()}
    params = (import_mhim_selfattn if baseline == "selfattn" else import_mhim_attn)(sd)
    model_state = {}
    if any(k.startswith("merge.") for k in sd):
        params["merge"], mb = import_merge(sd)
        model_state = {"buffers": {"merge": mb}}
    jcfg = j_load_config([], baseline=baseline, **{**MHIM_CFG, **kw})
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
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    step = j_make_mhim_step(jcfg, jmodel, SPE)
    mesh = j_make_mesh(dp=WORLD, sp=1)
    with mesh:
        s2, m = step(j_replicate_tree(mesh, state), j_shard_batch(mesh, batch, shard_instances=False))
        jax.block_until_ready(m)
    assert next(order, None) is None  # every draw was taken
    return jax.tree.map(np.asarray, s2), {k: float(v) for k, v in m.items()}


GRAD_TOL = 1e-5  # × max|g| of each tensor (test_torch_train.py::test_first_step_gradients_match_jax)


def _check_params(name, got, want, grad, lr, rtol, atol, scale=None):
    """``got`` against ``want`` at ``rtol`` / ``atol``, except at the entries
    whose reference gradient ``grad`` lies within the gradient tolerance
    (GRAD_TOL × ``scale``, by default max|grad|) of zero: the gradient
    check does not fix their sign, and Adam's first update moves such an
    entry by up to lr either way (NystromMSA's docstring), so there the two
    may differ by up to 2·lr."""
    got, want, grad = (np.asarray(x, np.float32) for x in (got, want, grad))
    noisy = np.abs(grad) <= GRAD_TOL * (np.abs(grad).max() if scale is None else scale)
    d = np.abs(got - want)
    bad = np.where(noisy, d > 2 * lr, d > atol + rtol * np.abs(want))
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {bad.size} entries miss (rtol {rtol}, atol {atol}; "
                           f"{int(noisy.sum())} near-zero-gradient entries at 2·lr), max|d| {d[bad].max():.3e}")


def _check_against_jax(res, ref, lr=MHIM_CFG["lr"], loss_rtol=2e-5):
    """The dp step (``res``, the worker's) against JAX's mesh step: the loss
    (``loss_rtol``), keep_num and patch_num (rtol 1e-6); the gradients, read
    as Adam's first moments, within GRAD_TOL of each tensor's max|·|; every
    student parameter (:func:`_check_params`), buffer (global_q_mm among
    them) and teacher parameter at rtol 1e-4 / atol 1e-6."""
    jstate = ref["jstate"]
    metrics, student, teacher, moments = (_group(res, g) for g in ("m", "s", "t", "g"))
    _close(metrics["loss"], ref["jmetrics"]["loss"], rtol=loss_rtol, atol=0, msg="loss")
    for k in ("keep_num", "patch_num"):
        _close(metrics[k], ref["jmetrics"][k], rtol=1e-6, atol=0, msg=k)
    assert set(moments) == set(ref["jmu"])
    for k, want in ref["jmu"].items():
        _close(moments[k], want, rtol=0, atol=GRAD_TOL * np.abs(want).max(), msg=f"gradient {k}")
    buffers = jstate.model_state.get("buffers")
    want = state_dict_from_flax(jstate.params, buffers)
    want_t = state_dict_from_flax(jstate.teacher_params, buffers)
    assert set(student) == set(want) and ("merge.global_q_mm" in want) == ("mhim_pure" not in ref["name"])
    for k, v in want.items():
        if k in ref["jmu"]:
            _check_params(f"student {k}", student[k], v, ref["jmu"][k], lr, rtol=1e-4, atol=1e-6)
        else:
            _close(student[k], v, rtol=1e-4, atol=1e-6, msg=f"student {k}")
    for k, v in teacher.items():
        if k != "merge.global_q_mm":  # the teacher's copy of the buffer is never read
            _close(v, want_t[k], rtol=1e-4, atol=1e-6, msg=f"teacher {k}")


def _port_one_process(baseline, w, batch, draws=None, dropout_on=False, **kw):
    """The port's MHIM step in this process, without a mesh (``kw`` the
    config's overrides)."""
    cfg, model = _port_mhim(baseline, **kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    state = create_mhim_state(cfg, model, SPE, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if draws is not None:
        draws = {"mask": [torch.from_numpy(draws[f"mask{i}"]) if f"mask{i}" in draws else None for i in range(3)],
                 "merge": torch.from_numpy(draws["merge"])}
    with pytest.MonkeyPatch.context() as mp:
        if not dropout_on:
            mp.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)
        metrics = make_mhim_train_step(cfg, SPE, device="cpu")(state, tb, draws=draws)
    return metrics, state


def _jax_mu(jstate):
    """JAX's Adam first moments after one step, by the port's names."""
    moments = [s for s in jax.tree.leaves(jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    return {k: np.asarray(v) for k, v in state_dict_from_flax(moments[0].mu, None).items()}


@pytest.fixture(scope="module")
def mhim_refs():
    """Per baseline, JAX's mesh step and the port's one-process step on the
    world's inputs, shared by the dp test and its controls."""
    cache = {}

    def get(name, inputs):
        if name not in cache:
            kind, baseline = name.rsplit("_", 1)
            kw = {"model": kind}
            _, model = _port_mhim(baseline, **kw)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["w"].items()})
            draws = inputs.get("draw")
            with pytest.MonkeyPatch.context() as mp:
                jstate, jmetrics = _jax_mhim_mesh_step(mp, baseline, model, inputs["batch"], draws, **kw)
            one_metrics, one = _port_one_process(baseline, inputs["w"], inputs["batch"], draws, **kw)
            cache[name] = {"name": name, "jstate": jstate, "jmetrics": jmetrics, "jmu": _jax_mu(jstate),
                           "one": one, "one_metrics": one_metrics}
        return cache[name]

    return get


def _check_against_one_process(res, metrics, state, lr=MHIM_CFG["lr"], atol=2e-6):
    """The dp step against the port's one-process step: the metrics, the
    gradients (Adam's first moments) and the buffers and teacher within
    ``atol``; the student's parameters by :func:`_check_params` at
    ``atol``."""
    for k, v in metrics.items():
        if k != "mm":
            _close(res[f"m/{k}"], v, rtol=0, atol=atol, msg=k)
    grads = {k: state.optimizer.opt.state[p]["exp_avg"].numpy() for k, p in state.model.named_parameters()}
    for k, g in grads.items():
        _close(res[f"g/{k}"], g, rtol=0, atol=atol, msg=f"gradient {k}")
    for k, v in state.model.state_dict().items():
        if k in grads:
            _check_params(f"student {k}", res[f"s/{k}"], v, grads[k], lr, rtol=0, atol=atol)
        else:
            _close(res[f"s/{k}"], v, rtol=0, atol=atol, msg=f"student {k}")
    for k, v in state.teacher.state_dict().items():
        _close(res[f"t/{k}"], v, rtol=0, atol=atol, msg=f"teacher {k}")


@pytest.mark.parametrize("case", ["mhim_selfattn", "mhim_attn", "mhim_pure_selfattn"])
def test_mhim_dp_step_matches_jax_mesh_step(world, mhim_refs, case):
    """A world of 4 gloo ranks, 2 bags each (the last bag a padding bag),
    equals JAX's ``make_mesh(dp=4, sp=1)`` step (:func:`_check_against_jax`)
    and the port's own one-process step within atol 2e-6: the flagship
    step with each baseline, and the teacher stage's (``mhim_pure``)."""
    inputs, results = world
    res = results[case]
    ref = mhim_refs(case, inputs[case])
    _check_against_jax(res, ref)
    _check_against_one_process(res, ref["one_metrics"], ref["one"])


@pytest.mark.parametrize("control", ["pinv", "wmean"])
def test_controls_per_rank_couplings_miss_jax(world, mhim_refs, control):
    """The test sees each coupling: the same dp step with the
    pseudo-inverse's initial scale taken per rank (``pinv``), or with the
    losses' weight sum taken per rank (``wmean``), misses JAX's tolerance."""
    inputs, results = world
    ref = mhim_refs("mhim_selfattn", inputs["mhim_selfattn"])
    with pytest.raises(AssertionError):
        _check_against_jax(results[f"control_{control}"], ref)


def test_mhim_dp_forward_test_matches_jax(world):
    """MHIM selfattn's ``forward_test`` over the 4 ranks' bags, the logits
    gathered, against JAX's on the whole batch (rtol 1e-4, atol 1e-5, the
    eval tolerance of tests/test_torch_models.py)."""
    inputs, results = world
    _, model = _port_mhim("selfattn")
    sd = {k: v for k, v in inputs["forward_test"]["w"].items()}
    params = import_mhim_selfattn(sd)
    params["merge"], mb = import_merge(sd)
    jcfg = j_load_config([], baseline="selfattn", **MHIM_CFG)
    jmodel, _ = j_build_model(jcfg)
    batch = inputs["forward_test"]["batch"]
    want = jax.jit(lambda p, f, m: jmodel.apply({"params": p, "buffers": {"merge": mb}}, f, m,
                                                method=JMHIM.forward_test))(params, batch["feats"], batch["mask"])
    _close(results["forward_test"]["logits"], want["logits"], rtol=1e-4, atol=1e-5)


def test_dp_dropout_draws_equal_one_process(world):
    """Dropout 0.25 on (and the mining and merge draws from the step's
    generator): a dp world of 2, each rank drawing the global shape and
    keeping its rows, equals the one-process step within atol 2e-6."""
    inputs, results = world
    res = results["dropout"]
    w, batch = inputs["dropout"]["w"], inputs["dropout"]["batch"]
    metrics, state = _port_one_process("selfattn", w, batch, dropout_on=True, dropout=0.25)
    off, _ = _port_one_process("selfattn", w, batch, dropout=0.25)
    assert abs(float(metrics["loss"]) - float(off["loss"])) > 1e-4  # the dropout draws matter
    _check_against_one_process(res, metrics, state)


# ---- the generic step and the evaluation under dp against JAX -------------------------------


@pytest.mark.parametrize("model", sorted(GENERIC))
def test_generic_dp_step_matches_jax_mesh_step(world, monkeypatch, model):
    """``tests/test_parallel.py:18-55``: the generic step of each model
    that runs under dp, on 4 ranks, against JAX's on ``make_mesh(dp=4,
    sp=1)``: loss rtol 1e-5, the gradients within GRAD_TOL of max|g|, the
    parameters after the update by :func:`_check_params` at rtol 1e-4 /
    atol 1e-6. A tensor whose whole gradient lies within GRAD_TOL of the
    model's max|g| of zero (abmil's attention-logit bias: a softmax is blind
    to a shift, so its gradient is 0 in exact arithmetic) is held at that
    scale. Dropout is the identity on both sides (TransMIL's fixed 0.1)."""
    from mhim_mil_tpu.engine.steps import make_train_step as j_make_train_step

    _, results = world
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    jcfg, jm, family, state, batch = _generic_jax(model)
    step = j_make_train_step(jcfg, jm, family, SPE, donate=False)
    mesh = j_make_mesh(dp=WORLD, sp=1)
    with mesh:
        s2, m = step(j_replicate_tree(mesh, state), j_shard_batch(mesh, batch, shard_instances=False))
    res = results[model]
    _close(res["m/loss"], float(m["loss"]), rtol=1e-5, atol=0, msg="loss")
    to_port = GENERIC[model]
    moments = [x for x in jax.tree.leaves(s2.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu")]
    mu = {k: v.numpy() for k, v in to_port(_np_params(moments[0].mu)).items()}
    want = to_port(_np_params(s2.params))
    assert set(want) == set(mu) == set(_group(res, "g"))
    top = max(np.abs(g).max() for g in mu.values())
    for k, v in want.items():
        scale = np.abs(mu[k]).max() if np.abs(mu[k]).max() > GRAD_TOL * top else top
        _close(res[f"g/{k}"], mu[k], rtol=0, atol=GRAD_TOL * scale, msg=f"gradient {k}")
        _check_params(k, res[f"s/{k}"], v, mu[k], jcfg.lr, rtol=1e-4, atol=1e-6, scale=scale)


def test_abmil_dp_eval_matches_jax_mesh_eval(world):
    """``tests/test_parallel.py:151-184``: ``evaluate`` over the staged
    rows of 4 ranks, the logits gathered, against JAX's mesh evaluation:
    AUC and accuracy within 1e-6."""
    from mhim_mil_tpu.engine.driver import device_eval_batches as j_device_eval_batches
    from mhim_mil_tpu.engine.driver import evaluate as j_evaluate
    from mhim_mil_tpu.engine.steps import make_eval_step as j_make_eval_step

    _, results = world
    jcfg, jm, family, state, slides = _eval_state()
    ev = j_make_eval_step(jcfg, jm, family)
    mesh = j_make_mesh(dp=WORLD, sp=1)
    with mesh:
        staged = j_device_eval_batches(jcfg, slides, mesh, shard_instances=False)
        row = j_evaluate(jcfg, ev, j_replicate_tree(mesh, state), staged, 0, False)
    res = results["eval"]
    np.testing.assert_allclose(res["auc"], row["auc"], atol=1e-6)
    np.testing.assert_allclose(res["acc"], row["acc"], atol=1e-6)


def test_dp_world_raises_before_any_step(world):
    """In a world of 4 the driver raises ValueError, naming the cause, on
    what no mesh can run: no mesh flag; a batch of 3 bags over
    ``--mesh_dp 2`` (dtfd, before any step); and sp ranks that would hold
    no instance (rrtmil's bags of 2 over ``--mesh_sp 4``: every rank raises
    at the model's first layout, so that none waits on a collective)."""
    _, results = world
    for case, words in (("raise_no_flags", "--mesh_dp"), ("raise_batch_split", "does not split over --mesh_dp 2"),
                        ("raise_empty_block", "every sp rank must hold at least one instance")):
        assert str(results[case]["type"]) == "ValueError", case
        assert words in str(results[case]["message"]), case


# ---- the driver through its command line ----------------------------------------------


DRIVER_BASE = ["--datasets", "synth", "--input_dim", "32", "--inner_dim", "32", "--synth_n_slides", "16",
               "--synth_bag_size", "64", "--bucket_sizes", "64", "--batch_size", "4", "--cv_fold", "2",
               "--num_epoch", "2", "--max_epoch", "2", "--lr", "1e-3", "--lr_sche", "const", "--num_bootstrap", "5"]
DRIVER_CASES = {
    "abmil": ["--model", "abmil"],
    "mhim_attn": ["--model", "mhim", "--baseline", "attn", "--mask_ratio", "0.5", "--mask_ratio_h", "0.1",
                  "--merge_enable", "true", "--merge_ratio", "0.5", "--aux_alpha", "0.5", "--attn2score", "true"],
}


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_driver_dp_with_an_idle_rank_matches_one_process(tmp_path, case):
    """``tests/test_parallel.py:65-94, 187-202`` through the command line:
    ``torch.distributed.run --nproc_per_node 3`` with ``--mesh_dp 2`` (rank 2
    idles), 2 folds × 2 epochs. A finite summary; the test rows' AUC and
    accuracy within 1e-6 of the one-process run; rank 0 alone printed and
    wrote results.json, the checkpoints and the log."""
    from mhim_mil_torch.main import main

    argv = [*DRIVER_BASE, *DRIVER_CASES[case], "--title", "dp"]
    out_dp, out_one = tmp_path / "dp", tmp_path / "one"
    res = _torchrun(3, ["-m", "mhim_mil_torch.main", "--device", "cpu", *argv, "--mesh_dp", "2",
                        "--output_path", str(out_dp)])
    one = main(["--device", "cpu", *argv, "--output_path", str(out_one)])
    with open(out_dp / "dp_results.json") as f:
        dp = json.load(f)
    assert np.isfinite(dp["summary"]["auc"]["mean"])
    assert len(dp["folds"]) == len(one["folds"]) == 2
    for f_dp, f_one in zip(dp["folds"], one["folds"]):
        for row in ("test", "test_ema"):
            if row in f_one:
                for key in ("auc", "acc"):
                    np.testing.assert_allclose(f_dp[row][key], f_one[row][key], atol=1e-6, err_msg=f"{row} {key}")
    assert sorted(os.listdir(out_dp)) == sorted(os.listdir(out_one))
    with open(out_dp / "dp_log.jsonl") as f_dp, open(out_one / "dp_log.jsonl") as f_one:
        assert len(f_dp.readlines()) == len(f_one.readlines())  # one logger wrote
    lines = res.stdout.splitlines()
    for rank in (1, 2):
        said = [line for line in lines if re.match(rf"\[\w*{rank}\]:", line)]
        assert not [line for line in said if "fold" in line or "results written" in line], said
    assert any(re.match(r"\[\w*0\]:.*results written", line) for line in lines)
