"""The port's k-fold driver against the JAX package's, on the CPU.

The host modules the port copies (the synthetic fixtures, the stratified
folds, the batcher, the metrics, early stopping, the host loss and the
survival risk) must match the JAX package's exactly on the same inputs. A
``script_mode="no_train"`` run of the port on JAX's initial weights must
give JAX's test rows (rtol 1e-4). Then the port's own behaviour: tiny runs
of each ported family, the best-epoch snapshot, validation of the current
weights under bf16, the ``script_mode="test"`` reload, ``auto_resume``
after a crash, ``--teacher_init`` and a run without pandas or h5py.

Tiny config: input_dim 16, inner_dim 32, 2 heads, 12 synthetic bags of up
to 64 instances in one bucket, batch 4, fp32 unless a test says otherwise.
"""

import copy
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_torch.config import load_config
from mhim_mil_torch.data import bucketing, splits, synthetic
from mhim_mil_torch.engine import driver, losses, metrics
from mhim_mil_torch.engine.steps import make_mhim_eval_step, make_train_step
from mhim_mil_torch.engine.train_state import create_mhim_state, create_train_state
from mhim_mil_torch.models import build_model
from mhim_mil_torch.utils.checkpoint import save_checkpoint
from mhim_mil_torch.utils.early_stopping import EarlyStopping
from mhim_mil_torch.utils import weights
from mhim_mil_torch.utils.weights import mamba2d_state_from_flax, state_dict_from_flax
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.data import bucketing as j_bucketing, splits as j_splits, synthetic as j_synthetic
from mhim_mil_tpu.engine import driver as j_driver, losses as j_losses, metrics as j_metrics
from mhim_mil_tpu.engine.steps import make_train_step as j_make_train_step
from mhim_mil_tpu.engine.train_state import MILTrainState, make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.utils.schedules import make_lr_schedule as j_make_lr_schedule
from mhim_mil_tpu.utils.early_stopping import EarlyStopping as JEarlyStopping
from test_torch_mamba import _flax_from_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C16, SURV = "config/mhim_c16.yaml", "config/feat_surv.yaml"
TINY = dict(datasets="synth", input_dim=16, inner_dim=32, n_heads=2, synth_n_slides=12, synth_bag_size=64,
            bucket_sizes=(64,), batch_size=4, cv_fold=1, num_epoch=2, max_epoch=2, lr=1e-3, lr_sche="const",
            num_bootstrap=5, output_path="", compute_dtype="float32")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch, for every case of the file: beside the
    other test workers its thread pool spins against theirs, and a tiny run
    takes 10–100× longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(preset=C16, **kw):
    return load_config(["-c", preset], **{**TINY, **kw})


def _assert_rows(got, want, rtol=0.0):
    """Metric rows (floats and nested dicts of floats) equal, key for key."""
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_rows(got[k], want[k], rtol)
        elif rtol:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
        else:
            np.testing.assert_equal(got[k], want[k], err_msg=k)


# ---- the copied host modules ------------------------------------------------


@pytest.mark.parametrize("kind", ["classification", "survival"])
def test_synthetic_datasets_match_jax(kind):
    if kind == "classification":
        got = synthetic.make_synthetic_dataset(n_slides=9, bag_size=40, feat_dim=8, n_classes=3, seed=3)
        want = j_synthetic.make_synthetic_dataset(n_slides=9, bag_size=40, feat_dim=8, n_classes=3, seed=3)
    else:
        got = synthetic.make_synthetic_survival_dataset(n_slides=9, bag_size=40, feat_dim=8, seed=3)
        want = j_synthetic.make_synthetic_survival_dataset(n_slides=9, bag_size=40, feat_dim=8, seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("k", [2, 3, 5])
def test_stratified_kfold_matches_jax(k):
    labels = np.random.default_rng(k).integers(0, 3, 31)
    got, want = splits.stratified_kfold_indices(labels, k), j_splits.stratified_kfold_indices(labels, k)
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_bags_order_padding_and_count_match_jax():
    """Ragged bags over three buckets with coordinates and survival labels:
    the same batches in the same order (shuffled or not, with and without
    drop_last), and the same count."""
    rng = np.random.default_rng(0)
    slides = [{"feats": rng.normal(size=(n, 4)).astype(np.float32), "target": i % 2, "censorship": int(i % 3 == 0),
               "event": float(i) / 3, "pos": rng.integers(0, 9, (n, 2))}
              for i, n in enumerate(rng.integers(5, 70, 23))]
    for shuffle, drop_last in ((False, False), (True, False), (True, True)):
        kw = dict(buckets=(16, 32, 64), shuffle=shuffle, drop_last=drop_last, seed=7,
                  extra_keys=("target", "censorship", "event"))
        got = list(bucketing.batch_bags(slides, 4, **kw))
        want = list(j_bucketing.batch_bags(slides, 4, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in w:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])
        n = bucketing.count_batches(slides, 4, (16, 32, 64), drop_last)
        assert n == j_bucketing.count_batches(slides, 4, (16, 32, 64), drop_last) == len(got)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_classification_metrics_with_bootstrap_match_jax(n_classes):
    rng = np.random.default_rng(n_classes)
    logits = rng.normal(size=(40, n_classes)).astype(np.float32)
    labels = rng.integers(0, n_classes, 40)
    kw = dict(bootstrap_enabled=True, num_bootstrap=25, fold=1, bin_metric=n_classes == 2)
    _assert_rows(metrics.evaluate_classification(logits, labels, n_classes, **kw),
                 j_metrics.evaluate_classification(logits, labels, n_classes, **kw))


def test_survival_metrics_with_bootstrap_match_jax():
    rng = np.random.default_rng(4)
    risk, times = rng.normal(size=30), np.round(rng.exponential(size=30), 1)
    cens = rng.integers(0, 2, 30)
    kw = dict(bootstrap_enabled=True, num_bootstrap=25, fold=2)
    _assert_rows(metrics.evaluate_survival(risk, times, cens, **kw),
                 j_metrics.evaluate_survival(risk, times, cens, **kw))


def test_early_stopping_matches_jax():
    seq = [0.5, 0.6, 0.7, 0.7, 0.65, 0.64, 0.63, 0.71, 0.6, 0.59, 0.58]
    for patience, stop_epoch in ((3, 0), (2, 5), (100, 0)):
        got, want = EarlyStopping(patience, stop_epoch), JEarlyStopping(patience, stop_epoch)
        for epoch, m in enumerate(seq):
            assert got(epoch, -m) == want(epoch, -m)
            assert got.state_dict() == want.state_dict()
        restored = EarlyStopping()
        restored.load_state_dict(want.state_dict())
        assert restored.state_dict() == want.state_dict()


@pytest.mark.parametrize("loss", ["ce", "bce", "nll_surv"])
def test_host_loss_and_surv_risk_match_jax(loss):
    rng = np.random.default_rng(5)
    n_classes = 4 if loss == "nll_surv" else 2
    logits = rng.normal(size=(10, n_classes)).astype(np.float32)
    targets = rng.integers(0, n_classes, 10).astype(np.int32)
    cens = [rng.integers(0, 2, 5).astype(np.int32) for _ in range(2)]
    events = [rng.random(5).astype(np.float32) for _ in range(2)]
    keep = rng.random(10) > 0.3
    kw = dict(model="abmil", loss=loss, n_classes=n_classes)
    got = driver._host_loss(load_config([], **kw), logits[keep], targets[keep], cens, events, keep)
    want = j_driver._host_loss(j_load_config([], **kw), logits[keep], targets[keep], cens, events, keep)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(losses.surv_risk(torch.from_numpy(logits)).numpy(),
                               np.asarray(j_losses.surv_risk(jnp.asarray(logits))), rtol=1e-6)


# ---- the generic train step against JAX's --------------------------------------------


def test_generic_train_step_matches_jax_on_2dmamba():
    """Two fp32 steps of the generic train step on 2dmamba survival (grid
    coordinates, a ragged and a fake bag, dropout 0, the model EMA on) from
    the same initial weights: the losses at rtol 1e-4, the student and the
    EMA teacher after them at rtol 1e-4, atol 1e-5. SGD, since Adam's first
    steps move a parameter by about lr·sign(g), and the attention logit's
    bias has a gradient of zero up to rounding; a 4 × 4 grid keeps JAX's
    compile of the row-by-row plain scan short."""
    kw = dict(model="2dmamba", datasets="surv_synth", input_dim=16, mambamil_dim=16, mambamil_state_dim=4,
              mamba_2d_max_hw=4, dropout=0.0, compute_dtype="float32", model_ema=True, model_ema_decay=0.9,
              opt="sgd", lr=1e-1, lr_sche="const", batch_size=3, num_epoch=1)
    jcfg, cfg = j_load_config(["-c", SURV], **kw), load_config(["-c", SURV], **kw)
    rng = np.random.default_rng(6)
    n = 12
    batch = {"feats": rng.normal(size=(3, n, 16)).astype(np.float32),
             "mask": np.arange(n)[None] < np.array([[n], [7], [0]]),
             "pos": np.stack([rng.permutation(16)[:n] for _ in range(3)])[..., None] // np.array([1, 4]) % 4,
             "target": np.array([1, 3, 0], np.int32), "censorship": np.array([0, 1, 0], np.int32),
             "event": np.array([1.0, 2.0, 0.0], np.float32), "bag_valid": np.array([True, True, False])}
    model, fam = build_model(cfg, device="cpu")
    state = create_train_state(cfg, model, 2, device="cpu")
    jm, family = j_build_model(jcfg)
    # copies: a numpy view of the port's parameters would see the port's in-place updates
    params = jax.tree.map(jnp.asarray, _flax_from_port({k: v.clone() for k, v in model.state_dict().items()}))
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 2))
    jstate = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state={},
                           teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(3), tx=tx, apply_fn=jm.apply)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep, step = j_make_train_step(jcfg, jm, family, 2), make_train_step(cfg, fam, 2, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        jstate, jmetrics = jstep(jstate, jbatch)
        metrics_ = step(state, tbatch)
        np.testing.assert_allclose(metrics_["loss"].item(), float(jmetrics["loss"]), rtol=1e-4)
    for module, params in ((state.model, jstate.params), (state.teacher, jstate.teacher_params)):
        want = mamba2d_state_from_flax(jax.tree.map(np.asarray, params))
        got = module.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


# ---- the driver against JAX's ---------------------------------------------------


def test_no_train_run_on_jax_weights_matches_jax(monkeypatch):
    """Two folds of ``script_mode="no_train"``: JAX's run, recording the
    initial state its ``_build_fold`` makes per fold; then the port's run with
    those weights (through ``state_dict_from_flax``) in the student and the
    teacher. The per-epoch validation rows and the ``test`` / ``test_ema``
    rows (bootstrap included) match at rtol 1e-4, key for key. MHIM-attn
    without Merge keeps JAX's compiles short (the selfattn and Merge
    numerics are held against JAX in test_torch_serving and
    test_torch_train)."""
    kw = dict(TINY, cv_fold=2, script_mode="no_train", baseline="attn", merge_enable=False)
    built = {}
    j_build = j_driver._build_fold

    def recording(cfg, train_slides, fold_seed, fold=0):
        out = j_build(cfg, train_slides, fold_seed, fold)
        built[fold] = out[2]
        return out

    monkeypatch.setattr(j_driver, "_build_fold", recording)
    want = j_driver.run_experiment(j_load_config(["-c", C16], **kw))
    build = driver._build_fold

    def jax_weights(cfg, train_slides, fold_seed, fold=0, device=None):
        model, family, state, step = build(cfg, train_slides, fold_seed, fold, device)
        js = built[fold]
        buffers = jax.tree.map(np.asarray, js.model_state.get("buffers"))
        state.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.params), buffers))
        state.teacher.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, js.teacher_params), buffers))
        return model, family, state, step

    monkeypatch.setattr(driver, "_build_fold", jax_weights)
    got = driver.run_experiment(_cfg(**kw), device="cpu")
    assert len(got["folds"]) == len(want["folds"]) == 2
    for g, w in zip(got["folds"], want["folds"]):
        assert (g["best_epoch"], g["best_epoch_ema"]) == (w["best_epoch"], w["best_epoch_ema"])
        for row in ("test", "test_ema"):
            _assert_rows(g[row], w[row], rtol=1e-4)
        for hg, hw in zip(g["history"], w["history"]):
            _assert_rows(hg["val"], hw["val"], rtol=1e-4)
    assert got["summary"].keys() == want["summary"].keys()


ZOO_TO_PORT = {"abmil": weights.abmil_state_from_flax, "gabmil": weights.abmil_state_from_flax,
               "meanmil": weights.mean_max_state_from_flax, "maxmil": weights.mean_max_state_from_flax,
               "transmil": weights.transmil_state_from_flax, "dsmil": weights.dsmil_state_from_flax,
               "clam_sb": weights.clam_state_from_flax, "clam_mb": weights.clam_state_from_flax,
               "dtfd": weights.dtfd_state_from_flax, "ibmil": weights.ibmil_state_from_flax,
               "rrtmil": weights.rrtmil_state_from_flax, "mambamil": weights.mambamil_state_from_flax}


@pytest.mark.parametrize("model", sorted(ZOO_TO_PORT))
def test_zoo_no_train_run_on_jax_weights_matches_jax(monkeypatch, model, one_torch_thread):
    """Two folds of each zoo model under ``script_mode="no_train"`` with the
    model EMA on: JAX's run, recording the initial state of each fold; then
    the port's with those weights in the student and the EMA teacher
    (through the model's ``*_state_from_flax``). The ``test`` and
    ``test_ema`` rows (bootstrap included) and each epoch's validation row
    match at rtol 1e-4. For dsmil the rows score the host fusion
    ``0.5·logits + 0.5·sub_logits``, once, as JAX's do."""
    kw = dict(TINY, model=model, cv_fold=2, num_epoch=1, max_epoch=1, script_mode="no_train", model_ema=True)
    built = {}
    j_build = j_driver._build_fold

    def recording(cfg, train_slides, fold_seed, fold=0):
        out = j_build(cfg, train_slides, fold_seed, fold)
        built[fold] = out[2]
        return out

    monkeypatch.setattr(j_driver, "_build_fold", recording)
    want = j_driver.run_experiment(j_load_config(["-c", C16], **kw))
    build, to_port = driver._build_fold, ZOO_TO_PORT[model]

    def jax_weights(cfg, train_slides, fold_seed, fold=0, device=None):
        out = build(cfg, train_slides, fold_seed, fold, device)
        js = built[fold]
        out[2].model.load_state_dict(to_port(jax.tree.map(np.asarray, js.params)))
        out[2].teacher.load_state_dict(to_port(jax.tree.map(np.asarray, js.teacher_params)))
        return out

    fused = []
    real_eval = driver._eval_step

    def counting(cfg, model_, family):
        step = real_eval(cfg, model_, family)

        def wrapped(batch):
            out = step(batch)
            fused.append("sub_logits" in out)
            return out
        return wrapped

    monkeypatch.setattr(driver, "_build_fold", jax_weights)
    monkeypatch.setattr(driver, "_eval_step", counting)
    got = driver.run_experiment(_cfg(**kw), device="cpu")
    assert len(got["folds"]) == len(want["folds"]) == 2
    for g, w in zip(got["folds"], want["folds"]):
        for row in ("test", "test_ema"):
            _assert_rows(g[row], w[row], rtol=1e-4)
        for hg, hw in zip(g["history"], w["history"]):
            _assert_rows(hg["val"], hw["val"], rtol=1e-4)
    assert fused and all(fused) == (model == "dsmil")


def test_dsmil_evaluation_fuses_the_two_heads_once(one_torch_thread):
    """``evaluate`` scores ``0.5·logits + 0.5·sub_logits``: the logits it
    keeps are that fusion of the eval step's two outputs, not the bag head's
    alone nor a second fusion."""
    cfg = _cfg(model="dsmil")
    model, family = build_model(cfg, device="cpu")
    slides = synthetic.make_synthetic_dataset(n_slides=6, bag_size=64, feat_dim=16, seed=1)
    staged = driver.device_eval_batches(cfg, slides, "cpu")
    outs = [driver._eval_step(cfg, model, family)(jb) for jb, _ in staged]
    want = np.concatenate([0.5 * o["logits"].numpy() + 0.5 * o["sub_logits"].numpy() for o in outs])
    keep = np.concatenate([b["bag_valid"] for _, b in staged])
    row = driver.evaluate(cfg, model, family, staged, 0, False)
    np.testing.assert_array_equal(row["_logits"], want[keep])


def test_quickstart_command_runs_on_the_cpu(one_torch_thread):
    """The README's first command through the port, on the CPU:
    ``python3 -m mhim_mil_torch.main --datasets synth --model abmil --device
    cpu --cv_fold 2``, with the epochs and the bootstrap cut so that the
    test stays short."""
    from mhim_mil_torch.main import main

    res = main(["--datasets", "synth", "--model", "abmil", "--device", "cpu", "--cv_fold", "2",
                "--num_epoch", "2", "--num_bootstrap", "10", "--output_path", ""])
    assert len(res["folds"]) == 2 and res["kernel_gate"]["outcome"] == "skipped"
    assert math.isfinite(res["summary"]["auc"]["mean"])


# ---- the port's driver -------------------------------------------------------------


@pytest.mark.parametrize("preset,kw", [
    (C16, {}),
    (C16, dict(baseline="attn")),
    (C16, dict(model="mhim_pure")),
    (SURV, dict(model="2dmamba", datasets="surv_synth", mambamil_dim=16, mambamil_state_dim=4,
                mamba_2d_max_hw=10, model_ema=True)),
    (C16, dict(model="abmil", model_ema=True, cv_fold=2)),
    (C16, dict(model="gabmil", model_ema=True, cv_fold=2)),
    (C16, dict(model="meanmil", model_ema=True, cv_fold=2)),
    (C16, dict(model="maxmil", model_ema=True, cv_fold=2)),
    (C16, dict(model="transmil", pos="sincos", model_ema=True, cv_fold=2)),
    (C16, dict(model="dsmil", model_ema=True, cv_fold=2)),
    (C16, dict(baseline="dsmil", cv_fold=2)),
    (C16, dict(model="clam_sb", model_ema=True, cv_fold=2)),
    (C16, dict(model="clam_mb", model_ema=True, cv_fold=2)),
    (C16, dict(model="dtfd", model_ema=True, cv_fold=2)),
    (C16, dict(model="ibmil", model_ema=True, cv_fold=2)),
    (C16, dict(model="rrtmil", region_num=2, rrt_n_heads=2, model_ema=True, cv_fold=2)),
], ids=["selfattn", "attn", "mhim_pure", "2dmamba-survival", "abmil", "gabmil", "meanmil", "maxmil",
        "transmil-sincos", "dsmil", "mhim-dsmil", "clam_sb", "clam_mb", "dtfd", "ibmil", "rrtmil"])
def test_tiny_runs_are_finite(preset, kw, one_torch_thread):
    """Each ported family trains, validates and tests under the bf16 policy
    (the zoo on two folds); the MHIM teacher and the generic EMA give their
    own test rows, finite in every fold."""
    res = driver.run_experiment(_cfg(preset, **{**kw, "compute_dtype": "bfloat16"}), device="cpu")
    key = "cindex" if kw.get("model") == "2dmamba" else "auc"
    assert res["kernel_gate"]["outcome"] == "skipped"
    assert len(res["folds"]) == kw.get("cv_fold", 1)
    for summary in ("summary", "summary_ema"):
        assert math.isfinite(res[summary][key]["mean"])
    for fold in res["folds"]:
        assert all(math.isfinite(fold[row][key]) for row in ("test", "test_ema"))
        assert all(math.isfinite(h["train_loss"]) for h in fold["history"])
    assert res["folds"][0]["timing"]["train_steps"] == 2 * 2


@pytest.mark.parametrize("model", ["clam_sb", "ibmil-bank"])
def test_zoo_ii_fold_and_its_reload(tmp_path, model, one_torch_thread):
    """One fold of one epoch through the command line (clam_sb, and ibmil
    with a confounder bank, which the checkpoint carries as a buffer):
    finite test rows and a nonzero instance loss for clam; then the
    ``--script_mode test`` reload of its best reproduces the test row."""
    from mhim_mil_torch.main import main

    args = ["-c", C16, "--datasets", "synth", "--input_dim", "16", "--inner_dim", "32", "--synth_n_slides", "12",
            "--synth_bag_size", "64", "--bucket_sizes", "64", "--batch_size", "4", "--cv_fold", "1",
            "--num_epoch", "1", "--max_epoch", "1", "--num_bootstrap", "5", "--device", "cpu",
            "--compute_dtype", "float32", "--model", model.split("-")[0]]
    if model == "ibmil-bank":
        np.save(tmp_path / "bank.npy", np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32))
        args += ["--confounder_path", str(tmp_path / "bank.npy")]
    out = str(tmp_path / "run")
    first = main(args + ["--output_path", out])
    fold = first["folds"][0]
    assert all(math.isfinite(fold["test"][k]) for k in ("auc", "acc"))
    if model == "clam_sb":
        assert fold["history"][0]["aux_loss"] > 0
    again = main(args + ["--script_mode", "test", "--model_path", out, "--output_path", ""])
    _assert_rows(again["folds"][0]["test"], fold["test"])


def _student_calls(monkeypatch):
    """Wrap ``driver.evaluate`` to record, per call: whether it bootstraps
    (the final test), whether the model is the student, a copy of its
    weights, the staged split and the logits."""
    calls, real = [], driver.evaluate

    def recording(cfg, model, family, slides, fold, bootstrap, device=None):
        row = real(cfg, model, family, slides, fold, bootstrap, device)
        student = next(model.parameters()).requires_grad
        calls.append(dict(bootstrap=bootstrap, student=student, slides=slides, row=row,
                          weights=copy.deepcopy(model.state_dict())))
        return row

    monkeypatch.setattr(driver, "evaluate", recording)
    return calls


def test_final_test_scores_the_best_epoch_not_the_last(monkeypatch):
    """The step updates the live state in place: the best epoch (0, scripted)
    must be final-tested from its snapshot, for the student and the EMA."""
    calls = _student_calls(monkeypatch)
    real = driver.evaluate

    def scripted(cfg, model, family, slides, fold, bootstrap, device=None):
        row = real(cfg, model, family, slides, fold, bootstrap, device)
        if not bootstrap:
            row["_key_metric"] = 1.0 if len(calls) <= 2 else 0.5  # epoch 0 is the best
        return row

    monkeypatch.setattr(driver, "evaluate", scripted)
    cfg = _cfg(num_epoch=3, max_epoch=3, lr=1e-2)
    res = driver.one_fold(cfg, 0, *driver.get_folds(cfg)[0], device="cpu")
    assert res["best_epoch"] == 0 and res["best_epoch_ema"] == 0
    val = [c for c in calls if not c["bootstrap"]]
    test = [c for c in calls if c["bootstrap"]]
    assert [c["student"] for c in val] == [True, False] * 3 and [c["student"] for c in test] == [True, False]
    np.testing.assert_array_equal(test[0]["row"]["_logits"], val[0]["row"]["_logits"])
    np.testing.assert_array_equal(test[1]["row"]["_logits"], val[1]["row"]["_logits"])
    assert np.abs(test[0]["row"]["_logits"] - val[-2]["row"]["_logits"]).max() > 1e-3


def test_validation_scores_the_weights_of_its_epoch_under_bf16(monkeypatch):
    """The bf16 eval step casts the weights when made: each validation must
    score the weights the student holds at that epoch. Every student call's
    logits equal a fresh eval step's on a fresh model with those weights,
    and the two epochs' logits differ."""
    calls = _student_calls(monkeypatch)
    cfg = _cfg(compute_dtype="bfloat16", lr=1e-2)
    driver.one_fold(cfg, 0, *driver.get_folds(cfg)[0], device="cpu")
    val = [c for c in calls if c["student"] and not c["bootstrap"]]
    assert len(val) == 2
    for c in val:
        fresh, _ = build_model(cfg, device="cpu")
        fresh.load_state_dict(c["weights"])
        step = make_mhim_eval_step(cfg, fresh)
        logits = torch.cat([step(jb)["logits"] for jb, _ in c["slides"]]).numpy()
        keep = np.concatenate([b["bag_valid"] for _, b in c["slides"]])
        np.testing.assert_array_equal(c["row"]["_logits"], logits[keep])
    assert np.abs(val[0]["row"]["_logits"] - val[1]["row"]["_logits"]).max() > 1e-3


def test_script_mode_test_reproduces_the_test_rows(tmp_path):
    first = driver.run_experiment(_cfg(output_path=str(tmp_path)), device="cpu")
    for name in ("fold_0_model_best.ckpt", "fold_0_ema_model_best.ckpt", "default_log.jsonl"):
        assert (tmp_path / name).exists()
    again = driver.run_experiment(_cfg(script_mode="test", model_path=str(tmp_path)), device="cpu")
    for f1, f2 in zip(first["folds"], again["folds"]):
        for row in ("test", "test_ema"):
            _assert_rows(f2[row], f1[row])


def test_auto_resume_after_a_crash_continues_the_uninterrupted_run(tmp_path, monkeypatch):
    """A run that crashes in epoch 1 leaves the rolling checkpoint of epoch
    0; the resumed run restores the weights, the optimizer, the step and the
    generator, and its epochs 1-2 equal the uninterrupted run's."""
    cfg = _cfg(num_epoch=3, max_epoch=3, auto_resume=True, output_path=str(tmp_path / "a"))
    fold = driver.get_folds(cfg)[0]
    full = driver.one_fold(cfg, 0, *fold, device="cpu")
    cfg = cfg.replace(output_path=str(tmp_path / "b"))
    build = driver._build_fold

    def crashing(*a, **kw):
        model, family, state, step = build(*a, **kw)
        n = [0]

        def step_or_crash(state, batch):
            n[0] += 1
            if n[0] == 4:  # two steps an epoch: the second step of epoch 1
                raise RuntimeError("crash in epoch 1")
            return step(state, batch)

        return model, family, state, step_or_crash

    monkeypatch.setattr(driver, "_build_fold", crashing)
    with pytest.raises(RuntimeError, match="crash in epoch 1"):
        driver.one_fold(cfg, 0, *fold, device="cpu")
    assert (tmp_path / "b" / "ckp_fold0.ckpt").exists()
    monkeypatch.undo()
    resumed = driver.one_fold(cfg, 0, *fold, device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [1, 2]
    for h_full, h_res in zip(full["history"][1:], resumed["history"]):
        _assert_rows({k: v for k, v in h_res.items() if k != "time"},
                     {k: v for k, v in h_full.items() if k != "time"})
    assert not (tmp_path / "b" / "ckp_fold0.ckpt").exists()


@pytest.mark.parametrize("kind", ["ckpt", "pt"])
def test_teacher_init_from_a_port_ckpt_and_a_reference_pt(tmp_path, kind):
    """``--teacher_init`` with the port's checkpoint (through its directory)
    and with a reference ``.pt`` (``{'model': state_dict}`` with DDP
    ``module.`` prefixes and no Merge, as a ``mhim_pure`` teacher): the
    teacher takes every weight the file has, the student per
    ``init_stu_type``; then a run with it is finite."""
    base = _cfg()
    src, _ = build_model(base, device="cpu", generator=torch.Generator().manual_seed(123))
    sd = src.state_dict()
    if kind == "ckpt":
        save_checkpoint(str(tmp_path / "fold_0_model_best.ckpt"), create_mhim_state(base, src, 1, device="cpu"))
        path, loaded = str(tmp_path), sd
    else:
        loaded = {k: v for k, v in sd.items() if not k.startswith("merge.")}
        path = str(tmp_path / "teacher.pt")
        torch.save({"model": {f"module.{k}": v for k, v in loaded.items()}, "epoch": 7}, path)
    train = driver.get_folds(base)[0][0]
    for mode in ("none", "fc", "all"):
        cfg = base.replace(teacher_init=path, init_stu_type=mode)
        _, _, state, _ = driver._build_fold(cfg, train, cfg.seed, 0, "cpu")
        teacher, student = state.teacher.state_dict(), state.model.state_dict()
        assert all(torch.equal(teacher[k], v) for k, v in loaded.items())
        assert torch.equal(student["feature.0.weight"], sd["feature.0.weight"]) == (mode != "none")
        enc = "online_encoder.layer1.attn.to_qkv.weight"
        assert torch.equal(student[enc], sd[enc]) == (mode == "all")
        if kind == "pt":  # the Merge the file lacks keeps its initial weights
            assert not torch.equal(teacher["merge.attn.to_q.weight"], sd["merge.attn.to_q.weight"])
    res = driver.run_experiment(base.replace(teacher_init=path, num_epoch=1, max_epoch=1), device="cpu")
    assert math.isfinite(res["summary"]["auc"]["mean"])


def _teacher_is(state, best_path):
    """The teacher of a fold just built holds every weight of the stage-1
    best checkpoint, bit for bit."""
    best = driver._load_teacher(best_path)[0]
    teacher = state.teacher.state_dict()
    assert best and all(torch.equal(teacher[k], v) for k, v in best.items())


def test_teacher_init_two_stage(tmp_path):
    """The two-stage workflow of JAX's ``tests/test_driver.py:137-175`` on
    the port: ``mhim_pure`` trains two folds and writes each fold's best,
    with ``test_ema`` rows from its frozen teacher; ``mhim`` then takes
    ``--teacher_init`` from a file and from the directory, where each fold's
    teacher is that fold's stage-1 best; a directory without the fold's
    checkpoint raises ``FileNotFoundError``."""
    stage1 = driver.run_experiment(_cfg(model="mhim_pure", baseline="attn", cv_fold=2, output_path=str(tmp_path)),
                                   device="cpu")
    assert stage1["config_model"] == "mhim_pure" and math.isfinite(stage1["summary_ema"]["auc"]["mean"])
    ckpt = tmp_path / "fold_0_model_best.ckpt"
    assert ckpt.exists() and not any(k.startswith("merge.") for k in torch.load(ckpt)["model"])
    stage2 = dict(model="mhim", baseline="attn", mask_ratio_h=0.1, merge_enable=True, merge_ratio=0.5,
                  aux_alpha=0.5)
    res = driver.run_experiment(_cfg(**stage2, teacher_init=str(ckpt)), device="cpu")
    assert math.isfinite(res["summary"]["auc"]["mean"])
    assert driver._resolve_teacher_init(str(tmp_path), 1).endswith("fold_1_model_best.ckpt")
    with pytest.raises(FileNotFoundError):
        driver._resolve_teacher_init(str(tmp_path), 7)
    cfg = _cfg(**stage2, cv_fold=2, teacher_init=str(tmp_path))
    for fold, (train, _, _) in enumerate(driver.get_folds(cfg)):
        state = driver._build_fold(cfg, train, cfg.seed, fold, "cpu")[2]
        _teacher_is(state, str(tmp_path / f"fold_{fold}_model_best.ckpt"))
    res = driver.run_experiment(cfg, device="cpu")
    assert math.isfinite(res["summary"]["auc"]["mean"]) and len(res["folds"]) == 2


def test_teacher_init_from_a_jax_stage1_directory(tmp_path):
    """Stage 2 of the port from the directory of a stage-1 run of JAX's
    driver (``mhim_pure``, pickled ``.ckpt``): each fold's teacher is JAX's
    best params, converted; the run is finite."""
    j_driver.run_experiment(j_load_config(["-c", C16], **{**TINY, "model": "mhim_pure", "baseline": "attn",
                                                          "output_path": str(tmp_path)}))
    path = str(tmp_path / "fold_0_model_best.ckpt")
    with open(path, "rb") as f:
        want = state_dict_from_flax(jax.tree.map(np.asarray, pickle.load(f)["params"]))
    cfg = _cfg(baseline="attn", teacher_init=str(tmp_path))
    state = driver._build_fold(cfg, driver.get_folds(cfg)[0][0], cfg.seed, 0, "cpu")[2]
    _teacher_is(state, path)
    teacher = state.teacher.state_dict()
    assert all(torch.equal(teacher[k], v) for k, v in want.items())
    res = driver.run_experiment(cfg, device="cpu")
    assert math.isfinite(res["summary"]["auc"]["mean"])


def test_driver_runs_a_synth_fold_without_pandas_or_h5py():
    """The card's machine has neither: the CLI's synth path must not need
    them, and the CSV path must say what it needs."""
    code = (
        "import math, sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['h5py'] = None\n"
        "from mhim_mil_torch.main import main\n"
        "res = main(['-c', 'config/mhim_c16.yaml', '--device', 'cpu', '--input_dim', '16', '--inner_dim', '32',"
        " '--n_heads', '2', '--synth_n_slides', '8', '--synth_bag_size', '32', '--bucket_sizes', '32',"
        " '--batch_size', '4', '--cv_fold', '1', '--num_epoch', '1', '--num_bootstrap', '3',"
        " '--output_path', ''])\n"
        "assert math.isfinite(res['summary']['auc']['mean']), res['summary']\n"
        "from mhim_mil_torch.data.splits import read_csv\n"
        "try:\n"
        "    read_csv('labels.csv')\n"
        "    raise SystemExit('read_csv ran without pandas')\n"
        "except ImportError as e:\n"
        "    assert 'labels.csv' in str(e) and 'pandas' in str(e), e\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'mhim_mil_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]


def test_profile_and_save_result_write_their_files(tmp_path):
    """``--profile`` leaves a ``torch.profiler`` trace of the first epoch
    under ``output_path/profile``; ``--save_result`` the test predictions."""
    driver.run_experiment(_cfg(num_epoch=1, max_epoch=1, profile=True, save_result=True,
                               output_path=str(tmp_path)), device="cpu")
    traces = [f for _, _, files in os.walk(tmp_path / "profile") for f in files]
    assert any(f.endswith(".pt.trace.json") for f in traces), traces
    data = np.load(tmp_path / "fold_0_test_predictions.npz")
    assert data["logits"].shape == (data["targets"].shape[0], 2) and data["targets"].shape[0] > 0
