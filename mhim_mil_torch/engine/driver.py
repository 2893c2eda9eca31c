"""Experiment driver: k-fold CV, epoch loop, early stop, best checkpoints
(port of ``mhim_mil_tpu/engine/driver.py``).

Reference: main.py:20-187 (``main``) and :189-428 (``one_fold``). Around the
train steps of ``engine/steps.py`` it runs the fold splits, the epoch loop,
validation of the student and of the EMA teacher, early stopping on the
negative task metric (reference engines/metrics.py:196-204), independent
student/EMA best-checkpoint selection (reference main.py:348-369), the
final test of both bests with bootstrap CIs, and the cross-fold mean ± std.

Where PyTorch differs from the JAX package:

- the train step updates the live state in place, so a new best epoch is
  kept as a :func:`~mhim_mil_torch.utils.checkpoint.snapshot` of the
  weights on the card, not as a reference to the state;
- the eval steps cast the weights when they are made, so each evaluation
  makes its own from the model as it stands;
- the epoch meters stay device tensors, summed per step and read once per
  epoch; train batches go to the card two deep from pinned memory, and the
  eval splits are staged there once per fold, in fp32;
- ``steps_per_call > 1`` runs that many single steps, which is what JAX's
  scanned multi-step computes;
- the mesh is a world of processes (``torchrun``), not a device mesh of one
  process: ``--mesh_dp`` splits every batch's bags over ``mesh_dp`` rows
  of ranks and ``--mesh_sp`` each bag's instances over the ``mesh_sp``
  ranks of a row (``parallel/mesh.py``); every rank walks the same batches
  and keeps its part, as JAX's ``shard_batch(..., shard_instances=True)``
  lays it out (train and eval batches alike), the evaluation gathers the
  logits, and rank 0 alone prints, logs and writes.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.bucketing import batch_bags, count_batches
from ..data.synthetic import make_synthetic_dataset, make_synthetic_survival_dataset
from ..models import build_model
from ..parallel.mesh import Mesh, gather_rows, make_mesh, replicate_tree, shard_batch
from ..utils.checkpoint import (is_jax_checkpoint, load_checkpoint, load_jax_checkpoint, overlay_params,
                                restore_state, save_checkpoint, snapshot)
from ..utils.early_stopping import EarlyStopping
from ..utils.platform import resolve_device
from ..utils.weights import state_dict_from_flax
from . import metrics as M
from .losses import nll_surv_loss, surv_risk
from .steps import make_eval_step, make_mhim_eval_step, make_mhim_train_step, make_train_step
from .train_state import create_mhim_state, create_train_state

Device = Optional[Union[str, torch.device]]


def is_survival(cfg) -> bool:
    return cfg.datasets.lower().startswith("surv") or cfg.loss == "nll_surv"


# ---- dataset assembly ---------------------------------------------------------


def _synth_folds(cfg) -> List[Tuple[List, List, List]]:
    """Synthetic fixture folds (``driver.py:43-66``)."""
    from ..data.splits import stratified_kfold_indices

    if is_survival(cfg):
        slides = make_synthetic_survival_dataset(
            n_slides=cfg.synth_n_slides, bag_size=cfg.synth_bag_size,
            feat_dim=cfg.input_dim, n_bins=cfg.n_classes, seed=cfg.seed,
        )
    else:
        slides = make_synthetic_dataset(
            n_slides=cfg.synth_n_slides, bag_size=cfg.synth_bag_size,
            feat_dim=cfg.input_dim, n_classes=cfg.n_classes, seed=cfg.seed,
        )
    labels = np.asarray([s["target"] for s in slides])
    folds = stratified_kfold_indices(labels, max(cfg.cv_fold, 2))
    out = []
    for f in range(max(cfg.cv_fold, 2)):
        test_idx = set(folds[f].tolist())
        train = [s for i, s in enumerate(slides) if i not in test_idx]
        test = [s for i, s in enumerate(slides) if i in test_idx]
        out.append((train, test, test))
    return out[: cfg.cv_fold] if cfg.cv_fold > 1 else [out[0]]


def _csv_folds(cfg) -> List[Tuple[List, List, List]]:
    """Real feature-store folds from a dataset CSV, in the branch order of
    ``driver.py:69-173`` (reference main.py:30-84): a directory of
    ``fold_{k}.csv``; stratified k-fold of a seed-shuffled frame; or the
    ``Split`` column (repeated under ``--random_fold``). Needs pandas."""
    from ..data.readers import FeatureBagStore, build_cls_slides, build_surv_slides
    from ..data.splits import data_split, get_kfold, read_csv, split_by_column

    surv = is_survival(cfg)
    store = FeatureBagStore(cfg.dataset_root, h5_root=cfg.h5_path, persistence=cfg.persistence)
    with_pos = cfg.pos == "sincos" or cfg.model == "2dmamba"

    def to_slides(sub):
        if surv:
            return build_surv_slides(store, sub, with_pos=with_pos, num_workers=cfg.num_workers)
        return build_cls_slides(store, sub["ID"].tolist(), sub["Label"].tolist(), cfg.datasets,
                                with_pos=with_pos, num_workers=cfg.num_workers)

    def split_fold(df):
        if "Split" not in df.columns:
            if cfg.val_ratio <= 0:
                raise ValueError(
                    "csv has no 'Split' column and --val_ratio is 0: the train/test split would "
                    "be empty. Pass --val_ratio > 0 or add a Split column."
                )
            df = df.copy()
            rng = np.random.default_rng(cfg.seed)
            idx = rng.permutation(len(df))
            n_test = max(1, int(round(len(df) * cfg.val_ratio)))
            split = np.full(len(df), "train", object)
            split[idx[:n_test]] = "test"
            df["Split"] = split
            return split_by_column(df, cfg.val2test)
        tr, te, va = split_by_column(df, cfg.val2test)
        if cfg.val_ratio > 0 and va is te:
            va, tr = data_split(cfg.seed, tr, cfg.val_ratio)
        return tr, te, va

    if os.path.isdir(cfg.csv_path):
        out = []
        for k in range(max(1, cfg.cv_fold)):
            if k < cfg.fold_start:  # placeholders keep the fold indexing aligned
                out.append(([], [], []))
                continue
            df = read_csv(os.path.join(cfg.csv_path, f"fold_{k}.csv"), survival=surv)
            tr, te, va = split_fold(df)
            out.append((to_slides(tr), to_slides(te), to_slides(va)))
        return out

    df = read_csv(cfg.csv_path, survival=surv)
    if cfg.cv_fold > 1 and not cfg.random_fold:
        df = df.sample(frac=1, random_state=cfg.seed).reset_index(drop=True)
        train_dfs, test_dfs, val_dfs = get_kfold(df, cfg.cv_fold, cfg.seed, cfg.val_ratio,
                                                 val2test=cfg.val2test)
        return [(to_slides(tr), to_slides(te), to_slides(va))
                for tr, te, va in zip(train_dfs, test_dfs, val_dfs)]
    tr, te, va = split_fold(df)
    fold = (to_slides(tr), to_slides(te), to_slides(va))
    return [fold] * (max(1, cfg.cv_fold) if cfg.random_fold else 1)


def get_folds(cfg) -> List[Tuple[List, List, List]]:
    """Returns [(train_slides, test_slides, val_slides)] per fold."""
    if cfg.datasets in ("synth", "surv_synth") or not cfg.csv_path:
        return _synth_folds(cfg)
    return _csv_folds(cfg)


# ---- batches on the card --------------------------------------------------------


def _iter_batches(cfg, slides, shuffle: bool, seed: int, batch_size=None,
                  patch_shuffle: bool = False, bucket_sizes=None):
    """Host batches of ``slides`` (``driver.py:186-213``), with the
    instance-order augmentation under ``patch_shuffle``."""
    surv = is_survival(cfg)
    extra = ("target", "censorship", "event") if surv else ("target",)
    it = batch_bags(slides, batch_size or cfg.batch_size, bucket_sizes or cfg.bucket_sizes,
                    shuffle=shuffle, seed=seed, extra_keys=extra)
    if not patch_shuffle:
        yield from it
        return
    rng = np.random.default_rng(seed + 17)
    for b in it:
        n_valid = b["mask"].sum(axis=1)
        for i, n in enumerate(n_valid):
            perm = rng.permutation(int(n))
            b["feats"][i, : int(n)] = b["feats"][i, perm]
            if "pos" in b:
                b["pos"][i, : int(n)] = b["pos"][i, perm]
        yield b


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """One host batch on ``device``; on CUDA through pinned memory, without
    waiting for the copy."""
    cuda = device.type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t
    return out


def _prefetch_to_device(batch_iter, device: torch.device, depth: int = 2, mesh: Optional[Mesh] = None):
    """Double-buffered host-to-device prefetch (``driver.py:475-491``): the
    copy of batch k+1 is queued before step k runs. Under ``mesh`` only this
    rank's bags of each batch are copied."""
    q = deque()
    for b in batch_iter:
        q.append(_to_device(b if mesh is None else shard_batch(mesh, b), device))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


def device_eval_batches(cfg, slides, device: Device = None, mesh: Optional[Mesh] = None):
    """Stage a deterministic eval split on the card once
    (``driver.py:216-238``), features in fp32. Returns
    ``[(device_batch, host_labels)]``; ``eval_bucket`` pins every eval bag to
    one padded length. Under ``mesh`` the card gets this rank's bags of each
    batch and the labels stay those of the whole batch."""
    device = resolve_device(device)
    buckets = (cfg.eval_bucket,) if cfg.eval_bucket else None
    out = []
    for b in _iter_batches(cfg, slides, shuffle=False, seed=0, bucket_sizes=buckets):
        labels = {k: v for k, v in b.items() if k not in ("feats", "pos", "mask")}
        out.append((_to_device(b if mesh is None else shard_batch(mesh, b), device), labels))
    return out


# ---- evaluation ---------------------------------------------------------------


def _eval_step(cfg, model: torch.nn.Module, family: str):
    if family in ("mhim", "mhim_pure"):
        return make_mhim_eval_step(cfg, model)
    return make_eval_step(cfg, model, family)


def evaluate(cfg, model: torch.nn.Module, family: str, slides, fold: int, bootstrap: bool,
             device: Device = None) -> Dict:
    """The metric row of ``model`` (a student or a teacher) over a split
    (``driver.py:241-299``; reference BaseTrainer.validate
    engines/base_engine.py:234-329). ``slides`` is a slide list or the
    output of :func:`device_eval_batches`. The eval step is made here, from
    the weights the model holds now; the logits come to the host once, and
    DSMIL's ``sub_logits`` are fused there, ``0.5·logits + 0.5·sub_logits``
    (``driver.py:255-256``; reference common_mil.py:66-67). Under an active
    mesh, ``slides`` holds this rank's bags and the logits of every rank are
    gathered first: each rank computes the same row."""
    staged = slides if slides and isinstance(slides[0], tuple) else device_eval_batches(cfg, slides, device)
    step = _eval_step(cfg, model, family)
    outs = [{k: gather_rows(v) for k, v in step(jb).items()} for jb, _ in staged]
    logits = torch.cat([o["logits"] for o in outs]).cpu().numpy()
    if "sub_logits" in outs[0]:
        logits = 0.5 * logits + 0.5 * torch.cat([o["sub_logits"] for o in outs]).cpu().numpy()
    targets = np.concatenate([b["target"] for _, b in staged])
    keep = np.concatenate([b["bag_valid"] for _, b in staged])
    cens = [b["censorship"] for _, b in staged] if is_survival(cfg) else []
    events = [b["event"] for _, b in staged] if is_survival(cfg) else []
    logits, targets = logits[keep], targets[keep]

    if is_survival(cfg):
        risk = surv_risk(torch.from_numpy(logits)).numpy()
        row = M.evaluate_survival(risk, np.concatenate(events)[keep], np.concatenate(cens)[keep],
                                  bootstrap_enabled=bootstrap, num_bootstrap=cfg.num_bootstrap, fold=fold)
        row["_key_metric"] = row["cindex"]
    else:
        row = M.evaluate_classification(logits, targets, cfg.n_classes, bootstrap_enabled=bootstrap,
                                        num_bootstrap=cfg.num_bootstrap, fold=fold,
                                        bin_metric=cfg.bin_metric)
        # best-checkpoint metric: AUC for binary, top-1 acc for multiclass
        # (reference options.py:338-339)
        if cfg.best_metric_index == -1:
            key = "auc" if cfg.n_classes == 2 else "acc"
        else:
            key = ["auc", "acc", "f1"][cfg.best_metric_index]
        row["_key_metric"] = row[key]
    row["_val_loss"] = _host_loss(cfg, logits, targets, cens, events, keep)
    row["_logits"] = logits
    row["_targets"] = targets
    return row


def _host_loss(cfg, logits, targets, cens, events, keep) -> float:
    """Host-side validation loss matching ``cfg.loss`` (``driver.py:302-326``):
    ``--early_stop_on loss`` monitors the trained criterion."""
    if is_survival(cfg):
        return float(nll_surv_loss(torch.from_numpy(logits), torch.from_numpy(np.asarray(targets)),
                                   torch.from_numpy(np.concatenate(cens)[keep])))
    if cfg.loss == "bce":
        onehot = np.zeros_like(logits)
        onehot[np.arange(len(targets)), targets] = 1.0
        per = np.maximum(logits, 0) - logits * onehot + np.log1p(np.exp(-np.abs(logits)))
        return float(per.mean())
    x = logits - logits.max(-1, keepdims=True)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return float(-logp[np.arange(len(targets)), targets].mean())


# ---- fold / experiment --------------------------------------------------------


def _resolve_teacher_init(path: str, fold: int) -> str:
    """A ``--teacher_init`` directory holds a previous run's per-fold bests
    (reference modules/__init__.py:62-67): this port's ``.ckpt`` or the
    reference's ``.pt``."""
    if not os.path.isdir(path):
        return path
    cands = [os.path.join(path, f"fold_{fold}_model_best.ckpt"),
             os.path.join(path, f"fold_{fold}_model_best.pt")]
    for p in cands:
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"--teacher_init directory {path!r} has no fold-{fold} best checkpoint "
                            f"(looked for {[os.path.basename(c) for c in cands]})")


def _load_teacher(path: str) -> Tuple[Dict[str, torch.Tensor], bool]:
    """The ``state_dict`` of a teacher checkpoint: this port's ``.ckpt``
    (the student weights it saved), the JAX package's ``.ckpt`` (its
    ``params`` converted by ``state_dict_from_flax``, without buffers, read
    with neither JAX nor optax), told apart by their first bytes, or a
    reference ``.pt`` / ``.pth`` (``{'model': state_dict, ...}`` or a bare
    state_dict, DDP ``module.`` prefixes dropped), whose names the port
    keeps. The flag says whether it is a reference checkpoint."""
    if path.endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
            sd = sd["model"]
        return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}, True
    if is_jax_checkpoint(path):
        return state_dict_from_flax(load_jax_checkpoint(path)["params"]), False
    return load_checkpoint(path)["model"], False


def _build_fold(cfg, train_slides, fold_seed: int, fold: int = 0, device: Device = None):
    """The fold's model (weights drawn from ``fold_seed``), family, train
    state and train step (``driver.py:361-459``), with the ``--teacher_init``
    overlay (``driver.py:385-427``): the teacher takes every weight of the
    checkpoint, the student its parameters by ``--init_stu_type`` (none /
    fc / all), and only a reference ``.pt`` also gives the student its
    buffers (``global_q``). The ``mhim_pure`` family (the teacher stage)
    keeps a teacher too: the frozen copy that its ``test_ema`` rows score,
    as JAX's do."""
    device = resolve_device(device)
    model, family = build_model(cfg, device=device, generator=torch.Generator().manual_seed(fold_seed))
    n_batches = max(1, count_batches(train_slides, cfg.batch_size, cfg.bucket_sizes))
    if family not in ("mhim", "mhim_pure"):
        state = create_train_state(cfg, model, n_batches, seed=fold_seed, device=device)
        return model, family, state, make_train_step(cfg, family, n_batches, device)

    teacher = None
    if cfg.teacher_init:
        loaded, reference = _load_teacher(_resolve_teacher_init(cfg.teacher_init, fold))
        teacher = copy.deepcopy(model)
        overlay_params(teacher, loaded)
        params = {n for n, _ in model.named_parameters()}
        if cfg.init_stu_type == "all":
            overlay_params(model, {k: v for k, v in loaded.items() if k in params})
        elif cfg.init_stu_type == "fc":
            overlay_params(model, {k: v for k, v in loaded.items() if k.startswith("feature.")})
        elif cfg.init_stu_type != "none":
            raise ValueError(f"unknown init_stu_type: {cfg.init_stu_type}")
        if reference:  # JAX shares the buffers (global_q) of a reference teacher with the student
            overlay_params(model, {k: v for k, v in loaded.items() if k not in params})
    state = create_mhim_state(cfg, model, n_batches, seed=fold_seed, teacher=teacher, device=device)
    return model, family, state, make_mhim_train_step(cfg, n_batches, device)


def _read_meters(sums: Dict[str, torch.Tensor], n_steps: int) -> Dict[str, float]:
    """Epoch means of the summed step meters, in one host read."""
    if not n_steps:
        return {}
    dev = next((v.device for v in sums.values() if v.is_cuda), torch.device("cpu"))
    vals = torch.stack([v.detach().float().to(dev) for v in sums.values()]).tolist()
    return {k: v / n_steps for k, v in zip(sums, vals)}


def _start_profile(path: str, device: torch.device):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(path))
    prof.start()
    return prof


def _public(row: Dict) -> Dict:
    return {k: v for k, v in row.items() if not k.startswith("_")}


def _quiet(*args, **kwargs) -> None:
    pass


def one_fold(cfg, fold: int, train_slides, test_slides, val_slides, logger=None,
             device: Device = None, mesh: Optional[Mesh] = None) -> Dict:
    """Train and test one fold (``driver.py:494-760``; reference one_fold
    main.py:189-428). The result carries ``timing``: the fold's wall
    seconds, its train steps and their seconds, and the seconds spent in
    evaluation. Under ``mesh`` (``driver.py:505-519``) the state is
    broadcast from rank 0, each rank trains and evaluates on its bags of
    every batch inside ``with mesh:``, and rank 0 alone prints and writes
    checkpoints."""
    device = resolve_device(device)
    t_fold = time.perf_counter()
    timing = {"train_steps": 0, "train_seconds": 0.0, "eval_seconds": 0.0}
    # per-fold reseed when the folds are otherwise identical repeats (reference main.py:205)
    fold_seed = cfg.seed + 100 * fold if (cfg.random_seed or cfg.random_fold) else cfg.seed
    _, family, state, train_step = _build_fold(cfg, train_slides, fold_seed, fold, device)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else _quiet
    logger = logger if lead else None
    if mesh is not None:
        replicate_tree(mesh, state)
    with mesh if mesh is not None else contextlib.nullcontext():
        same_split = test_slides is val_slides
        val_slides = device_eval_batches(cfg, val_slides, device, mesh)
        test_slides = val_slides if same_split else device_eval_batches(cfg, test_slides, device, mesh)

        def run_eval(model, slides, bootstrap):
            t0 = time.perf_counter()
            row = evaluate(cfg, model, family, slides, fold, bootstrap)
            timing["eval_seconds"] += time.perf_counter() - t0
            return row

        boot = cfg.bootstrap_mode in ("test", "test_val")
        if cfg.script_mode == "test":  # reference --script_mode test: reload the bests and test them
            root = cfg.model_path or cfg.output_path
            path, ema_path = root, None
            if root and os.path.isdir(root):
                path = os.path.join(root, f"fold_{fold}_model_best.ckpt")
                ema_path = os.path.join(root, f"fold_{fold}_ema_model_best.ckpt")
            if path and os.path.exists(path):
                restore_state(state, load_checkpoint(path))
                say(f"[fold {fold}] loaded {path}")
            out = {"fold": fold, "best_epoch": -1, "best_val": float("nan"),
                   "test": _public(run_eval(state.model, test_slides, boot)), "history": []}
            if ema_path and os.path.exists(ema_path) and state.teacher is not None:
                restore_state(state, load_checkpoint(ema_path))
                out["test_ema"] = _public(run_eval(state.teacher, test_slides, boot))
            out["timing"] = {**timing, "seconds": time.perf_counter() - t_fold}
            return out

        stopper = EarlyStopping(patience=cfg.patient, stop_epoch=cfg.max_epoch)
        # Dual best tracking (reference main.py:348-369), each a snapshot of the
        # weights when found: the step updates the live state in place.
        best = {"metric": -np.inf, "weights": snapshot(state), "epoch": -1}
        best_ema = {"metric": -np.inf, "weights": None, "epoch": -1}
        history = []

        epoch_start = cfg.epoch_start
        ckp_path = os.path.join(cfg.output_path, f"ckp_fold{fold}.ckpt") if cfg.output_path else None
        if cfg.auto_resume and ckp_path and os.path.exists(ckp_path):
            payload = load_checkpoint(ckp_path)
            restore_state(state, payload)
            meta = payload["metadata"]
            epoch_start = meta.get("epoch", -1) + 1
            stopper.load_state_dict(meta.get("early_stop", {}))
            say(f"[fold {fold}] resumed at epoch {epoch_start}")

        interrupted = False
        for epoch in range(epoch_start, cfg.num_epoch):
            # --profile: a torch.profiler trace of the first trained epoch under output_path/profile
            prof = None
            if cfg.profile and epoch == epoch_start and cfg.output_path and lead:
                prof = _start_profile(os.path.join(cfg.output_path, "profile"), device)
            t0 = time.time()
            n_steps = 0
            sums: Dict[str, torch.Tensor] = {}
            if cfg.script_mode != "no_train":  # no_train keeps the epochs and validation, without updates
                t_train = time.perf_counter()
                try:
                    batch_it = _iter_batches(cfg, train_slides, shuffle=True, seed=fold_seed + epoch,
                                             patch_shuffle=cfg.patch_shuffle)
                    for batch in _prefetch_to_device(batch_it, device, mesh=mesh):
                        for k, v in train_step(state, batch).items():
                            sums[k] = v if k not in sums else sums[k] + v
                        n_steps += 1
                except KeyboardInterrupt:
                    # Ctrl-C falls through to the final test on the best-so-far
                    # weights (reference main.py:381-382).
                    say(f"[fold {fold}] interrupted — running final test")
                    interrupted = True
                meters = _read_meters(sums, n_steps)
                timing["train_steps"] += n_steps
                timing["train_seconds"] += time.perf_counter() - t_train
            else:
                meters = {}
            train_loss = meters.get("loss", 0.0)
            if prof is not None:
                prof.stop()
            if interrupted:
                break

            if cfg.script_mode == "only_train":  # reference main.py:270-271
                history.append({"epoch": epoch, "train_loss": train_loss})
                if logger is not None:
                    logger.log({f"fold{fold}/train_loss": train_loss}, step=epoch)
                say(f"[fold {fold}] epoch {epoch}: train_loss={train_loss:.4f} "
                    f"({time.time() - t0:.1f}s, {n_steps} steps)")
                continue

            row = run_eval(state.model, val_slides, False)
            rows = {"val": row}
            if cfg.always_test:
                rows["test_track"] = run_eval(state.model, test_slides, False)
            if state.teacher is not None:  # MHIM or generic EMA (reference main.py:273-277)
                rows["val_ema"] = run_eval(state.teacher, val_slides, False)
            snap = None
            if row["_key_metric"] > best["metric"]:
                snap = snapshot(state)
                best = {"metric": row["_key_metric"], "weights": snap, "epoch": epoch}
            if "val_ema" in rows and rows["val_ema"]["_key_metric"] > best_ema["metric"]:
                best_ema = {"metric": rows["val_ema"]["_key_metric"], "weights": snap or snapshot(state),
                            "epoch": epoch}
            history.append({
                "epoch": epoch,
                "train_loss": train_loss,
                **{k: v for k, v in meters.items() if k != "loss"},
                "val": _public(row),
                "time": time.time() - t0,
            })
            if logger is not None:
                logger.log(
                    {f"fold{fold}/train_loss": train_loss,
                     **{f"fold{fold}/train_{k}": v for k, v in meters.items() if k != "loss"},
                     **{f"fold{fold}/val_{k}": v for k, v in row.items()
                        if isinstance(v, (int, float)) and not k.startswith("_")}},
                    step=epoch,
                )
            if cfg.log_iter and (epoch % max(1, cfg.log_iter // 10) == 0 or epoch < 3):
                say(f"[fold {fold}] epoch {epoch}: train_loss={train_loss:.4f} "
                    f"val={row['_key_metric']:.4f} ({time.time() - t0:.1f}s, {n_steps} steps)")
            # the reference stops on the negative task metric of the student val
            # row; loss-based stopping is opt-in (--early_stop_on loss)
            monitor = row["_val_loss"] if cfg.early_stop_on == "loss" else -row["_key_metric"]
            stop = cfg.early_stopping and stopper(epoch, monitor)
            if cfg.auto_resume and ckp_path and lead:
                save_checkpoint(ckp_path, state, metadata={"epoch": epoch, "early_stop": stopper.state_dict()})
            if stop:
                say(f"[fold {fold}] early stop at epoch {epoch}")
                break

        # final test: the student best through the student, the EMA best through
        # the teacher (reference main.py:384-413), loaded into the live modules
        state.model.load_state_dict(best["weights"]["model"])
        test_row = run_eval(state.model, test_slides, boot)
        test_row_ema = None
        if best_ema["weights"] is not None:
            state.teacher.load_state_dict(best_ema["weights"]["teacher"])
            test_row_ema = run_eval(state.teacher, test_slides, boot)
        if cfg.output_path and lead:
            os.makedirs(cfg.output_path, exist_ok=True)
            save_checkpoint(os.path.join(cfg.output_path, f"fold_{fold}_model_best.ckpt"), state,
                            metadata={"epoch": best["epoch"], "fold": fold, "val_metric": best["metric"]},
                            weights=best["weights"])
            if best_ema["weights"] is not None:
                save_checkpoint(os.path.join(cfg.output_path, f"fold_{fold}_ema_model_best.ckpt"), state,
                                metadata={"epoch": best_ema["epoch"], "fold": fold,
                                          "val_metric": best_ema["metric"], "teacher": True},
                                weights=best_ema["weights"])
            if cfg.save_result:  # per-slide test predictions (reference --save_result)
                np.savez(os.path.join(cfg.output_path, f"fold_{fold}_test_predictions.npz"),
                         logits=test_row["_logits"], targets=test_row["_targets"])
        if cfg.auto_resume and ckp_path and lead and os.path.exists(ckp_path):
            os.remove(ckp_path)
        out = {"fold": fold, "best_epoch": best["epoch"], "best_val": best["metric"],
               "test": _public(test_row), "history": history}
        if test_row_ema is not None:
            out["best_epoch_ema"] = best_ema["epoch"]
            out["best_val_ema"] = best_ema["metric"]
            out["test_ema"] = _public(test_row_ema)
        out["timing"] = {**timing, "seconds": time.perf_counter() - t_fold}
        return out


def resolve_mesh(cfg) -> Optional[Mesh]:
    """The mesh of a run (``driver.py:462-472`` ``_maybe_mesh``). In a world
    of one process there is none, whatever the flags, and training runs as
    without them. In a larger world (``torchrun``) the mesh is an explicit
    opt-in: no ``--mesh_dp`` / ``--mesh_sp`` raises ``ValueError``, every
    model runs under dp and sp, ``dp·sp`` must fit the world (the ranks
    past it idle, as JAX keeps ``devices[:dp*sp]``) and ``mesh_dp`` must
    divide the batch. Every rank calls it: it makes the mesh's process
    groups."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world == 1:
        return None
    if cfg.mesh_dp == -1 and cfg.mesh_sp == 1:
        raise ValueError(f"a world of {world} processes without --mesh_dp or --mesh_sp: pass --mesh_dp to "
                         f"train data-parallel (each rank would otherwise train the whole batch)")
    mesh = make_mesh(cfg.mesh_dp, cfg.mesh_sp)
    if cfg.batch_size % mesh.dp:
        raise ValueError(f"--batch_size {cfg.batch_size} does not split over --mesh_dp {mesh.dp}")
    return mesh


def _gate_on_rank0(cfg, device, mesh: Optional[Mesh]):
    """The kernel gate, run by rank 0 alone; its outcome (or its error)
    is broadcast, so that every rank takes the same path."""
    import torch.distributed as dist

    from ..utils.kernel_gate import resolve_kernel_gate

    if mesh is None:
        return resolve_kernel_gate(cfg, device)
    box = [None]
    if mesh.rank == 0:
        try:
            out = resolve_kernel_gate(cfg, device)
            box[0] = (out[0].use_flash_attn, out[1], None)
        except Exception as e:  # every rank raises it below
            box[0] = (None, None, e)
    dist.broadcast_object_list(box, src=0)
    enabled, gate, err = box[0]
    if err is not None:
        raise err
    return cfg.replace(use_flash_attn=enabled), gate


def _results_group():
    """A gloo group of the whole world without a short timeout, made by
    every rank before the run: the ranks past the mesh wait on it for rank
    0's results for as long as the run takes."""
    import datetime

    import torch.distributed as dist

    return dist.new_group(backend="gloo", timeout=datetime.timedelta(days=7))


def _share_results(group, results: Optional[Dict]) -> Dict:
    """Rank 0's results on every rank of ``group``."""
    import torch.distributed as dist

    box = [results]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def run_experiment(cfg, device: Device = None) -> Dict:
    """Full k-fold experiment (``driver.py:763-822``; reference
    main.py:20-187) on ``device`` (CUDA unless ``"cpu"`` is asked for),
    behind the kernel gate. Returns the per-fold results, the cross-fold
    mean ± std of the test metrics (``summary``, and ``summary_ema`` for the
    EMA bests) and the gate's result (``kernel_gate``).

    In a world of processes (:func:`resolve_mesh`) every rank returns rank
    0's results: the ranks of the mesh compute the same ones, and the ranks
    past it take no batch and receive them."""
    from ..utils.logging import RunLogger, git_provenance

    device = resolve_device(device)
    mesh = resolve_mesh(cfg)
    results_group = _results_group() if mesh is not None and mesh.dp * mesh.sp < mesh.world else None
    cfg, gate = _gate_on_rank0(cfg, device, mesh)
    if mesh is not None and mesh.idle:
        return _share_results(results_group, None)
    lead = mesh is None or mesh.rank == 0
    say = print if lead else _quiet
    logger = RunLogger(cfg.output_path if lead else None, project=cfg.project, title=cfg.title,
                       use_wandb=cfg.wandb and lead, config=dataclasses.asdict(cfg))
    prov = git_provenance(auto_commit=cfg.auto_commit) if lead else {}
    if prov:
        logger.log({f"provenance/{k}": v for k, v in prov.items()})
    logger.log({f"kernel_gate/{k}": v for k, v in gate.items()})
    folds = get_folds(cfg)
    results = []
    for k, (tr, te, va) in enumerate(folds):
        if k < cfg.fold_start:
            continue
        say(f"[fold {k}] train={len(tr)} test={len(te)} val={len(va)} "
            f"model={cfg.model} baseline={cfg.baseline}")
        results.append(one_fold(cfg, k, tr, te, va, logger=logger, device=device, mesh=mesh))

    def _aggregate(row_key):
        agg: Dict[str, Dict[str, float]] = {}
        rows = [r[row_key] for r in results if row_key in r]
        if not rows:
            return agg
        for key, v in rows[0].items():
            if not isinstance(v, (int, float)):
                continue
            vals = np.asarray([r[key] for r in rows], float)
            agg[key] = {"mean": float(np.nanmean(vals)), "std": float(np.nanstd(vals))}
        return agg

    summary = _aggregate("test")
    out = {"folds": results, "summary": summary, "config_model": cfg.model, "kernel_gate": gate}
    summary_ema = _aggregate("test_ema")
    if summary_ema:
        out["summary_ema"] = summary_ema
    say("==== cross-val summary ====")
    for key, v in summary.items():
        say(f"  {key}: {v['mean']:.4f} ± {v['std']:.4f}")
    for key, v in summary_ema.items():
        say(f"  ema_{key}: {v['mean']:.4f} ± {v['std']:.4f}")
    logger.log({f"summary/{k}": v["mean"] for k, v in summary.items()})
    if summary_ema:
        logger.log({f"summary/ema_{k}": v["mean"] for k, v in summary_ema.items()})
    logger.close()
    return out if results_group is None else _share_results(results_group, out)
