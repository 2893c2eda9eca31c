"""Precision policy, the teacher EMA, the MHIM train and eval steps and the
generic train and eval steps (port of ``cast_compute``, ``ema_update``,
``grad_norm_metrics``, ``make_train_step`` and ``make_eval_step`` in
``mhim_mil_tpu/engine/steps.py`` and of ``make_mhim_train_step`` /
``make_mhim_eval_step`` in ``models/mhim.py``)."""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Union

import torch
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function

from ..parallel.mesh import (active as active_mesh, active_sp, all_reduce_grads, batch_sum, local_rows, rand_rows,
                             seq_layout, sp_sum)
from ..utils.platform import resolve_device
from ..utils.schedules import cosine_schedule
from .losses import build_criterion, cross_entropy
from .train_state import TrainState

Tensor = torch.Tensor


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if getattr(cfg, "compute_dtype", "float32") == "bfloat16" else torch.float32


def cast_compute(cfg, model: nn.Module) -> Dict[str, Tensor]:
    """Mixed-precision policy (``steps.py:25-35``): under
    ``compute_dtype="bfloat16"``, the bf16 casts of the model's fp32
    parameters, by name, for :func:`apply_cast`; empty under fp32. The casts
    are differentiable, so gradients reach the fp32 master weights (and the
    optimizer state stays fp32). Every op then runs in bf16, LayerNorm and
    softmax included, as under JAX's cast of the whole param tree; softmax
    statistics, the pseudo-inverse, the attention kernels and the losses run
    in fp32 whatever the policy. Buffers are not cast."""
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        return {}
    return {n: p.to(dtype) for n, p in model.named_parameters() if p.dtype == torch.float32}


class _Method(nn.Module):
    """Calls one method of the wrapped module, so that ``functional_call``
    can run methods other than ``forward``."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model, self.method = model, method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def apply_cast(model: nn.Module, params: Dict[str, Tensor], method: str, *args, **kwargs):
    """``model.<method>(*args, **kwargs)`` with ``params`` (from
    :func:`cast_compute`) in place of the module's own parameters."""
    if not params:
        return getattr(model, method)(*args, **kwargs)
    return functional_call(_Method(model, method), {f"model.{n}": p for n, p in params.items()},
                           args, kwargs)


def _cast_batch(dtype: torch.dtype, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: (v.to(dtype) if k == "feats" else v) for k, v in batch.items()}


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, mm) -> None:
    """Teacher EMA over the parameters, ``t ← mm·t + (1−mm)·s`` (reference
    base_engine.py:155-167). Buffers are left alone: the Merge module's
    ``global_q_mm`` has its own EMA in the student's forward."""
    torch._foreach_lerp_(list(teacher.parameters()), list(student.parameters()), float(1.0 - mm))


def grad_norm_metrics(cfg, model: nn.Module) -> Dict[str, Tensor]:
    """Under ``wandb_watch``, the global norm of the raw gradients of each
    top-level module, ``grad_norm/<module>`` (``steps.py:155-163``), as 0-d
    device tensors; empty otherwise."""
    if not getattr(cfg, "wandb_watch", False):
        return {}
    groups: Dict[str, list] = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            groups.setdefault(name.split(".")[0], []).append(torch.linalg.vector_norm(p.grad.float()))
    return {f"grad_norm/{k}": torch.linalg.vector_norm(torch.stack(v)) for k, v in groups.items()}


ABLATIONS = (None, "no_teacher", "fwd_only", "no_opt_ema", "no_ema")


def global_norm(model: nn.Module) -> Tensor:
    """The L2 norm of all of ``model``'s gradients together, in fp32
    (``optax.global_norm``); a parameter without a gradient counts zero."""
    norms = [torch.linalg.vector_norm(p.grad.float()) for p in model.parameters() if p.grad is not None]
    if not norms:
        return torch.zeros((), device=next(model.parameters()).device)
    return torch.linalg.vector_norm(torch.stack(norms))


def valid_fraction(mask: Tensor) -> Tensor:
    """The valid share of the batch's instance slots (the whole bags' under
    sp, on every rank of the row)."""
    if active_sp() is None:
        return mask.float().mean()
    both = sp_sum(torch.stack([mask.sum(), torch.as_tensor(mask.numel(), device=mask.device)]).float())
    return both[0] / both[1]


def global_metrics(sums: Dict[str, Tensor], means: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Under an active mesh, the batch's metrics from this rank's: the
    ``sums`` (the loss terms, each rank's part of the global loss) summed
    and the ``means`` (over equal numbers of bags on each dp rank, the same
    on every rank of an sp row) averaged over the ranks, in one all-reduce.
    Without a mesh, the two as given."""
    mesh = active_mesh()
    if mesh is None:
        return {**sums, **means}
    keys = list(sums) + list(means)
    vals = batch_sum(torch.stack([v.detach().float() for v in (*sums.values(), *means.values())]))
    out = dict(zip(keys, vals.unbind()))
    return {**{k: out[k] for k in sums}, **{k: out[k] / (mesh.dp * mesh.sp) for k in means}}


def make_mhim_train_step(
    cfg, steps_per_epoch: int, device: Optional[Union[str, torch.device]] = None,
    ablate: Optional[str] = None,
) -> Callable[..., Dict[str, Tensor]]:
    """The MHIM train step (``mhim.py:349-489``) for ``cfg.model`` ``mhim``
    or ``mhim_pure``, run on ``device`` (CUDA unless ``"cpu"`` is asked
    for). ``step(state, batch, draws=None)`` runs, in order:

    - the teacher's ``forward_teacher`` in training mode, under no_grad;
    - the scheduled high-mining ratio ``mrh`` (cosine, with ``mrh_sche``);
    - the student's training pass;
    - ``main_alpha``·criterion + ``aux_alpha``·``soft_target_ce``;
    - backward and the optimizer's micro-step (an update on every
      ``accumulation_steps``-th, see ``Optimizer.step``);
    - the teacher EMA at ``mm`` (or its cosine schedule with ``mm_sche``),
      on every micro-step.

    ``mrh`` and ``mm`` read the micro-step count ``state.step``. For
    ``mhim_pure`` (the teacher stage, ``mhim.py:374, 387-395``) the student
    runs its ``pure`` pass and there is no teacher forward and no EMA: the
    teacher stays the copy made at init, and ``aux_loss`` is 0.

    ``ablate`` builds a diagnostic variant of the step with one part taken
    out (``mhim.py:351-471``), which ``tools/step_breakdown.py`` times
    against the whole step:

    - ``"no_teacher"``: no teacher forward. The mining reads a fixed uniform
      attention of ``mask``'s shape in fp32, zero at masked instances as the
      teacher's score is, drawn once per shape from a generator seeded 0 on
      the step's device (``draws["teacher_attn"]`` replaces it), and the
      consistency loss a zero teacher feature ``[B, inner_dim]`` (None when
      ``aux_alpha`` is 0). Mining, merge and both losses still run;
    - ``"fwd_only"``: teacher, student and losses under no_grad; no
      backward, no optimizer micro-step, no EMA. ``state.step`` advances
      and the Merge's ``global_q_mm`` still moves;
    - ``"no_opt_ema"``: the backward runs, then no optimizer micro-step (its
      accumulation counter stays) and no EMA; the metrics add ``gnorm``,
      the global norm of the gradients;
    - ``"no_ema"``: the update runs and the teacher EMA does not.

    For ``mhim_pure``, ``no_teacher`` and ``no_ema`` change nothing.

    The stages run under ``record_function`` ranges (``mhim.teacher``,
    ``mhim.student``, ``mhim.backward``, ``mhim.update``) that a profiler
    reads. It updates ``state`` (a ``TrainState``) in place and returns the
    metrics of ``mhim.py:428-437`` with ``loss`` and ``mm`` (``fwd_only``:
    without ``mm``; ``no_opt_ema``: ``gnorm`` for ``mm``), as 0-d tensors.
    ``batch`` holds ``feats``, ``mask``, ``target`` and optionally
    ``bag_valid`` on the device. Random numbers come from ``state.gen``,
    except the student's mining and merge draws where ``draws`` gives them
    (see ``MHIM.forward``).

    Under an active mesh (``parallel/mesh.py``; every baseline, under dp
    and under sp) ``batch`` holds this rank's bags
    and ``draws`` the whole batch's: the gradients are summed over the
    ranks before the optimizer, and the metrics are the whole batch's. The
    step's couplings over the bags are the criterion's and the consistency
    loss's weight sums (``_wmean``; MHIM-dsmil's ``[B, 1]`` bag weight
    against its ``[B, C]`` per-class losses counts each bag once), the
    Merge's ``global_q`` sums and the draws.
    """
    device = resolve_device(device)
    if cfg.model not in ("mhim", "mhim_pure"):
        raise NotImplementedError(f"model={cfg.model!r}: only the mhim and mhim_pure train steps are ported")
    if ablate not in ABLATIONS:
        raise ValueError(f"ablate={ablate!r}: not one of {ABLATIONS}")
    is_pure = cfg.model == "mhim_pure"
    criterion = build_criterion(cfg)
    dtype = compute_dtype(cfg)
    total_steps = max(cfg.num_epoch * steps_per_epoch, 1)
    mrh_sche = cosine_schedule(cfg.mask_ratio_h, 0.0, total_steps) if cfg.mrh_sche else None
    mm_sche = cosine_schedule(cfg.mm, 1.0, total_steps) if cfg.mm_sche else None
    fixed_attn: Dict[tuple, Tensor] = {}  # no_teacher's draw, by mask shape and instance layout

    def uniform_attention(mask: Tensor, seq) -> Tensor:
        key = (mask.shape, seq)
        if key not in fixed_attn:
            gen0 = torch.Generator(device=mask.device).manual_seed(0)
            fixed_attn[key] = rand_rows(mask.shape, gen0, mask.device, seq)
        return fixed_attn[key]

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   draws: Optional[Dict[str, object]] = None) -> Dict[str, Tensor]:
        if batch["feats"].device.type != device.type:
            raise ValueError(f"batch on {batch['feats'].device}, step on {device}")
        student, teacher, gen = state.model, state.teacher, state.gen
        batch_c = _cast_batch(dtype, batch)
        feats, mask = batch_c["feats"], batch["mask"].bool()

        if not is_pure:
            if ablate == "no_teacher":
                attn = (draws or {}).get("teacher_attn")
                seq = seq_layout(mask.shape[1], mask.device)
                if attn is None:
                    attn = uniform_attention(mask, seq)
                else:
                    attn = local_rows(attn.to(mask.device, torch.float32))
                    attn = attn if seq is None else attn[:, seq.cols]
                attn = torch.where(mask, attn, 0.0)
                cls_tea = (None if cfg.aux_alpha == 0.0
                           else torch.zeros((mask.shape[0], cfg.inner_dim), dtype=torch.float32, device=mask.device))
            else:
                # The reference's EMA teacher mines with its dropouts on
                # (model_ema.train(), base_engine.py:37-38).
                with record_function("mhim.teacher"):
                    cls_tea, attn = apply_cast(teacher, cast_compute(cfg, teacher), "forward_teacher",
                                               feats, mask, training=True, gen=gen)
                cls_tea = None if cfg.aux_alpha == 0.0 else cls_tea
            mrh = mrh_sche(state.step) if mrh_sche is not None else None
        with record_function("mhim.student"), torch.set_grad_enabled(ablate != "fwd_only"):
            params = cast_compute(cfg, student)
            if is_pure:
                out = apply_cast(student, params, "pure", feats, mask, training=True, gen=gen)
            else:
                out = apply_cast(student, params, "forward", feats, mask, attn, cls_tea, mrh,
                                 training=True, gen=gen, draws=draws)
            main = criterion(out["logits"], batch)
            loss = cfg.main_alpha * main + cfg.aux_alpha * out["aux_loss"]
        metrics = global_metrics(
            {"loss": loss.detach(), "main_loss": main.detach(), "aux_loss": out["aux_loss"].detach()},
            {"patch_num": out["patch_num"].float().mean(), "keep_num": out["keep_num"].float().mean(),
             "valid": valid_fraction(mask)})
        # the padded fraction of the bucket (mhim.py:433-436)
        metrics["pad_ratio"] = 1.0 - metrics.pop("valid")
        loss_d = metrics.pop("loss")
        if ablate == "fwd_only":
            state.step += 1
            return {"loss": loss_d, **metrics}
        with record_function("mhim.backward"):
            state.optimizer.zero_grad()
            loss.backward()
            all_reduce_grads(student)
        if ablate == "no_opt_ema":
            state.step += 1
            return {"loss": loss_d, "gnorm": global_norm(student), **metrics}
        grad_norms = grad_norm_metrics(cfg, student)
        with record_function("mhim.update"):
            state.optimizer.step()
            mm = mm_sche(state.step) if mm_sche is not None else cfg.mm
            if not is_pure and ablate != "no_ema":
                ema_update(teacher, student, mm)
        state.step += 1
        return {"loss": loss_d, "mm": torch.as_tensor(mm, dtype=torch.float32), **metrics, **grad_norms}

    return train_step


TRAIN_FAMILIES = ("default", "clam", "dsmil", "mamba2d")


def _forward_inputs(model: nn.Module, family: str, batch: Dict[str, Tensor]):
    """The positional and keyword inputs of a generic model's forward beyond
    ``(feats, mask)`` (``steps.py:66-73``): the grid coordinates ``pos`` for
    ``mamba2d``, or as ``coords`` for a ``pos="sincos"`` model, when the
    batch holds them. Under an sp mesh ``pos`` is this rank's block of the
    instances' coordinates, sharded with them (``shard_batch``)."""
    if "pos" not in batch:
        return (), {}
    if family == "mamba2d":
        return (batch["pos"],), {}
    if getattr(model, "pos", None) == "sincos":
        return (), {"coords": batch["pos"]}
    return (), {}


def _pseudo_bag_loss(out: Dict[str, Tensor], batch: Dict[str, Tensor]) -> Tensor:
    """DTFD's tier-1 loss (``steps.py:86-98``): the cross-entropy of each
    filled pseudo-bag of a real bag against the bag's label."""
    sp = out["sub_preds"]  # [B,G,C]
    w = out["sub_preds_mask"]
    if "bag_valid" in batch:
        w = w & batch["bag_valid"].bool()[:, None]
    tgt = batch["target"][:, None].expand(sp.shape[:2])
    return cross_entropy(sp.reshape(-1, sp.shape[-1]), tgt.reshape(-1), w.reshape(-1))


def make_train_step(
    cfg, family: str, steps_per_epoch: int, device: Optional[Union[str, torch.device]] = None,
) -> Callable[[TrainState, Dict[str, Tensor]], Dict[str, Tensor]]:
    """The generic train step (``steps.py:38-137``) for the families
    ``default`` (abmil, gabmil, meanmil, maxmil, transmil, dtfd, ibmil,
    rrtmil), ``clam``, ``dsmil`` and ``mamba2d``, run on ``device`` (CUDA
    unless ``"cpu"`` is asked for). ``step(state, batch)`` runs the model's
    training forward on ``feats``, ``mask``, for ``clam`` the bag label
    ``target`` (``steps.py:66-67``), and the grid coordinates ``pos`` where
    the model takes them (:func:`_forward_inputs`); pays
    ``main_alpha``·criterion + ``aux_alpha``·aux, aux being the model's
    ``aux_loss`` (when it returns one: CLAM's instance loss) plus the
    criterion of DSMIL's max-pooled instance logits ``inst_logits_bag``
    (``steps.py:84-87``) plus, for DTFD, the cross-entropy of its
    pseudo-bag predictions ``sub_preds [B,G,C]`` against the bag label,
    weighted by ``sub_preds_mask`` and ``bag_valid`` (``steps.py:88-98``);
    takes the optimizer's
    micro-step (an update on every ``accumulation_steps``-th); and under
    ``model_ema`` moves ``state.teacher`` by the EMA at
    ``model_ema_decay``. Attention pools train on their plain path (K4 has
    no gradient), TransMIL's layers through K3, 2dmamba on the plain 2D
    scan (K5 has no gradient). It updates ``state`` in place and returns
    ``loss``, ``main_loss``, ``aux_loss``, ``pad_ratio`` and, under
    ``wandb_watch``, the ``grad_norm/<module>`` meters, as 0-d tensors.
    Under an active mesh, as in :func:`make_mhim_train_step`: every model
    runs under dp. The couplings over the bags are the criterion's weight
    sum, and with it those of DSMIL's instance loss, DTFD's pseudo-bag loss
    (each rank's filled pseudo-bags of its real bags) and 2dmamba's
    survival loss (``_wmean``); CLAM's instance loss divides by the whole
    batch's count of bags with a valid instance (``models/clam.py``); every
    dropout mask is the global draw's rows; IBMIL's confounder bank is a
    buffer, broadcast from rank 0 with the weights (``replicate_tree``).
    Under sp each model routes its couplings over the instances through the
    sp collectives itself (its module's docstring)."""
    device = resolve_device(device)
    if family not in TRAIN_FAMILIES:
        raise NotImplementedError(f"family={family!r}: the generic train step is ported for {TRAIN_FAMILIES}")
    criterion = build_criterion(cfg)
    dtype = compute_dtype(cfg)

    def train_step(state: TrainState, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        if batch["feats"].device.type != device.type:
            raise ValueError(f"batch on {batch['feats'].device}, step on {device}")
        model = state.model
        feats = _cast_batch(dtype, batch)["feats"]
        extra, kw = _forward_inputs(model, family, batch)
        if family == "clam":
            extra = (batch["target"],)
        with record_function("train.forward"):
            out = apply_cast(model, cast_compute(cfg, model), "forward", feats, batch["mask"], *extra,
                             training=True, gen=state.gen, **kw)
            main = criterion(out["logits"], batch)
            aux = out.get("aux_loss", torch.zeros((), device=main.device))
            if "inst_logits_bag" in out:
                aux = aux + criterion(out["inst_logits_bag"], batch)
            if "sub_preds" in out:
                aux = aux + _pseudo_bag_loss(out, batch)
            loss = cfg.main_alpha * main + cfg.aux_alpha * aux
        with record_function("train.backward"):
            state.optimizer.zero_grad()
            loss.backward()
            all_reduce_grads(model)
        grad_norms = grad_norm_metrics(cfg, model)
        with record_function("train.update"):
            state.optimizer.step()
            if state.teacher is not None:
                ema_update(state.teacher, model, cfg.model_ema_decay)
        state.step += 1
        metrics = global_metrics({"loss": loss.detach(), "main_loss": main.detach(), "aux_loss": aux.detach()},
                                 {"valid": valid_fraction(batch["mask"])})
        metrics["pad_ratio"] = 1.0 - metrics.pop("valid")
        return {**metrics, **grad_norms}

    return train_step


MHIM_FAMILIES = ("mhim", "mhim_pure")


class EvalBody(nn.Module):
    """The family-dispatched inference body (the port of ``_infer_fn`` in
    ``mhim_mil_tpu/utils/serving.py``) that the eval steps, the scorer and
    the serving export run: ``forward_test`` for ``mhim`` and
    ``mhim_pure``, the model's ``forward(training=False)`` otherwise, on
    the batch cast to the config's compute dtype, returning fp32
    ``{"logits"}`` and, where the model gives DSMIL's max-pooled instance
    logits, ``"sub_logits"`` unfused. ``pos`` (the grid coordinates) goes
    to the models that take it (:func:`_forward_inputs`).

    Under fp32 it runs ``model`` itself. Under bf16 it holds a copy of
    ``model`` whose fp32 parameters are cast once, when it is made, as
    :func:`cast_compute` casts them (its buffers copied, not cast): its own
    parameters, so that an export traces them as the program's state; the
    copy serves the weights the model held at that time. Either way its
    logits are those of the functional call over :func:`cast_compute`'s
    weights, bit for bit."""

    def __init__(self, cfg, model: nn.Module, family: str):
        super().__init__()
        self.family, self.dtype = family, compute_dtype(cfg)
        if self.dtype != torch.float32:
            memo = {id(p): nn.Parameter(p.detach().to(self.dtype), requires_grad=False)
                    for p in model.parameters() if p.dtype == torch.float32}
            model = copy.deepcopy(model, memo)
        self.model = model

    def forward(self, feats: Tensor, mask: Tensor, pos: Optional[Tensor] = None) -> Dict[str, Tensor]:
        feats = feats.to(self.dtype)
        if self.family in MHIM_FAMILIES:
            return {"logits": self.model.forward_test(feats, mask)["logits"].float()}
        extra, kw = _forward_inputs(self.model, self.family, {} if pos is None else {"pos": pos})
        out = self.model(feats, mask, *extra, training=False, **kw)
        res = {"logits": out["logits"].float()}
        if "inst_logits_bag" in out:
            res["sub_logits"] = out["inst_logits_bag"].float()
        return res


def _eval_step(cfg, body: EvalBody) -> Callable[[Dict[str, Tensor]], Dict[str, Tensor]]:
    """The eval step of ``body``: under an active mesh the batch holds this
    rank's part, and the logits are its bags'."""
    @torch.inference_mode()
    def eval_step(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return body(batch["feats"], batch["mask"], batch.get("pos"))

    return eval_step


def make_mhim_eval_step(cfg, model: nn.Module) -> Callable[[Dict[str, Tensor]], Dict[str, Tensor]]:
    """Inference through ``forward_test`` under the config's precision policy
    (reference common_mil.py:56-63): :class:`EvalBody` under
    ``inference_mode``. The step takes ``{"feats", "mask"}`` on the model's
    device and returns fp32 ``{"logits"}``.

    Under bf16 the weights are cast once, when the step is made: the step
    then serves the weights the model held at that time.
    """
    return _eval_step(cfg, EvalBody(cfg, model, "mhim"))


def make_eval_step(cfg, model: nn.Module, family: str) -> Callable[[Dict[str, Tensor]], Dict[str, Tensor]]:
    """Inference through the model's ``forward`` (``steps.py:166-190``) under
    the config's precision policy, weights cast once as in
    :func:`make_mhim_eval_step`: :class:`EvalBody` under ``inference_mode``.
    The step takes ``{"feats", "mask"}`` on the model's device and the grid
    coordinates ``"pos"`` where the model takes them
    (:func:`_forward_inputs`); it returns fp32 ``{"logits"}``, and
    ``"sub_logits"`` (DSMIL's max-pooled instance logits) when the model
    gives them: the caller fuses the two."""
    return _eval_step(cfg, EvalBody(cfg, model, family))
