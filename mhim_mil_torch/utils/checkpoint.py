"""Checkpoints of train states (port of ``mhim_mil_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` file holding the student's and the
teacher's ``state_dict`` (the teacher is None for a generic state without
``model_ema``), the optimizer's state, the step count, the state of the
train generator (``torch.Generator.get_state``) and free-form metadata. A
best checkpoint comes from a :func:`snapshot` of the weights at the best
epoch and holds no optimizer or generator state. Loading uses
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..engine.train_state import TrainState


def _clone(module: Optional[torch.nn.Module]) -> Optional[Dict[str, torch.Tensor]]:
    if module is None:
        return None
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def snapshot(state: TrainState) -> Dict[str, Any]:
    """Copies of the student's and the teacher's weights and the step count,
    on the state's device: the train step updates the live state in place,
    so a best epoch must be copied when it is found."""
    return {"model": _clone(state.model), "teacher": _clone(state.teacher), "step": int(state.step)}


def _to_cpu(sd: Optional[Dict[str, torch.Tensor]]):
    return None if sd is None else {k: v.detach().cpu() for k, v in sd.items()}


def save_checkpoint(path: str, state: TrainState, metadata: Optional[Dict] = None,
                    weights: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state`` (or, when ``weights`` is a :func:`snapshot`, those
    weights without optimizer or generator state) with ``metadata``, atomically."""
    if weights is None:
        payload = {
            "model": _to_cpu(state.model.state_dict()),
            "teacher": _to_cpu(None if state.teacher is None else state.teacher.state_dict()),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "gen": state.gen.get_state(),
        }
    else:
        payload = {"model": _to_cpu(weights["model"]), "teacher": _to_cpu(weights["teacher"]),
                   "optimizer": None, "step": int(weights["step"]), "gen": None}
    payload["metadata"] = metadata or {}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(state: TrainState, payload: Dict[str, Any]) -> TrainState:
    """Load a checkpoint into ``state`` in place: the weights, and where the
    checkpoint has them the optimizer and generator states, so that a
    resumed run continues the same random stream."""
    state.model.load_state_dict(payload["model"])
    if state.teacher is not None and payload["teacher"] is not None:
        state.teacher.load_state_dict(payload["teacher"])
    if payload.get("optimizer") is not None:
        state.optimizer.load_state_dict(payload["optimizer"])
    if payload.get("gen") is not None:
        state.gen.set_state(payload["gen"])
    state.step = int(payload["step"])
    return state


def overlay_params(module: torch.nn.Module, loaded: Dict[str, torch.Tensor]) -> None:
    """Load the entries of ``loaded`` that ``module`` has, keeping its own
    values for the rest: the partial teacher init of a checkpoint that lacks
    some parameters (a ``mhim_pure`` teacher has no Merge; reference
    modules/__init__.py:190-207)."""
    own = module.state_dict()
    module.load_state_dict({k: v for k, v in loaded.items() if k in own}, strict=False)
