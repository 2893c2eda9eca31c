"""Checkpoints of train states (port of ``mhim_mil_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` file holding the student's and the
teacher's ``state_dict`` (the teacher is None for a generic state without
``model_ema``), the optimizer's state, the step count, the state of the
train generator (``torch.Generator.get_state``) and free-form metadata. A
best checkpoint comes from a :func:`snapshot` of the weights at the best
epoch and holds no optimizer or generator state. Loading uses
``torch.load(weights_only=True)``.

The JAX package writes its ``.ckpt`` as a protocol-4 pickle of host numpy
flax trees (``mhim_mil_tpu/utils/checkpoint.py:23-46``). Both name their
files ``.ckpt``, so :func:`is_jax_checkpoint` tells them apart by their first
bytes, and :func:`load_jax_checkpoint` reads the pickle with an unpickler
that admits numpy's arrays and builtin containers only.
"""

from __future__ import annotations

import builtins
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..engine.steps import MHIM_FAMILIES
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


TORCH_MAGIC = b"PK\x03\x04"  # torch.save's zip archive
PICKLE4_MAGIC = b"\x80\x04"  # pickle protocol 4, as the JAX package writes


def is_jax_checkpoint(path: str) -> bool:
    """Whether ``path`` is the JAX package's pickle (True) or a
    ``torch.save`` file (False); anything else raises."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head.startswith(PICKLE4_MAGIC):
        return True
    if head == TORCH_MAGIC:
        return False
    raise ValueError(f"{path}: neither a torch.save zip nor a protocol-4 pickle (starts {head!r})")


class _Opaque:
    """Stands in for every class of optax, flax, jax or chex that a JAX
    checkpoint pickles (the optimizer's states): it takes any arguments and
    state and keeps them unread."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __setstate__(self, state):
        self.state = state


_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (mod, name) for mod in ("numpy.core.multiarray", "numpy._core.multiarray")  # numpy 1.x, 2.x
    for name in ("_reconstruct", "scalar")}
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex", "bool", "str", "bytes",
             "bytearray", "slice"}
_OPAQUE_ROOTS = {"optax", "flax", "jax", "jaxlib", "chex"}


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _NUMPY:
            if module == "numpy":
                return getattr(np, name)
            try:
                from numpy._core import multiarray
            except ImportError:  # numpy 1.x before the _core rename
                from numpy.core import multiarray
            return getattr(multiarray, name)
        if module == "builtins" and name in _BUILTINS:
            return getattr(builtins, name)
        if module.split(".")[0] in _OPAQUE_ROOTS:
            return _Opaque
        raise pickle.UnpicklingError(f"a JAX checkpoint may not name {module}.{name}")


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The JAX package's checkpoint: ``params`` and ``model_state`` as
    nested dicts of numpy arrays, and ``step``, ``metadata`` and the rest as
    pickled. The optimizer's state is opaque. Imports neither JAX, flax nor
    optax."""
    with open(path, "rb") as f:
        return _JaxCheckpointUnpickler(f).load()


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


def port_state_dict(cfg, params, model_state: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of ``cfg.model`` from a JAX checkpoint's flax
    ``params`` (and, for MHIM, the Merge buffers in its ``model_state``)."""
    from ..models.registry import load_confounders
    from . import weights

    if cfg.model in MHIM_FAMILIES:
        return weights.state_dict_from_flax(params, (model_state or {}).get("buffers"))
    if cfg.model == "ibmil":
        return weights.ibmil_state_from_flax(params, load_confounders(cfg))
    if cfg.model in ("clam_sb", "clam_mb"):
        return weights.clam_state_from_flax(params, dropout=bool(cfg.dropout))
    convert = {
        "abmil": weights.abmil_state_from_flax, "gabmil": weights.abmil_state_from_flax,
        "meanmil": weights.mean_max_state_from_flax, "maxmil": weights.mean_max_state_from_flax,
        "transmil": weights.transmil_state_from_flax, "dsmil": weights.dsmil_state_from_flax,
        "dtfd": weights.dtfd_state_from_flax, "rrtmil": weights.rrtmil_state_from_flax,
        "2dmamba": weights.mamba2d_state_from_flax, "mambamil": weights.mambamil_state_from_flax,
    }
    return convert[cfg.model](params)


def load_weights(cfg, model: torch.nn.Module, path: str, teacher: bool = False) -> None:
    """The student weights (the EMA teacher's with ``teacher``) of a port or
    JAX fold checkpoint into ``model``; raises when ``teacher`` is asked of
    a checkpoint that has none."""
    if is_jax_checkpoint(path):
        payload = load_jax_checkpoint(path)
        params = payload.get("teacher_params") if teacher else payload["params"]
        sd = None if params is None else port_state_dict(cfg, params, payload.get("model_state"))
    else:
        sd = load_checkpoint(path)["teacher" if teacher else "model"]
    if sd is None:
        raise ValueError(f"{path} holds no teacher weights")
    model.load_state_dict(sd)
