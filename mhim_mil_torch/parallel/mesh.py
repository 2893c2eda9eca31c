"""Data parallelism over bags on ``torch.distributed`` (port of
``mhim_mil_tpu/parallel/mesh.py``).

JAX lays a batch over a ``(dp, sp)`` device mesh and lets GSPMD insert the
collectives, so that a sharded step computes the same global-batch function
as the unsharded one. Here each rank is one process holding ``B / dp`` of
the batch's bags, and the places where the step couples the bags of a batch
call the collectives below themselves:

- the pseudo-inverse's initial scale, a max over the whole batch
  (``ops/nystrom.py`` ``pinv_start``): :func:`batch_max`;
- the weight sums of the losses (``engine/losses.py`` ``_wmean``) and of
  the Merge's ``global_q_mm`` EMA (``models/merge.py``): :func:`batch_sum`;
- every random draw of the step (dropout, mining, the merge split): each
  rank draws the global shape and keeps its own rows (:func:`rand_rows`),
  so that a dp run draws what a one-process run draws;
- the gradients, summed before the optimizer (:func:`all_reduce_grads`);
- the evaluation's logits (:func:`gather_rows`).

A :class:`Mesh` does nothing until it is entered: ``with mesh:`` makes it
the :func:`active` one. Outside, :func:`active` is ``None``, no collective
runs and the code paths are those of a one-process run. Only the ``dp``
axis is split (``sp``, sequence parallelism over instances, is not ported).
The collectives are built on ``all_reduce`` and ``broadcast`` alone, which
gloo also takes on CUDA tensors.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

SP_NOT_PORTED = ("mesh_sp > 1: sequence parallelism over instances (ROADMAP Queue 1 item 6b) is not "
                 "ported yet; only data parallelism over bags (--mesh_dp) is")

_ACTIVE: List["Mesh"] = []


class Mesh:
    """A ``dp × sp`` layout of the first ``dp·sp`` ranks of a world of
    ``world`` processes. ``index`` is this rank's place on the ``dp`` axis;
    a rank past ``dp·sp`` is ``idle``: it takes no batch. ``group`` is the
    process group of the mesh's ranks (None without ``torch.distributed``:
    then the collectives return their input)."""

    def __init__(self, dp: int, sp: int, world: int, rank: int, group=None):
        self.dp, self.sp, self.world, self.rank, self.group = dp, sp, world, rank, group

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def idle(self) -> bool:
        return self.rank >= self.dp * self.sp

    @property
    def index(self) -> Optional[int]:
        return None if self.idle else self.rank // self.sp

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous block of ``n_global`` rows, as ``P("dp")``
        lays them out."""
        if n_global % self.dp:
            raise ValueError(f"a batch of {n_global} bags does not split over dp={self.dp} ranks")
        n = n_global // self.dp
        return slice(self.index * n, (self.index + 1) * n)

    def __enter__(self) -> "Mesh":
        if self.idle:
            raise ValueError(f"rank {self.rank} is not on the {self.dp}x{self.sp} mesh")
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


def active() -> Optional[Mesh]:
    """The mesh of the innermost ``with mesh:``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(dp: int = -1, sp: int = 1, world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """(dp × sp) mesh over the first ``dp·sp`` ranks; ``dp=-1`` uses all
    the ranks left on the bag axis. ``world`` and ``rank`` default to those
    of the initialised process group (1 and 0 without one). Under a process
    group every rank must call it: it makes the mesh's group."""
    init = _initialized()
    world = (dist.get_world_size() if init else 1) if world is None else world
    rank = (dist.get_rank() if init else 0) if rank is None else rank
    if dp == -1:
        dp = world // sp
    if dp * sp > world:
        raise ValueError(f"mesh {dp}x{sp} needs {dp*sp} devices, have {world}")
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh {dp}x{sp} holds no device")
    group = None
    if init:
        group = dist.group.WORLD if dp * sp == dist.get_world_size() else dist.new_group(list(range(dp * sp)))
    return Mesh(dp, sp, world, rank, group)


def batch_pspecs(shard_instances: bool = True) -> Dict[str, Tuple[Optional[str], ...]]:
    """Which mesh axis splits each axis of a MIL batch's arrays: bags over
    ``dp``, instances over ``sp`` (JAX's ``PartitionSpec`` tuples)."""
    inst = "sp" if shard_instances else None
    return {
        "feats": ("dp", inst, None),
        "mask": ("dp", inst),
        "bag_valid": ("dp",),
        "target": ("dp",),
        "censorship": ("dp",),
        "event": ("dp",),
        "pos": ("dp", inst, None),
    }


def shard_batch(mesh: Mesh, batch: Dict, shard_instances: bool = True) -> Dict:
    """This rank's bags of a host batch (numpy arrays or tensors): the
    contiguous block of ``B / dp`` rows of every array, before any copy to
    the card. Raises unless ``dp`` divides ``B``."""
    if shard_instances and mesh.sp > 1:
        raise NotImplementedError(SP_NOT_PORTED)
    out = {}
    for k, v in batch.items():
        out[k] = v[mesh.rows(v.shape[0])]
    return out


def replicate_tree(mesh: Mesh, state):
    """Broadcast rank 0's student, teacher, buffers and optimizer state (a
    ``TrainState``) to every rank of the mesh, in place; returns ``state``.
    Tensors off the model's device (Adam's step counts) are left alone:
    they count the steps, which every rank takes alike."""
    if mesh.group is None:
        return state
    mods = [m for m in (state.model, state.teacher) if m is not None]
    device = next(state.model.parameters()).device
    tensors = [t for m in mods for t in m.state_dict().values()]
    tensors += [v for s in state.optimizer.opt.state.values() for v in s.values() if torch.is_tensor(v)]
    tensors += list(state.optimizer.acc or [])
    for t in tensors:
        if t.device == device:
            dist.broadcast(t, src=0, group=mesh.group)
    return state


# ---- the collectives of a step ---------------------------------------------------------


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the active mesh (``x`` itself without
    one). No gradient flows through it."""
    mesh = active()
    if mesh is None or mesh.group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.group)
    return y


class _BatchMax(torch.autograd.Function):
    """All-reduce MAX with a gradient: the sum of every rank's incoming
    gradient goes to the ranks whose own value is the global max, split
    evenly among them, as a max over one tensor splits it among ties."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        ctx.group = group
        ctx.save_for_backward(x.detach() == y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (hit,) = ctx.saved_tensors
        both = torch.stack([grad, hit.to(grad.dtype)])
        dist.all_reduce(both, group=ctx.group)
        return torch.where(hit, both[0] / both[1], 0.0), None


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of the active mesh
    (``x`` itself without one), differentiable."""
    mesh = active()
    if mesh is None or mesh.group is None:
        return x
    return _BatchMax.apply(x, mesh.group)


def rand_rows(shape, gen: Optional[torch.Generator], device) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen``; under the active mesh the draw of
    the global shape ``[B·dp, ...]``, of which this rank keeps its rows."""
    mesh = active()
    if mesh is None:
        return torch.rand(shape, generator=gen, device=device)
    shape = tuple(shape)
    full = torch.rand((shape[0] * mesh.dp,) + shape[1:], generator=gen, device=device)
    return full[mesh.rows(full.shape[0])]


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global ``[B·dp, ...]`` tensor (``x`` itself
    without a mesh)."""
    mesh = active()
    return x if mesh is None else x[mesh.rows(x.shape[0])]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global ``[B·dp, ...]`` tensor on every rank from each rank's
    ``[B, ...]`` rows (``x`` itself without a mesh): a zeroed buffer, this
    rank's rows written in, summed over the mesh."""
    mesh = active()
    if mesh is None or mesh.group is None:
        return x
    b = x.shape[0]
    out = x.new_zeros((b * mesh.dp,) + tuple(x.shape[1:]))
    out[mesh.index * b:(mesh.index + 1) * b] = x
    dist.all_reduce(out, group=mesh.group)
    return out


def all_reduce_grads(model: Union[nn.Module, Iterable[torch.Tensor]]) -> int:
    """Sum every parameter's gradient over the active mesh, one all-reduce
    over a flat buffer for each dtype; a parameter without a gradient counts
    a zero one, as the optimizer does. Returns the bytes reduced (0 without
    a mesh, when nothing runs)."""
    mesh = active()
    if mesh is None or mesh.group is None:
        return 0
    params = list(model.parameters() if isinstance(model, nn.Module) else model)
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    nbytes = 0
    for ps in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1) for p in ps])
        dist.all_reduce(flat, group=mesh.group)
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad = g.view_as(p)
        nbytes += flat.numel() * flat.element_size()
    return nbytes
