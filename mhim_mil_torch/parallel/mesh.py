"""Data parallelism over bags and sequence parallelism over instances on
``torch.distributed`` (port of ``mhim_mil_tpu/parallel/mesh.py``).

JAX lays a batch over a ``(dp, sp)`` device mesh and lets GSPMD insert the
collectives, so that a sharded step computes the same global-batch function
as the unsharded one. Here each rank is one process; rank ``r`` sits at
``(r // sp, r % sp)`` of the mesh, as JAX reshapes its devices. It holds
``B / dp`` of the batch's bags (the ``dp`` axis) and, of each bag, one
contiguous block of the instances (the ``sp`` axis, :meth:`Mesh.instances`:
blocks of ``N // sp`` or one more, never padded). The places
where the step couples bags or instances call the collectives below
themselves:

- the pseudo-inverse's initial scale, a max over the whole batch
  (``ops/nystrom.py`` ``pinv_start``): :func:`batch_max`;
- the weight sums of the losses (``engine/losses.py`` ``_wmean``: the
  criterion, DSMIL's instance loss, DTFD's pseudo-bag loss, the survival
  loss, MHIM's consistency loss with MHIM-dsmil's per-class terms), of
  the Merge's ``global_q_mm`` EMA (``models/merge.py``) and CLAM's count
  of the bags its instance loss averages over (``models/clam.py``):
  :func:`batch_sum`, each bag counted on the sp rank that holds its first
  token (:func:`owner_weight`);
- every random draw of the step (dropout, mining, the merge split): each
  rank draws the global shape and keeps its rows and, along a sharded
  instance axis, its columns (:func:`rand_rows`), so that a mesh run draws
  what a one-process run draws;
- the gradients, summed over the dp·sp ranks before the optimizer
  (:func:`all_reduce_grads`); the weights, buffers (IBMIL's confounder
  bank, Merge's ``global_q``) and optimizer state, broadcast from rank 0
  before the first step (:func:`replicate_tree`);
- the evaluation's logits (:func:`gather_rows`, over a dp column);
- along the instance axis, over an sp row: sums and maxes
  (:func:`sp_sum`, :func:`sp_max`; the landmark means, the softmaxes over
  the instances, K1's partial statistics, the attention pools, the masked
  means), the differentiable max of maxmil's and DSMIL's instance logits
  (:func:`sp_amax`, ties split over the row), the first argmax (DSMIL's
  critical instances, DTFD's ``MaxS``/``MaxMinS`` picks, :func:`sp_argmax`)
  and the pick of chosen rows from their owners (:func:`sp_pick`: those
  instances and CLAM's top-k), the gather of a small tensor
  (:func:`sp_gather`: the mining scores and masks, CLAM's attention
  logits, DTFD's valid counts a block, RRT-MIL's mask and region
  summaries), the halo of a convolution along the sequence
  (:func:`sp_halo`: the value residual, PPEG, PEG), the move of kept
  instances to their compacted blocks, of a bag's instances to the bands
  of its 2D grid or to RRT-MIL's regions and back, and of a sequence to
  SRMamba's permuted layout (:func:`sp_scatter`, which holds the whole moved
  sequence on every rank: see its note), and the state a linear
  recurrence carries from block to block (:func:`sp_carry`: the Mamba
  scans).

The layout of a sharded instance axis is a :class:`Seq`: every sp rank's
block length, known to every rank. A model's entry point reads it from the
data (:func:`seq_layout`) and derives the layouts that follow from it: the
cls token prepended on sp rank 0, compacted blocks, Merge's tokens appended
on the last rank.

**Convention for tensors that every sp rank holds** (landmarks, the
pseudo-inverse, pooled and cls features, logits): each rank's cotangent of
such a tensor is a *partial* one, and the true cotangent is their sum over
the sp row. :func:`sp_sum`'s backward is therefore an all-reduce, and a bag's
loss is counted on one sp rank only (:func:`owner_weight`), so that the sum
of the parameter gradients over the dp·sp ranks is the one-process
gradient. A sharded tensor carries its own tokens' whole cotangent.

A :class:`Mesh` does nothing until it is entered: ``with mesh:`` makes it
the :func:`active` one. Outside, :func:`active` is ``None``, no collective
runs and the code paths are those of a one-process run. The collectives are
built on ``all_reduce`` and ``broadcast`` alone, which gloo also takes on
CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

_ACTIVE: List["Mesh"] = []


def instance_blocks(n_global: int, sp: int) -> Tuple[int, ...]:
    """The block lengths of ``n_global`` instances over ``sp`` ranks:
    ``n // sp`` each, one more on the first ``n % sp`` ranks (so none is
    empty while ``n >= sp``)."""
    base, extra = divmod(n_global, sp)
    return tuple(base + (r < extra) for r in range(sp))


@dataclasses.dataclass(frozen=True)
class Seq:
    """The layout of a sharded instance axis over an sp row: ``counts[r]``
    tokens on sp rank ``r``, contiguous and in rank order; ``index`` is this
    rank's place."""

    counts: Tuple[int, ...]
    index: int

    @property
    def total(self) -> int:
        return sum(self.counts)

    @property
    def offset(self) -> int:
        return sum(self.counts[:self.index])

    @property
    def local(self) -> int:
        return self.counts[self.index]

    @property
    def cols(self) -> slice:
        """This rank's block of a global-length axis."""
        return slice(self.offset, self.offset + self.local)

    @property
    def first(self) -> bool:
        """Whether this rank holds the sequence's first token."""
        return self.local > 0 and self.offset == 0

    def offsets(self) -> List[int]:
        return [sum(self.counts[:r]) for r in range(len(self.counts))]

    def prepend(self, k: int) -> "Seq":
        """The layout after ``k`` tokens are put in front, on sp rank 0."""
        return Seq((self.counts[0] + k,) + self.counts[1:], self.index)

    def append(self, k: int) -> "Seq":
        """The layout after ``k`` tokens are put at the end, on the last sp rank."""
        return Seq(self.counts[:-1] + (self.counts[-1] + k,), self.index)

    def reversed(self) -> "Seq":
        """The layout of the reversed sequence: the blocks in the opposite
        rank order, each reversed in place (a block flipped locally is this
        rank's block of it)."""
        return Seq(self.counts[::-1], len(self.counts) - 1 - self.index)

    @staticmethod
    def split(n_global: int, sp: int, index: int) -> "Seq":
        return Seq(instance_blocks(n_global, sp), index)


class Mesh:
    """A ``dp × sp`` layout of the first ``dp·sp`` ranks of a world of
    ``world`` processes. ``index`` is this rank's place on the ``dp`` axis
    and ``sp_index`` on the ``sp`` axis; a rank past ``dp·sp`` is
    ``idle``: it takes no batch. ``group`` is the process group of the
    mesh's ranks, ``sp_group`` that of this rank's sp row and ``dp_group``
    that of its dp column (None without ``torch.distributed``: then the
    collectives return their input)."""

    def __init__(self, dp: int, sp: int, world: int, rank: int, group=None, sp_group=None, dp_group=None):
        self.dp, self.sp, self.world, self.rank, self.group = dp, sp, world, rank, group
        self.sp_group, self.dp_group = sp_group, dp_group

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def idle(self) -> bool:
        return self.rank >= self.dp * self.sp

    @property
    def index(self) -> Optional[int]:
        return None if self.idle else self.rank // self.sp

    @property
    def sp_index(self) -> Optional[int]:
        return None if self.idle else self.rank % self.sp

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous block of ``n_global`` rows, as ``P("dp")``
        lays them out."""
        if n_global % self.dp:
            raise ValueError(f"a batch of {n_global} bags does not split over dp={self.dp} ranks")
        n = n_global // self.dp
        return slice(self.index * n, (self.index + 1) * n)

    def instances(self, n_global: int) -> slice:
        """This rank's contiguous block of ``n_global`` instances along the
        ``sp`` axis (:func:`instance_blocks`)."""
        return Seq.split(n_global, self.sp, self.sp_index).cols

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


def active_sp() -> Optional[Mesh]:
    """The active mesh when it splits the instances (``sp > 1``), else None."""
    mesh = active()
    return mesh if mesh is not None and mesh.sp > 1 else None


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(dp: int = -1, sp: int = 1, world: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """(dp × sp) mesh over the first ``dp·sp`` ranks; ``dp=-1`` uses all
    the ranks left on the bag axis. ``world`` and ``rank`` default to those
    of the initialised process group (1 and 0 without one). Under a process
    group every rank must call it: it makes the mesh's groups (with
    ``sp > 1``, one for each sp row and each dp column)."""
    init = _initialized()
    world = (dist.get_world_size() if init else 1) if world is None else world
    rank = (dist.get_rank() if init else 0) if rank is None else rank
    if dp == -1:
        dp = world // sp
    if dp * sp > world:
        raise ValueError(f"mesh {dp}x{sp} needs {dp*sp} devices, have {world}")
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh {dp}x{sp} holds no device")
    group = sp_group = dp_group = None
    if init:
        group = dist.group.WORLD if dp * sp == dist.get_world_size() else dist.new_group(list(range(dp * sp)))
        if sp > 1:  # every rank makes every group, in the same order
            for i in range(dp):
                g = group if dp == 1 else dist.new_group([i * sp + j for j in range(sp)])
                if rank // sp == i:
                    sp_group = g
            for j in range(sp):
                g = dist.new_group([i * sp + j for i in range(dp)])
                if rank < dp * sp and rank % sp == j:
                    dp_group = g
        else:
            dp_group = group
    return Mesh(dp, sp, world, rank, group, sp_group, dp_group)


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
    """This rank's part of a host batch (numpy arrays or tensors), as
    :func:`batch_pspecs` lays it out: the contiguous block of ``B / dp``
    rows of every array and, with ``shard_instances`` on an ``sp > 1``
    mesh, the block of the instances (:meth:`Mesh.instances`) of
    ``feats``, ``mask`` and ``pos``; before any copy to the card. Raises
    unless ``dp`` divides ``B``."""
    specs = batch_pspecs(shard_instances and mesh.sp > 1)
    out = {}
    for k, v in batch.items():
        v = v[mesh.rows(v.shape[0])]
        if specs.get(k, ("dp",))[1:2] == ("sp",):
            v = v[:, mesh.instances(v.shape[1])]
        out[k] = v
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
    (``x`` itself without one), differentiable. Under sp every rank of a
    row holds the same ``x`` and ties: the sum of their partial cotangents
    is split among the tied ranks, whose share the row sums back, which is
    the one-process gradient."""
    mesh = active()
    if mesh is None or mesh.group is None:
        return x
    return _BatchMax.apply(x, mesh.group)


def owner_weight() -> float:
    """1 on the sp rank that counts each bag's loss and Merge statistics
    (sp rank 0, which holds the cls token), 0 on the other ranks of its sp
    row; 1 without an sp mesh."""
    mesh = active_sp()
    return 1.0 if mesh is None or mesh.sp_index == 0 else 0.0


def rand_rows(shape, gen: Optional[torch.Generator], device, seq: Optional[Seq] = None,
              dim: int = 1) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen``; under the active mesh the draw of
    the global shape ``[B·dp, ...]``, of which this rank keeps its rows,
    and, given the layout ``seq`` of the sharded instance axis ``dim``, the
    draw's length ``seq.total`` there, of which it keeps its block."""
    mesh = active()
    if mesh is None:
        return torch.rand(shape, generator=gen, device=device)
    shape = list(shape)
    shape[0] *= mesh.dp
    if seq is not None:
        dim = dim % len(shape)
        if shape[dim] != seq.local:
            raise ValueError(f"a draw of {shape[dim]} instances for a block of {seq.local}")
        shape[dim] = seq.total
    full = torch.rand(shape, generator=gen, device=device)
    full = full[mesh.rows(shape[0])]
    return full if seq is None else full.narrow(dim, seq.offset, seq.local)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global ``[B·dp, ...]`` tensor (``x`` itself
    without a mesh)."""
    mesh = active()
    return x if mesh is None else x[mesh.rows(x.shape[0])]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global ``[B·dp, ...]`` tensor on every rank from each rank's
    ``[B, ...]`` rows (``x`` itself without a mesh): a zeroed buffer, this
    rank's rows written in, summed over the rank's dp column (the ranks of
    an sp row hold the same rows)."""
    mesh = active()
    if mesh is None or mesh.dp_group is None:
        return x
    b = x.shape[0]
    out = x.new_zeros((b * mesh.dp,) + tuple(x.shape[1:]))
    out[mesh.index * b:(mesh.index + 1) * b] = x
    dist.all_reduce(out, group=mesh.dp_group)
    return out


def all_reduce_grads(model: Union[nn.Module, Iterable[torch.Tensor]]) -> int:
    """Sum every parameter's gradient over the dp·sp ranks of the active
    mesh, one all-reduce over a flat buffer for each dtype; a parameter
    without a gradient counts a zero one, as the optimizer does. Returns the
    bytes reduced (0 without a mesh, when nothing runs)."""
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


# ---- the collectives along the instance axis (an sp row) -----------------------------------

SP_BYTES = [0]  # bytes the sp collectives have reduced since the last reset (``SP_BYTES[0] = 0``)


def _reduced(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """``t`` all-reduced over ``group`` (a new tensor): bools and integers
    travel as fp64 (exact below 2**53) and 16-bit floats as fp32, which
    every backend reduces on CUDA tensors too."""
    wire = (torch.float32 if t.dtype in (torch.float16, torch.bfloat16)
            else t.dtype if t.is_floating_point() else torch.float64)
    y = t.detach().to(wire, copy=True).contiguous()
    if group is not None:
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op is None else op, group=group)
        SP_BYTES[0] += y.numel() * y.element_size()
    return y if wire == t.dtype else (y != 0 if t.dtype == torch.bool else y.to(t.dtype))


def seq_layout(n_local: int, device) -> Optional[Seq]:
    """The layout of a sharded instance axis whose block on this rank has
    ``n_local`` tokens: every sp rank's count, in one all-reduce. None
    without an sp mesh. Raises unless every block holds a token: the
    collectives' backwards run on the ranks whose graph reaches them, so
    that every rank's graph must have the same shape."""
    mesh = active_sp()
    if mesh is None:
        return None
    c = torch.zeros(mesh.sp, dtype=torch.int64, device=device)
    c[mesh.sp_index] = n_local
    seq = Seq(tuple(int(v) for v in _reduced(c, mesh.sp_group).tolist()), mesh.sp_index)
    if min(seq.counts) < 1:
        raise ValueError(f"instance blocks {seq.counts}: every sp rank must hold at least one instance "
                         f"(a bag of {seq.total} over sp={mesh.sp})")
    return seq


class _SpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


def sp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active sp row (``x`` itself without one),
    differentiable: its backward sums the partial cotangents of the result
    (the convention of the module's docstring)."""
    mesh = active_sp()
    if mesh is None:
        return x
    return _SpSum.apply(x, mesh.sp_group)


def sp_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the active sp row, without a
    gradient (a softmax's shift; ``x`` detached without an sp mesh)."""
    mesh = active_sp()
    if mesh is None:
        return x.detach()
    return _reduced(x, mesh.sp_group, dist.ReduceOp.MAX)


def _row_ties(count: torch.Tensor, group) -> torch.Tensor:
    """The row's count of the entries tied at a max, from each rank's."""
    return _reduced(count, group)


class _SpAmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        top = _reduced(x.amax(dim, keepdim=True), group, dist.ReduceOp.MAX)
        hit = x.detach() == top
        ctx.save_for_backward(hit, _row_ties(hit.sum(dim, keepdim=True), group))
        ctx.dim, ctx.group = dim, group
        return top.squeeze(dim)

    @staticmethod
    def backward(ctx, g):
        hit, count = ctx.saved_tensors
        g = _reduced(g, ctx.group).unsqueeze(ctx.dim)
        return torch.where(hit, g / count.to(g.dtype), torch.zeros((), dtype=g.dtype, device=g.device)), None, None


def sp_amax(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The max of ``x`` over its instance axis ``dim``, sharded over the
    active sp row (``x.amax(dim)`` without one), differentiable: the row's
    summed cotangent is split evenly among the entries tied at the max over
    the whole row (each rank divides by the row's count of ties), as JAX's
    ``reduce_max`` and one ``amax`` split it."""
    mesh = active_sp()
    if mesh is None:
        return x.amax(dim)
    return _SpAmax.apply(x, dim % x.dim(), mesh.sp_group)


def sp_argmax(x: torch.Tensor, seq: Optional[Seq], dim: int = 1) -> torch.Tensor:
    """The global index of the largest entry of ``x`` along its instance
    axis ``dim``, sharded over the active sp row in the layout ``seq``; among
    equal entries the lowest global index, as ``jnp.argmax`` and
    ``torch.argmax`` break ties. The same on every rank (``x.argmax(dim)``
    without an sp mesh). Two all-reduces of the result's size."""
    mesh = active_sp()
    if mesh is None or seq is None:
        return x.argmax(dim)
    dim = dim % x.dim()
    x = x.detach()
    top = _reduced(x.amax(dim, keepdim=True), mesh.sp_group, dist.ReduceOp.MAX)
    shape = [1] * x.dim()
    shape[dim] = seq.local
    pos = torch.arange(seq.offset, seq.offset + seq.local, device=x.device).view(shape)
    first = torch.where(x == top, pos, seq.total).amin(dim)
    return _reduced(first, mesh.sp_group, dist.ReduceOp.MIN)


class _SpPick(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, seq, group):
        local = idx - seq.offset
        own = ((local >= 0) & (local < seq.local))[..., None]
        at = local.clamp(0, seq.local - 1)[..., None].expand(-1, -1, x.shape[-1])
        ctx.save_for_backward(at, own)
        ctx.n, ctx.group = x.shape[1], group
        rows = torch.gather(x, 1, at)
        return _reduced(torch.where(own, rows, torch.zeros((), dtype=x.dtype, device=x.device)), group)

    @staticmethod
    def backward(ctx, g):
        at, own = ctx.saved_tensors
        g = torch.where(own, _reduced(g, ctx.group), torch.zeros((), dtype=g.dtype, device=g.device))
        dx = g.new_zeros((g.shape[0], ctx.n, g.shape[-1])).scatter_add_(1, at, g)
        return dx, None, None, None


def sp_pick(x: torch.Tensor, idx: torch.Tensor, seq: Optional[Seq]) -> torch.Tensor:
    """The rows ``idx[B, K]`` (global instance indices, the same on every
    rank) of ``x[B, n, D]``, this rank's block of a sequence sharded over the
    active sp row in the layout ``seq``: ``[B, K, D]`` on every rank. Each
    rank fills the rows it owns, and one all-reduce combines them.
    Differentiable: the backward sums the row's partial cotangents and sends
    each picked row's to its owner, as :func:`sp_sum`'s does. Without an sp
    mesh, ``torch.gather``."""
    mesh = active_sp()
    if mesh is None or seq is None:
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return _SpPick.apply(x, idx.long(), seq, mesh.sp_group)


def sp_first(x: torch.Tensor, seq: Seq) -> torch.Tensor:
    """The value of ``x`` on the sp rank that holds the sequence's first
    token, on every rank of the row (``x`` there, zeros elsewhere, summed),
    differentiable. Every rank passes an ``x`` of the same shape in the
    graph (a rank's own first token), so that each runs the backward's
    all-reduce."""
    if active_sp() is None:
        return x
    return sp_sum(torch.where(torch.tensor(seq.first, device=x.device), x, torch.zeros((), dtype=x.dtype,
                                                                                       device=x.device)))


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *unused):
        ctx.unused = [(u.shape, u.dtype, u.device) for u in unused]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.unused))


def sp_join(x: torch.Tensor, *unused: torch.Tensor) -> torch.Tensor:
    """``x`` itself, with the tensors ``unused`` (which this rank holds but
    does not use, such as Merge's tokens off the last rank) tied into its
    graph with a zero cotangent: the backward then reaches the collectives
    that made them on every rank of the row, as it must."""
    unused = tuple(u for u in unused if u.requires_grad)
    if not unused or not torch.is_grad_enabled():
        return x
    return _Join.apply(x, *unused)


class _SpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, dim, group):
        ctx.seq, ctx.dim, ctx.group = seq, dim, group
        shape = list(x.shape)
        shape[dim] = seq.total
        buf = x.new_zeros(shape)
        buf.narrow(dim, seq.offset, seq.local).copy_(x)
        return _reduced(buf, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group).narrow(ctx.dim, ctx.seq.offset, ctx.seq.local), None, None, None


def sp_gather(x: torch.Tensor, seq: Optional[Seq], dim: int = 1) -> torch.Tensor:
    """The whole instance axis ``dim`` of a small tensor (a ``[B, N]``
    score or mask) on every rank of the sp row, from each rank's block
    (``x`` itself without an sp mesh or layout). Differentiable."""
    mesh = active_sp()
    if mesh is None or seq is None:
        return x
    return _SpGather.apply(x, seq, dim % x.dim(), mesh.sp_group)


def _halo_windows(seq: Seq, left: int, right: int):
    """For each sp rank s and each side, the part of its halo window that
    this rank's block holds: ``(s, buffer start, local start, length)``."""
    me, n = seq.offset, seq.local
    out = []
    for s, (off, cnt) in enumerate(zip(seq.offsets(), seq.counts)):
        for lo, hi, base in ((off - left, off, 0), (off + cnt, off + cnt + right, left)):
            a, b = max(lo, me), min(hi, me + n)
            if a < b:
                out.append((s, base + a - lo, a - me, b - a))
    return out


class _SpHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, left, right, group):
        ctx.seq, ctx.left, ctx.right, ctx.group = seq, left, right, group
        b, n = x.shape[:2]
        buf = x.new_zeros((len(seq.counts), b, left + right) + tuple(x.shape[2:]))
        for s, at, src, ln in _halo_windows(seq, left, right):
            buf[s, :, at:at + ln] = x[:, src:src + ln]
        mine = _reduced(buf, group)[seq.index]
        return torch.cat([mine[:, :left], x, mine[:, left:]], dim=1)

    @staticmethod
    def backward(ctx, g):
        seq, left, right = ctx.seq, ctx.left, ctx.right
        n = seq.local
        buf = g.new_zeros((len(seq.counts), g.shape[0], left + right) + tuple(g.shape[2:]))
        buf[seq.index, :, :left] = g[:, :left]
        buf[seq.index, :, left:] = g[:, left + n:]
        buf = _reduced(buf, ctx.group)
        dx = g[:, left:left + n].clone()
        for s, at, src, ln in _halo_windows(seq, left, right):
            dx[:, src:src + ln] += buf[s, :, at:at + ln]
        return dx, None, None, None, None


def sp_halo(x: torch.Tensor, seq: Seq, left: int, right: int) -> torch.Tensor:
    """``x[B, n, ...]``, this rank's block of a sharded sequence, with the
    ``left`` tokens before it and the ``right`` tokens after it in the
    whole sequence (zeros past either end), ``[B, left + n + right, ...]``:
    what a convolution along the sequence reads across block edges. The
    windows may reach past a neighbouring block. Differentiable."""
    mesh = active_sp()
    if mesh is None:
        raise RuntimeError("sp_halo needs an active sp mesh")
    return _SpHalo.apply(x, seq, left, right, mesh.sp_group)


class _SpScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pos, keep, length, out, group):
        b, _, d = x.shape
        idx = torch.where(keep, pos, length)[..., None].expand(-1, -1, d)  # the others into a spare slot
        ctx.save_for_backward(idx)
        ctx.length, ctx.out, ctx.group = length, out, group
        buf = x.new_zeros((b, length + 1, d)).scatter_(1, idx, x)[:, :length]
        return _reduced(buf, group)[:, out.cols]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, _, d = g.shape
        buf = g.new_zeros((b, ctx.length + 1, d))
        buf[:, ctx.out.cols] = g
        buf[:, :ctx.length] = _reduced(buf[:, :ctx.length], ctx.group)
        return torch.gather(buf, 1, idx), None, None, None, None, None


def sp_scatter(x: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor, length: int, out: Seq) -> torch.Tensor:
    """Move this rank's tokens ``x[B, n, D]`` where ``keep`` to their
    positions ``pos[B, n]`` of a new sequence of ``length`` tokens laid out
    as ``out``; returns this rank's block of it, zero where no token landed.
    One all-reduce of the ``[B, length, D]`` sequence. Differentiable.

    A known limit of building on ``all_reduce`` alone: every sp rank holds
    and sends the whole compacted sequence, so the memory of a compaction
    grows with the bag (``B·length·D``) and not with the rank's block, and
    the bytes are the whole sequence's. A reduce-scatter over NCCL (or one
    all-reduce for each destination block, into a buffer of that block's
    size) would hold a block only; ROADMAP lists it as a perf item."""
    mesh = active_sp()
    if mesh is None:
        raise RuntimeError("sp_scatter needs an active sp mesh")
    return _SpScatter.apply(x, pos.long(), keep.bool(), length, out, mesh.sp_group)


def sp_carry(decay: torch.Tensor, state: torch.Tensor, seq: Seq) -> torch.Tensor:
    """The state entering this rank's block of a linear recurrence
    ``h ← a·h + u`` whose steps are sharded over the active sp row in the
    order of ``seq`` (``seq.index`` is this rank's place; a reversed layout
    runs from the last rank to the first). Each rank gives its block's
    ``decay`` (the product of ``a`` over the block) and ``state`` (its last
    h from zero), of one shape; one gather of the pairs, then the fold
    ``h_k = decay_{k-1}·h_{k-1} + state_{k-1}`` from ``h_0 = 0`` in place
    order. Differentiable. At place 0 the result is zeros that still
    depend on the gather: a rank that uses nothing of it ties it into its
    graph (:func:`sp_join`), so that the gather's backward runs on every
    rank."""
    if active_sp() is None:
        raise RuntimeError("sp_carry needs an active sp mesh")
    n = len(seq.counts)
    pairs = sp_gather(torch.stack([decay, state])[None], Seq((1,) * n, seq.index), 0)
    carry = pairs[0, 1] * 0.0
    for j in range(seq.index):
        carry = pairs[j, 0] * carry + pairs[j, 1]
    return carry
