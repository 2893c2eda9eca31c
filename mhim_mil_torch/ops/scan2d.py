"""Fused separable 2D selective scan (port of ``mhim_mil_tpu/ops/pallas_scan2d.py``).

**K5** :func:`selective_scan_2d_fused`: Ā = exp(Δ·(−exp(A_log))), the
horizontal scan of B̄x along each row, the vertical step against the row
above and the contraction with C, in one kernel (``csrc/scan2d.cu``) that
keeps Ā, B̄x, u and h out of device memory. It launches the kernel on CUDA
tensors and runs :func:`scan2d_plain` on CPU tensors;
``selective_scan_2d_fused.launches`` counts its calls on the card. It is
the ``torch.library`` op ``torch.ops.mhim_mil_torch.scan2d`` (a CPU and a
CUDA kernel and a fake), so that ``torch.export`` traces it. The
kernel is built for state sizes 2, 4, 8 and 16; :func:`state_groups` takes
any other. No gradient: the training path keeps the differentiable plain
scan, as in the JAX package.

**K5 with a carried state** :func:`scan2d_carry`, the op
``torch.ops.mhim_mil_torch.scan2d_carry(x, delta, A_log, B, C, D, h0) ->
(y, h_last)`` (the C entry ``scan2d_carry``): the same kernels started from
``h0[Bs, W, ED, N]`` (fp32, the vertical state entering the first row;
None: zero) that also write the last row's state ``h_last`` (same shape).
Its CPU kernel is :func:`scan2d_carry_plain`. The ``scan2d`` op and its
six-argument schema are unchanged. :func:`selective_scan_2d_fused_sharded`
scans a grid whose rows are split into bands over an sp row with it: one
launch from zero on each band, the state entering each band folded from the
bands above (``parallel/mesh.sp_carry``), and a second launch from that
state on every band but the first. No gradient either.

:func:`scan_plan` lays the cluster kernel out: blocks of G channels, each
thread walking a run of 3 columns with all N states, a row split across a
cluster of S ≤ 8 blocks of at most 128 threads (192 for rows past 768
columns). Rows wider than such a cluster holds (more than 1,152 columns)
take the wide kernel, one block per (bag, channel) and one thread per
column of 512-column chunks, whose h beyond 1,024 columns lives in shared
memory or in a scratch buffer allocated here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import load_library
from ..kernels.launch import check, on_cpu, raise_on
from ..parallel.mesh import Seq, sp_carry
from .scan import block_decay, selective_scan_2d

Tensor = torch.Tensor
STATES = (2, 4, 8, 16)  # the state sizes the kernel is built for
RUN = 3  # R: columns a cluster-kernel thread walks, its h[R][N] in registers
MAX_CLUSTER = 8  # blocks of a cluster: the portable size
SECTOR = 32  # bytes of one cell's G channels of x or Δ that a warp reads whole
# (G, threads a block at most), tried in order: blocks of 128 threads of 168
# registers, three an SM, with G the channel groups the kernel is built for
# (16 with bf16 only); past what they hold, 4-channel blocks of 192 threads,
# two an SM at the same 168 registers
BLOCKS = ((16, 128), (8, 128), (4, 128), (4, 192))
MAX_BLOCK = max(t for _, t in BLOCKS)
WIDEST = MAX_CLUSTER * RUN * BLOCKS[-1][1] // BLOCKS[-1][0]  # 1,152: wider rows take the wide kernel


def scan2d_plain(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor) -> Tensor:
    """K5's function: the separable :func:`selective_scan_2d` with
    ``A = −exp(A_log)`` taken in fp32. fp32 ``y + D·x`` out."""
    return selective_scan_2d(x, delta, -torch.exp(A_log.float()), B, C, D)


def scan2d_carry_plain(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor,
                       h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """K5's function with a carried state: :func:`scan2d_plain` from the
    vertical state ``h0[Bs, W, ED, N]`` (None: zero); ``(y, h_last)``, both fp32."""
    return selective_scan_2d(x, delta, -torch.exp(A_log.float()), B, C, D, h0=h0, return_state=True)


def state_groups(call, x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor,
                 h0: Optional[Tensor] = None, carry: bool = False):
    """``call(x, delta, A_log, B, C, D)`` at the state sizes of :data:`STATES`.
    The states of a separable scan are independent, so they go in groups of
    at most 16, one call each, whose ``y`` are summed in fp32, with ``D``
    given to the first group only (zeros to the rest). A group of another
    size is padded up to the next of :data:`STATES` with zero B and C
    columns and ``A_log`` 0: a state with B = 0 stays 0, and one with C = 0
    adds nothing. A group's B and C are slices of the last axis, views where
    no padding is needed.

    With ``carry``, ``call`` also takes the group's slice of ``h0`` (padded
    with zero states; None stays None) and returns ``(y, h_last)``; the
    groups' ``h_last`` are joined along N, their padding cut."""
    n = A_log.shape[-1]
    if n in STATES:
        return call(x, delta, A_log, B, C, D, h0) if carry else call(x, delta, A_log, B, C, D)
    y, lasts = None, []
    for s0 in range(0, n, STATES[-1]):
        s1 = min(n, s0 + STATES[-1])
        pad = next(c for c in STATES if c >= s1 - s0) - (s1 - s0)
        part = [None if t is None else F.pad(t[..., s0:s1], (0, pad)) if pad else t[..., s0:s1]
                for t in (A_log, B, C, h0)]
        d = D if s0 == 0 else torch.zeros_like(D)
        if carry:
            yg, last = call(x, delta, *part[:3], d, part[3])
            lasts.append(last[..., :s1 - s0])
        else:
            yg = call(x, delta, *part[:3], d)
        y = yg if y is None else y + yg
    return (y, torch.cat(lasts, -1)) if carry else y


@dataclass(frozen=True)
class ScanPlan:
    """The cluster kernel's layout: ``group`` channels a block (G),
    ``cluster`` blocks a row (S), ``runs`` runs of ``run`` consecutive
    columns for each channel of a block (P and R). Thread (j, g) walks
    columns ``seg·P·R + j·R + k``, k < R, of channel ``g``."""

    group: int
    cluster: int
    runs: int
    run: int = RUN

    @property
    def threads(self) -> int:
        return self.group * self.runs

    @property
    def columns(self) -> int:
        """Columns of one block: its segment of the row."""
        return self.runs * self.run

    def blocks(self, bs: int, ed: int) -> int:
        return bs * -(-ed // self.group) * self.cluster


def scan_plan(w: int, n: int, itemsize: int) -> ScanPlan | None:
    """The cluster kernel's layout for rows ``w`` columns wide, state size
    ``n`` (one of :data:`STATES`) and inputs of ``itemsize`` bytes, or None
    when the row is wider than a cluster holds (more than 1,152 columns:
    the wide kernel takes it).

    A thread walks R = 3 columns with all N states, so a row is ⌈w/3⌉ runs a
    channel. A block has at most 128 threads (G·P) of 168 registers, so that
    three fit an SM and an H100 holds 45 clusters of 8 at once. G is
    the largest channel group, up to 32 / itemsize (one 32-byte sector
    of a cell: 8 fp32, 16 bf16 channels), whose blocks of 128 / G runs cover
    the row in at most 8 blocks: 8 fp32 (16 bf16) channels up to 384 (192)
    columns, then 8 and 4 channels up to 384 and 768; past 768 columns,
    4 channels in blocks of up to 192 threads (:data:`BLOCKS`), up to 1,152.
    S is then the fewest blocks of a whole number of warps that cover the
    row, so no block is empty."""
    if n not in STATES:
        raise ValueError(f"state size {n}: the kernel is built for {STATES}")
    runs = -(-w // RUN)
    for group, threads in BLOCKS:
        if group * itemsize > SECTOR:
            continue
        cluster = -(-runs // (threads // group))
        if cluster <= MAX_CLUSTER:
            step = 32 // group  # runs of one warp
            per = -(-(-(-runs // cluster)) // step) * step
            return ScanPlan(group, -(-runs // per), per)
    return None


def _cell_stride(t: Tensor, h: int, w: int):
    """``t[Bs, H, W, N]`` and the stride between its cells: a view whose
    cells are evenly spaced (a slice of a wider last axis) is kept, any
    other layout copied."""
    cs = t.stride(2)
    if t.stride(-1) != 1 or t.stride(1) != w * cs or t.stride(0) != h * w * cs:
        t = t.contiguous()
        cs = t.stride(2)
    return t, cs


def selective_scan_2d_fused(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor,
                            D: Tensor) -> Tensor:
    """The separable 2D selective scan in the JAX layout: ``x``, ``delta``
    (post-softplus) ``[Bs, H, W, ED]``, ``A_log`` ``[ED, N]``, ``B``, ``C``
    ``[Bs, H, W, N]``, ``D`` ``[ED]``. ``x``, ``delta``, ``B`` and ``C`` are
    all fp32 or all bf16 (read in that type, computed in fp32). Returns fp32
    ``y[Bs, H, W, ED]`` with ``D·x`` added. Any grid: rows up to what a
    cluster holds (1,152 columns, :func:`scan_plan`) take the cluster kernel;
    wider rows the wide kernel, which keeps the h of columns beyond the first 1,024 in
    shared memory, or in a scratch buffer allocated here where that does not
    fit (about 4,000 columns at N = 16). Any state size N ≥ 1
    (:func:`state_groups`: one launch for N ≤ 16, ⌈N/16⌉ above)."""
    if not on_cpu(x, delta, A_log, B, C, D) and torch.is_grad_enabled() \
            and any(t.requires_grad for t in (x, delta, A_log, B, C, D)):
        raise RuntimeError("selective_scan_2d_fused has no gradient; use the plain scan under grad")
    return torch.ops.mhim_mil_torch.scan2d(x, delta, A_log, B, C, D)


@torch.library.custom_op("mhim_mil_torch::scan2d", mutates_args=(), device_types=("cpu", "cuda"),
                         schema="(Tensor x, Tensor delta, Tensor A_log, Tensor B, Tensor C, Tensor D) -> Tensor")
def _scan2d_op(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor) -> Tensor:
    if on_cpu(x, delta, A_log, B, C, D):
        return scan2d_plain(x, delta, A_log, B, C, D)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if A_log.shape[-1] < 1:
        raise ValueError("state size 0: the scan needs at least one state")
    y = state_groups(_launch, x.contiguous(), delta.contiguous(), A_log, B, C, D)
    selective_scan_2d_fused.launches += 1
    return y


@_scan2d_op.register_fake
def _(x, delta, A_log, B, C, D):
    return x.new_empty(x.shape, dtype=torch.float32)


def scan2d_carry(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor,
                 h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """:func:`selective_scan_2d_fused` from the vertical state ``h0[Bs, W,
    ED, N]`` entering the first row (None: zero), also returning the last
    row's state: fp32 ``(y[Bs, H, W, ED], h_last[Bs, W, ED, N])``. One call
    of the ``scan2d_carry`` op, counted in ``selective_scan_2d_fused.launches``
    on the card; the CPU runs :func:`scan2d_carry_plain`. No gradient."""
    if not on_cpu(x, delta, A_log, B, C, D) and torch.is_grad_enabled() \
            and any(t.requires_grad for t in (x, delta, A_log, B, C, D, h0) if t is not None):
        raise RuntimeError("scan2d_carry has no gradient; use the plain scan under grad")
    return torch.ops.mhim_mil_torch.scan2d_carry(x, delta, A_log, B, C, D, h0)


@torch.library.custom_op("mhim_mil_torch::scan2d_carry", mutates_args=(), device_types=("cpu", "cuda"),
                         schema="(Tensor x, Tensor delta, Tensor A_log, Tensor B, Tensor C, Tensor D, Tensor? h0)"
                                " -> (Tensor, Tensor)")
def _scan2d_carry_op(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor,
                     h0: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    if on_cpu(x, delta, A_log, B, C, D, *(() if h0 is None else (h0,))):
        return scan2d_carry_plain(x, delta, A_log, B, C, D, h0)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if A_log.shape[-1] < 1:
        raise ValueError("state size 0: the scan needs at least one state")
    y, last = state_groups(_launch_carry, x.contiguous(), delta.contiguous(), A_log, B, C, D, h0, carry=True)
    selective_scan_2d_fused.launches += 1
    return y, last


@_scan2d_carry_op.register_fake
def _(x, delta, A_log, B, C, D, h0):
    bs, _, w, ed = x.shape
    return (x.new_empty(x.shape, dtype=torch.float32),
            x.new_empty((bs, w, ed, A_log.shape[-1]), dtype=torch.float32))


def selective_scan_2d_fused_sharded(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor,
                                    rows: Seq) -> Tensor:
    """K5 on this rank's band of whole grid rows, the bands laid out over
    the active sp row as ``rows`` (the parallel form): one launch from zero
    gives the band's y and its last state; ``sp_carry`` folds the bands
    above (each band's decay ``exp(A·ΣΔ)`` over its rows and last state)
    into the state entering this band; every band but the first launches
    again from that state on the same operands, and that y is the band's.
    One launch on the first band, two on the others. No gradient."""
    y, last = scan2d_carry(x, delta, A_log, B, C, D)
    h_in = sp_carry(block_decay(delta.float().sum(1), -torch.exp(A_log.float())), last, rows)
    if rows.index == 0:
        return y
    return scan2d_carry(x, delta, A_log, B, C, D, h_in)[0]


def _launch(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor) -> Tensor:
    """One launch at a built state size, laid out by :func:`scan_plan`."""
    return _launch_carry(x, delta, A_log, B, C, D, None, last=False)[0]


def _launch_carry(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor,
                  h0: Optional[Tensor], last: bool = True) -> Tuple[Tensor, Optional[Tensor]]:
    """One launch at a built state size from ``h0`` (None: zero), laid out
    by :func:`scan_plan`: ``(y, h_last)``, h_last None unless ``last``."""
    bs, h, w, ed = x.shape
    n = A_log.shape[-1]
    dev, dtype = x.device, x.dtype
    if w < 1 or h < 1:
        raise ValueError(f"grid {h} x {w}: the kernel takes H, W >= 1")
    plan = scan_plan(w, n, x.element_size())
    lib = load_library("scan2d")
    scratch = None
    if plan is None:  # the wide kernel
        with torch.cuda.device(dev):
            per_block = lib.scan2d_scratch(w, n)
        if per_block < 0:
            raise RuntimeError(f"scan2d_scratch({w}, {n}) failed")
        # rows whose h beyond 1,024 columns does not fit a block's shared memory
        scratch = torch.empty(bs * ed * per_block, device=dev, dtype=torch.float32) if per_block else None
    B, b_cs = _cell_stride(B, h, w)
    C, c_cs = _cell_stride(C, h, w)
    A_log = A_log.detach().float().contiguous()
    D = D.detach().float().contiguous()
    check("x", x, (bs, h, w, ed), dev, contiguous=True, dtype=dtype)
    check("delta", delta, (bs, h, w, ed), dev, contiguous=True, dtype=dtype)
    check("B", B, (bs, h, w, n), dev, dtype=dtype)
    check("C", C, (bs, h, w, n), dev, dtype=dtype)
    check("A_log", A_log, (ed, n), dev)
    check("D", D, (ed,), dev)
    if h0 is not None:
        h0 = h0.detach().float().contiguous()
        check("h0", h0, (bs, w, ed, n), dev)
    y = torch.empty((bs, h, w, ed), device=dev, dtype=torch.float32)
    h_last = torch.empty((bs, w, ed, n), device=dev, dtype=torch.float32) if last else None
    g, s, p = (plan.group, plan.cluster, plan.runs) if plan else (0, 0, 0)
    with torch.cuda.device(dev):
        err = lib.scan2d_carry(
            x.data_ptr(), delta.data_ptr(), B.data_ptr(), b_cs, C.data_ptr(), c_cs,
            int(dtype == torch.bfloat16), A_log.data_ptr(), D.data_ptr(), y.data_ptr(),
            None if h0 is None else h0.data_ptr(), None if h_last is None else h_last.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            bs, h, w, ed, n, g, s, p, torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "scan2d_carry")
    return y, h_last


selective_scan_2d_fused.launches = 0
