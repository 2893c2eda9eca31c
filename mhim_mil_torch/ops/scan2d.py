"""Fused separable 2D selective scan (port of ``mhim_mil_tpu/ops/pallas_scan2d.py``).

**K5** :func:`selective_scan_2d_fused`: Ā = exp(Δ·(−exp(A_log))), the
horizontal scan of B̄x along each row, the vertical step against the row
above and the contraction with C, in one kernel (``csrc/scan2d.cu``) that
keeps Ā, B̄x, u and h out of device memory. It launches the kernel on CUDA
tensors and runs :func:`scan2d_plain` on CPU tensors;
``selective_scan_2d_fused.launches`` counts its calls on the card. The
kernel is built for state sizes 2, 4, 8 and 16; :func:`state_groups` takes
any other. No gradient: the training path keeps the differentiable plain
scan, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import load_library
from ..kernels.launch import check, on_cpu, raise_on
from .scan import selective_scan_2d

Tensor = torch.Tensor
STATES = (2, 4, 8, 16)  # the state sizes the kernel is built for


def scan2d_plain(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor) -> Tensor:
    """K5's function: the separable :func:`selective_scan_2d` with
    ``A = −exp(A_log)`` taken in fp32. fp32 ``y + D·x`` out."""
    return selective_scan_2d(x, delta, -torch.exp(A_log.float()), B, C, D)


def state_groups(call, x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor) -> Tensor:
    """``call(x, delta, A_log, B, C, D)`` at the state sizes of :data:`STATES`.
    The states of a separable scan are independent, so they go in groups of
    at most 16, one call each, whose ``y`` are summed in fp32, with ``D``
    given to the first group only (zeros to the rest). A group of another
    size is padded up to the next of :data:`STATES` with zero B and C
    columns and ``A_log`` 0: a state with B = 0 stays 0, and one with C = 0
    adds nothing. A group's B and C are slices of the last axis, views where
    no padding is needed."""
    n = A_log.shape[-1]
    if n in STATES:
        return call(x, delta, A_log, B, C, D)
    y = None
    for s0 in range(0, n, STATES[-1]):
        s1 = min(n, s0 + STATES[-1])
        pad = next(c for c in STATES if c >= s1 - s0) - (s1 - s0)
        a, b, c = (F.pad(t[..., s0:s1], (0, pad)) if pad else t[..., s0:s1] for t in (A_log, B, C))
        yg = call(x, delta, a, b, c, D if s0 == 0 else torch.zeros_like(D))
        y = yg if y is None else y + yg
    return y


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
    ``y[Bs, H, W, ED]`` with ``D·x`` added. Any grid: rows wider than
    1,024 columns keep the h of their columns beyond the first 1,024 in
    shared memory, or in a scratch buffer allocated here where that does not
    fit (about 4,000 columns at N = 16). Any state size N ≥ 1
    (:func:`state_groups`: one launch for N ≤ 16, ⌈N/16⌉ above)."""
    if on_cpu(x, delta, A_log, B, C, D):
        return scan2d_plain(x, delta, A_log, B, C, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, delta, A_log, B, C, D)):
        raise RuntimeError("selective_scan_2d_fused has no gradient; use the plain scan under grad")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if A_log.shape[-1] < 1:
        raise ValueError("state size 0: the scan needs at least one state")
    y = state_groups(_launch, x.contiguous(), delta.contiguous(), A_log, B, C, D)
    selective_scan_2d_fused.launches += 1
    return y


def _launch(x: Tensor, delta: Tensor, A_log: Tensor, B: Tensor, C: Tensor, D: Tensor) -> Tensor:
    bs, h, w, ed = x.shape
    n = A_log.shape[-1]
    dev, dtype = x.device, x.dtype
    if w < 1 or h < 1:
        raise ValueError(f"grid {h} x {w}: the kernel takes H, W >= 1")
    lib = load_library("scan2d")
    with torch.cuda.device(dev):
        per_block = lib.scan2d_scratch(w, n)
    if per_block < 0:
        raise RuntimeError(f"scan2d_scratch({w}, {n}) failed")
    # rows wider than 1,024 columns whose h does not fit a block's shared memory
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
    y = torch.empty((bs, h, w, ed), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        err = lib.scan2d(
            x.data_ptr(), delta.data_ptr(), B.data_ptr(), b_cs, C.data_ptr(), c_cs,
            int(dtype == torch.bfloat16), A_log.data_ptr(), D.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            bs, h, w, ed, n, torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "scan2d")
    return y


selective_scan_2d_fused.launches = 0
