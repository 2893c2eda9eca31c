"""Checks shared by the kernel wrappers in ``mhim_mil_torch/ops``."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def on_cpu(*ts: Tensor) -> bool:
    """True when every tensor is on the CPU (the wrapper runs the plain
    version), False when every one is on CUDA (it launches the kernel);
    raises on any other mix: there is no fallback."""
    if all(t.device.type == "cpu" for t in ts):
        return True
    if all(t.device.type == "cuda" for t in ts):
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted({str(t.device) for t in ts})}")


def check(name: str, t: Tensor, shape, device, contiguous: bool = False, dtype=torch.float32):
    """Raise unless ``t`` has this dtype, shape and device and a unit last stride."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device or t.dtype not in dtypes or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want {dtypes} {tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have a unit stride on its last axis")


def rows_aligned(t: Tensor, nbytes: int = 16) -> bool:
    """True when ``t`` has a unit last stride and every row (its last axis)
    starts on ``nbytes`` bytes, as 16-byte ``cp.async`` copies of whole rows
    need."""
    per = nbytes // t.element_size()
    return t.stride(-1) == 1 and not t.data_ptr() % nbytes and not any(s % per for s in t.stride()[:-1])


def check_rows_aligned(name: str, t: Tensor, nbytes: int = 16):
    """Raise unless every row of ``t`` (its last axis) starts on ``nbytes`` bytes."""
    if not rows_aligned(t, nbytes):
        raise ValueError(f"{name}: rows must start on {nbytes} bytes (pointer and strides), got "
                         f"offset {t.data_ptr() % nbytes} and strides {t.stride()}")


def raise_on(err: int, fn: str):
    """Raise on a nonzero CUDA error code returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
