"""The kernel gate's probe (port of the kernel ``k`` of ``_PROBE_SRC`` in
``mhim_mil_tpu/utils/pallas_gate.py``).

**K6** :func:`probe`: ``o = x + 1`` over an fp32 tensor, by the CUDA kernel
of ``csrc/probe.cu``; ``probe.launches`` counts the launches. The gate runs
it to prove that the card builds and runs the port's kernels, so unlike the
other wrappers it has no plain fallback: a CPU tensor raises, since adding
one on the CPU would prove nothing about the card. :func:`probe_plain` is
its function in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..kernels import load_library
from ..kernels.launch import check, raise_on

Tensor = torch.Tensor


def probe_plain(x: Tensor) -> Tensor:
    """K6's function: ``x + 1``."""
    return x + 1.0


def probe(x: Tensor) -> Tensor:
    """``x + 1`` by K6 on the card. ``x`` is a contiguous fp32 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"probe launches K6 on the card; got a tensor on {x.device}")
    check("x", x, x.shape, x.device, contiguous=True)
    if x.numel() == 0:
        raise ValueError("probe needs at least one element")
    lib = load_library("probe")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.probe(x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(err, "probe")
    probe.launches += 1
    return out


probe.launches = 0
