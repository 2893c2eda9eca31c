"""Bucketed scoring of feature bags on the card (port of the scorer in
``mhim_mil_tpu/utils/serving.py``).

A request is one bag ``[N, D]`` or a batch ``[B, N, D]`` with an optional
``[B, N]`` validity mask. It is padded at the end, masked, into the smallest
instance bucket that holds it, as the training pipeline's length bucketing
does, and scored by the eval step of the model's family: ``forward_test``
for ``mhim`` and ``mhim_pure``, the model's forward on ``(feats, mask)``
for ``default``, ``dsmil`` and ``mamba2d`` (``mamba2d`` and a ``sincos``
model then lay the bag on a row-major grid, with no coordinates), as
``_infer_fn`` in the JAX package does. For ``dsmil`` the result holds
``sub_logits`` beside ``logits``, unfused, as ``_infer_fn``'s does: the
caller fuses them (``0.5·logits + 0.5·sub_logits``). Note that the bags
of one MHIM request are not independent: the Nystrom pseudo-inverse takes
its initial scale over the whole batch, so a bag's logits depend on the
bags it is batched with (as in the JAX package and the reference). No
export bundle yet: the scorer runs the model module in this process.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..engine.steps import make_eval_step, make_mhim_eval_step
from .platform import resolve_device

DEFAULT_BUCKETS = (1024, 4096, 10240)

ArrayLike = Union[np.ndarray, torch.Tensor]


class Scorer:
    """Scores bags with ``model`` of ``family`` (as ``build_model`` returns
    it) under ``cfg``'s precision policy on ``device`` (CUDA unless ``"cpu"``
    is asked for; the model must already be there)."""

    def __init__(self, cfg, model: torch.nn.Module, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device: Optional[Union[str, torch.device]] = None, family: str = "mhim"):
        self.device = resolve_device(device)
        param_dev = next(model.parameters()).device
        if param_dev.type != self.device.type:
            raise ValueError(f"model is on {param_dev}, scorer on {self.device}")
        self.buckets = sorted(int(n) for n in buckets)
        self.input_dim = int(cfg.input_dim)
        if family in ("mhim", "mhim_pure"):
            self._step = make_mhim_eval_step(cfg, model)
        else:
            self._step = make_eval_step(cfg, model, family)

    def bucket_for(self, n: int) -> int:
        for bn in self.buckets:
            if n <= bn:
                return bn
        raise ValueError(f"bag of {n} instances exceeds the largest bucket {self.buckets[-1]}")

    def score(self, feats: ArrayLike, mask: Optional[ArrayLike] = None) -> Dict[str, np.ndarray]:
        """``{"logits": [B, C]}`` (``[C]`` for one ``[N, D]`` bag), and for
        ``dsmil`` ``"sub_logits"`` of the same shape, fp32 on the host."""
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        squeeze = feats.dim() == 2
        if squeeze:
            feats = feats[None]
        bsz, n, d = feats.shape
        if d != self.input_dim:
            raise ValueError(f"feature dim {d} != input_dim {self.input_dim}")
        if mask is None:
            mask = torch.ones((bsz, n), dtype=torch.bool, device=self.device)
        else:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device).reshape(bsz, n)
        pad = self.bucket_for(n) - n
        if pad:
            feats = torch.cat([feats, feats.new_zeros((bsz, pad, d))], dim=1)
            mask = torch.cat([mask, mask.new_zeros((bsz, pad))], dim=1)
        out = self._step({"feats": feats, "mask": mask})
        res = {k: v.cpu().numpy() for k, v in out.items()}
        return {k: v[0] for k, v in res.items()} if squeeze else res
