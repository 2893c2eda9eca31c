"""The ``meanmil`` / ``maxmil`` baselines (port of
``mhim_mil_tpu/models/mean_max.py``; reference modules/mean_max.py:14-60).

The instance head runs on every padded instance; the pooling of its logits
counts the valid ones only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.masked import masked_max, masked_mean
from ..parallel.mesh import seq_layout
from .layers import FeatureEmbed, dense


class _InstanceMIL(nn.Module):
    """Embed (``feature.0``) → per-instance logits (``classifier``) → masked
    pooling over the instances."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, inner_dim: int = 512,
                 dropout: float = 0.25, act: str = "relu"):
        super().__init__()
        self.feature = FeatureEmbed(input_dim, inner_dim, act, dropout)
        self.classifier = dense(inner_dim, n_classes)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, return_attn: bool = False):
        """``{"logits"}``. Under a mesh that splits the instances
        (``parallel/mesh.py``, ``sp > 1``) ``feats`` and ``mask`` are this
        rank's block and the pooling runs over the sp row: the logits are
        the whole bag's on every rank."""
        seq = seq_layout(feats.shape[1], feats.device)
        inst_logits = self.classifier(self.feature(feats, training, gen, seq))  # [B,N,C]
        return {"logits": self.reduce(inst_logits, mask.bool()[..., None], dim=-2, sharded=seq is not None)}


class MeanMIL(_InstanceMIL):
    """The mean of the valid instances' logits (``mean_max.py:15-27``)."""

    reduce = staticmethod(masked_mean)


class MaxMIL(_InstanceMIL):
    """The max of the valid instances' logits (``mean_max.py:30-42``); the
    gradient split evenly among tied maxima, over the whole bag under sp."""

    reduce = staticmethod(masked_max)
