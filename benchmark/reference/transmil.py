"""The plain reference of TransMIL (Shao et al., NeurIPS 2021;
github.com/szc19990412/TransMIL) trained on its own.

Feature MLP (dropout 0.25), cls token, a Nystrom TransLayer, PPEG, a
second TransLayer, LayerNorm of the cls token, a linear head; trained on
the cross-entropy with Adam. Written in plain fp32 PyTorch in the layout
and draw order of the program (``common.py``); it imports nothing of the
program. Departure from the published code, as in the program: the bag is
padded to a bucket and masked instead of filled by repeated tokens.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import common as c
from .mhim import lr_at

Tensor = torch.Tensor
BUFFERS = ()


def param_spec(cfg: Dict) -> List[Tuple]:
    d, h = cfg["inner_dim"], cfg["n_heads"]
    spec = [("cls_token", (1, 1, d), "normal:1e-6")] + c.linear_spec("feature.0", cfg["input_dim"], d)
    spec += c.translayer_spec("layer1", d, h) + c.ppeg_spec("pos_layer", d) + c.translayer_spec("layer2", d, h)
    return spec + c.norm_spec("norm", d) + c.linear_spec("classifier", d, cfg["n_classes"])


def forward(p, cfg, feats, mask, prec, gen):
    drop = 0.25 if cfg["dropout"] else 0.0
    x = c.dropout(c.act(cfg["act"], c.linear(p, "feature.0", feats, prec)), drop, gen)
    cls, _, _ = c.cls_encoder(p, "", x, mask, cfg["n_heads"], prec, gen, "pos_layer")
    return c.linear(p, "classifier", cls, prec)


class Trainer:
    """The generic train step: forward in training mode, cross-entropy, Adam."""

    teacher = None

    def __init__(self, cfg: Dict, weights: Dict[str, Tensor], gen: torch.Generator, prec: c.Precision,
                 steps_per_epoch: int):
        self.cfg, self.gen, self.prec, self.spe = cfg, gen, prec, steps_per_epoch
        self.params = {k: v.detach().clone().float() for k, v in weights.items()}
        self.buffers: Dict[str, Tensor] = {}
        self.adam = c.Adam(self.params, cfg["weight_decay"])
        self.count = 0

    def step(self, batch: Dict[str, Tensor], fault: Optional[str] = None) -> Dict[str, Tensor]:
        names = list(self.params)
        leaves = [self.params[k].requires_grad_(True) for k in names]
        mask = batch["mask"].bool()
        bag_valid = batch["bag_valid"].bool()
        if fault == "half":
            bag_valid = bag_valid & (torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2)
        logits = forward(self.params, self.cfg, batch["feats"].float(), mask, self.prec, self.gen)
        loss = self.cfg["main_alpha"] * c.cross_entropy(logits, batch["target"], bag_valid)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for t in leaves:
            t.requires_grad_(False)
        grads = {k: (torch.zeros_like(self.params[k]) if g is None else g) for k, g in zip(names, grads)}
        taken = self.adam.step(self.params, grads, lr_at(self.cfg, self.count, self.spe))
        self.count += 1
        return {"loss": loss.detach(), "grads": taken}


@torch.no_grad()
def infer(cfg: Dict, weights: Dict[str, Tensor], feats: Tensor, mask: Tensor, prec: c.Precision) -> Tensor:
    return forward(weights, cfg, feats.float(), mask.bool(), prec, None)
