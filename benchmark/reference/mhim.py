"""The plain reference of MHIM-MIL with the TransMIL (``selfattn``) baseline.

MHIM-MIL (Tang et al., ICCV 2023; github.com/DearCaat/MHIM-MIL): an EMA
teacher scores every instance of the bag; the student's bag loses a random
half of its instances and a random half of the teacher's top-scored ones
(the high ratio cosine-scheduled to 0), keeps a random ``merge_ratio`` of
what is left and merges the rest into ``merge_k`` tokens by cross-attention
against EMA global queries; the student trains on the cross-entropy plus
``aux_alpha`` times the consistency loss against the teacher's feature, and
the teacher follows the student by EMA. Written here in plain fp32 PyTorch
from that description, in the layout and draw order of the program (see
``common.py``); it imports nothing of the program.

Departures from the published code, as in the program: the bag is padded
to a bucket and masked; each random choice takes the top ``k`` of a
uniform draw; the high-stage pseudo-score is the cls-attention-weighted
values of layer 1 through the predictor (``attn2score``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from . import common as c

Tensor = torch.Tensor


def param_spec(cfg: Dict) -> List[Tuple]:
    """``(name, shape, init)`` of every leaf, in the program's names;
    ``merge.global_q_mm`` is the Merge's buffer of global queries."""
    d, h, k = cfg["inner_dim"], cfg["n_heads"], cfg["merge_k"]
    spec = c.linear_spec("feature.0", cfg["input_dim"], d)
    spec += [("online_encoder.cls_token", (1, 1, d), "normal:1.0")]
    spec += c.translayer_spec("online_encoder.layer1", d, h) + c.ppeg_spec("online_encoder.pos_embedding", d)
    spec += c.translayer_spec("online_encoder.layer2", d, h) + c.norm_spec("online_encoder.norm", d)
    spec += c.linear_spec("predictor", d, cfg["n_classes"])
    spec += [("merge.global_q_mm", (1, k, d), f"uniform:{math.sqrt(6.0 / (3 * 16 * 16 + d))}")]
    spec += c.norm_spec("merge.norm", d) + c.linear_spec("merge.attn.to_kv", d, 1024, bias=False)
    spec += c.linear_spec("merge.attn.to_q", d, 512, bias=False) + c.linear_spec("merge.attn.to_out.0", 512, d)
    return spec


BUFFERS = ("merge.global_q_mm",)


def top_k(scores: Tensor, valid: Tensor, k: Tensor) -> Tensor:
    """The ``k`` highest-scored valid positions of each row (ties to the lower index)."""
    key = torch.where(valid, -scores.float(), float("inf"))
    order = torch.argsort(key, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(-1, order, torch.arange(key.shape[-1], device=key.device)
                                            .expand_as(order).contiguous())
    return (rank < k.long()[..., None]) & valid


def compact(x: Tensor, keep: Tensor, out_len: int) -> Tuple[Tensor, Tensor]:
    """The kept rows of ``x[B, N, D]`` moved to the front in index order, cut to
    ``out_len``; and their validity."""
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)[:, :out_len]
    rows = torch.gather(x, 1, order[..., None].expand(*order.shape, x.shape[-1]))
    return rows, torch.arange(out_len, device=x.device)[None, :] < keep.sum(dim=-1, keepdim=True)


def encode(p, cfg, x, mask, prec, gen, return_attn=False):
    return c.cls_encoder(p, "online_encoder.", x, mask, cfg["n_heads"], prec, gen, "pos_embedding", return_attn)


def embed(p, cfg, feats, prec, gen):
    return c.dropout(c.act(cfg["act"], c.linear(p, "feature.0", feats, prec)), cfg["dropout"], gen)


def merge(p, buf, cfg, x, kv_mask, prec, gen) -> Tensor:
    """The Merge's cross-attention of the global queries over the ``kv_mask``
    tokens (8 heads of 64, dropout 0.1 on the attention and the output);
    moves the buffer of global queries toward the batch's mean merged token
    at ``1 − merge_mm`` over the bags that have a token to merge."""
    b, n, _ = x.shape
    k = cfg["merge_k"]
    gq = buf["merge.global_q_mm"]
    xn = c.layer_norm(p, "merge.norm", x)
    qn = c.layer_norm(p, "merge.norm", gq.expand(b, k, -1))
    kk, vv = c.linear(p, "merge.attn.to_kv", xn, prec).chunk(2, dim=-1)
    q = c.linear(p, "merge.attn.to_q", qn, prec)
    kk, vv, q = (t.reshape(b, t.shape[1], 8, 64).transpose(1, 2) for t in (kk, vv, q))
    attn = c.masked_softmax((prec(q) @ prec(kk).transpose(-1, -2)) * 64 ** -0.5, kv_mask[:, None, None, :])
    attn = c.dropout(attn, 0.1, gen)
    out = (prec(attn) @ prec(vv)).transpose(1, 2).reshape(b, k, 512)
    z = c.dropout(c.linear(p, "merge.attn.to_out.0", out, prec), 0.1, gen)
    with torch.no_grad():
        w = kv_mask.any(dim=-1).float()
        wsum = w.sum()
        new = (z.detach() * w[:, None, None]).sum(0, keepdim=True) / wsum.clamp_min(1.0)
        alpha = (1.0 - cfg["merge_mm"]) * wsum.clamp_max(1.0)
        buf["merge.global_q_mm"] = (1.0 - alpha) * gq + alpha * new
    return z


class Trainer:
    """The MHIM train step on a dict of fp32 leaves: teacher forward in
    training mode (its dropouts on), mining, student, loss, Adam, EMA."""

    def __init__(self, cfg: Dict, weights: Dict[str, Tensor], gen: torch.Generator, prec: c.Precision,
                 steps_per_epoch: int):
        self.cfg, self.gen, self.prec = cfg, gen, prec
        self.params = {k: v.detach().clone().float() for k, v in weights.items() if k not in BUFFERS}
        self.buffers = {k: weights[k].detach().clone().float() for k in BUFFERS}
        self.teacher = {k: v.clone() for k, v in self.params.items()}
        self.adam = c.Adam(self.params, cfg["weight_decay"])
        self.total = max(cfg["num_epoch"] * steps_per_epoch, 1)
        self.spe = steps_per_epoch
        self.count = 0

    def lr(self) -> float:
        return lr_at(self.cfg, self.count, self.spe)

    def teacher_pass(self, feats, mask):
        cfg, prec, t = self.cfg, self.prec, self.teacher
        with torch.no_grad():
            x = embed(t, cfg, feats, prec, self.gen)
            cls_t, _, scored = encode(t, cfg, x, mask, prec, self.gen, True)
            cam = prec(scored) @ prec(t["predictor.weight"]).t()
            score = torch.where(mask, torch.softmax(cam, dim=-1).amax(dim=-1), 0.0)
        return cls_t, score

    def mine(self, score: Tensor, mask: Tensor) -> Tensor:
        """The instances left visible: a random ``mask_ratio`` of the valid
        ones removed, and a random ``mask_ratio_hr`` of the top
        ``mask_ratio_h(t) / mask_ratio_hr`` by score."""
        cfg = self.cfg
        b, n = mask.shape
        u_rand = torch.rand((b, n), generator=self.gen, device=mask.device)
        u_high = torch.rand((b, n), generator=self.gen, device=mask.device)
        ps = mask.sum(dim=-1).float()
        removed = top_k(u_rand, mask, torch.ceil(ps * min(cfg["mask_ratio"], 1.0) - 1e-4).int())
        mrh = c.cosine(cfg["mask_ratio_h"], 0.0, self.total, self.count)
        hr = torch.as_tensor(cfg["mask_ratio_hr"], dtype=torch.float32)
        eff = mrh / hr
        sub = torch.where(eff > 1.0, mrh, hr)
        pool = top_k(score, mask, torch.ceil(ps * eff.clamp_max(1.0) - 1e-4).int())
        high = top_k(u_high, pool, torch.ceil(pool.sum(dim=-1).float() * sub.clamp_max(1.0) - 1e-4).int())
        return mask & ~((removed | high) & mask)

    def loss(self, batch: Dict[str, Tensor], fault: Optional[str] = None):
        cfg, prec, p, gen = self.cfg, self.prec, self.params, self.gen
        feats, mask = batch["feats"].float(), batch["mask"].bool()
        bag_valid = batch["bag_valid"].bool()
        if fault == "half":  # half of the batch left out, the mean over the rest
            bag_valid = bag_valid & (torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2)
        cls_t, score = self.teacher_pass(feats, mask)
        visible = self.mine(score, mask)
        n = mask.shape[1]
        v_static = n - max(int(n * cfg["mask_ratio"]) - 1, 0)
        feats_v, vis = compact(feats, visible, v_static)
        x = embed(p, cfg, feats_v, prec, gen)
        u_merge = torch.rand(vis.shape, generator=gen, device=vis.device)
        keep_sel = top_k(u_merge, vis, (vis.sum(dim=-1).float() * cfg["merge_ratio"]).int())
        merged = merge(p, self.buffers, cfg, x, vis & ~keep_sel, prec, gen)
        x, valid = compact(x, keep_sel, max(1, min(int(v_static * cfg["merge_ratio"]) + 1, v_static)))
        x = torch.cat([x, merged], dim=1)
        valid = torch.cat([valid, valid.new_ones((valid.shape[0], cfg["merge_k"]))], dim=1)
        cls_s, _, _ = encode(p, cfg, x, valid, prec, gen)
        logits = c.linear(p, "predictor", cls_s, prec)
        main = c.cross_entropy(logits, batch["target"], bag_valid)
        t = torch.softmax(cls_t.float() / cfg["temp_t"], dim=-1)
        aux_w = (mask.sum(dim=-1) > 0) & (bag_valid if fault == "half" else True)
        aux = c.weighted_mean((-t * torch.log_softmax(cls_s.float(), dim=-1)).sum(dim=-1), aux_w)
        loss = cfg["main_alpha"] * main + cfg["aux_alpha"] * aux
        return loss, {"keep_num": valid.sum(dim=-1).float().mean(), "main_loss": main.detach(),
                      "aux_loss": aux.detach()}

    def step(self, batch: Dict[str, Tensor], fault: Optional[str] = None) -> Dict[str, Tensor]:
        """One step; returns the loss, the mean kept count and the gradients
        as Adam took them."""
        names = list(self.params)
        leaves = [self.params[k].requires_grad_(True) for k in names]
        loss, extra = self.loss(batch, fault)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for t in leaves:
            t.requires_grad_(False)
        grads = {k: (torch.zeros_like(self.params[k]) if g is None else g) for k, g in zip(names, grads)}
        taken = self.adam.step(self.params, grads, self.lr())
        self.count += 1
        with torch.no_grad():
            for k in names:
                self.teacher[k].lerp_(self.params[k], 1.0 - self.cfg["mm"])
        return {"loss": loss.detach(), "grads": taken, **extra}


def lr_at(cfg: Dict, count: int, steps_per_epoch: int) -> float:
    """The learning rate of update ``count``: ``const``, or ``cosine`` to
    1e-7 over the run without warm-up, held within an epoch."""
    if cfg["lr_sche"] == "const":
        return float(torch.as_tensor(cfg["lr"], dtype=torch.float32))
    if cfg["lr_sche"] != "cosine" or cfg.get("warmup_epochs", 0) or cfg.get("lr_supi", False):
        raise NotImplementedError("the reference follows const, or cosine held within an epoch without warm-up")
    step = (count // steps_per_epoch) * steps_per_epoch
    return float(c.cosine(cfg["lr"], 1e-7, cfg["num_epoch"] * steps_per_epoch, step))


@torch.no_grad()
def infer(cfg: Dict, weights: Dict[str, Tensor], feats: Tensor, mask: Tensor, prec: c.Precision) -> Tensor:
    """The student's inference pass (``forward_test``, no merge at test): logits ``[B, C]``."""
    x = embed(weights, cfg, feats.float(), prec, None)
    cls, _, _ = encode(weights, cfg, x, mask.bool(), prec, None)
    return c.linear(weights, "predictor", cls, prec)
