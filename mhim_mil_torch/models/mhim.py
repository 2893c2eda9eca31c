"""MHIM, masked hard-instance-mining teacher/student MIL (port of
``mhim_mil_tpu/models/mhim.py``).

Reference: modules/mhim.py:12-378. Ported: the ``selfattn`` (with each
``pos``), ``attn`` and ``dsmil`` baselines with the teacher pass (eval and
training mode), the student training pass (layered mining, compaction,
Merge, the consistency loss), ``forward_test`` and the baseline-only
``pure`` pass of the ``mhim_pure`` teacher stage. Masking never changes a shape that depends on the data:
the removal set is a boolean mask, and the kept tokens are compacted into
static slices. Every random draw of the student pass (the three mining
stages, the merge split) is an argument or comes from the caller's
generator, as do the dropout masks.

Under a mesh that splits the instances (``parallel/mesh.py``, ``sp > 1``)
each entry point reads the layout of its rank's block from the data
(``seq_layout``). The mining runs on the gathered ``[B, N]`` scores and
masks, the same on every rank, which keeps its own columns; the compactions
move the kept instances to their blocks (``compact_sharded``); the Merge's
tokens go at the end of the sequence, on the last rank, and the encoder's
cls token at the front, on rank 0. ``patch_num`` and ``keep_num`` are the
whole bags' counts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..engine.losses import soft_target_ce
from ..ops.masked import compact, compact_sharded
from ..ops.masking import MaskSchedule, layered_mask
from ..parallel.mesh import (Seq, active as active_mesh, local_rows, rand_rows, seq_layout, sp_gather, sp_join,
                             sp_sum)
from .baselines import DAttentionBaseline, SAttentionBaseline
from .dsmil import DSMILHead
from .layers import FeatureEmbed, dense
from .merge import Merge


def _cam_score(features: torch.Tensor, weight: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Instance pseudo-score: the max class probability of the attention-weighted
    instance features through the predictor's weight ``[C, D]``, without its
    bias (reference scoring.py:37-58); zero at masked instances. fp32."""
    cam = features.float() @ weight.float().t()  # [B,N,C]
    score = torch.softmax(cam, dim=-1).amax(dim=-1)
    return torch.where(mask, score, 0.0)


def _uniform(shape, gen: Optional[torch.Generator], device) -> torch.Tensor:
    """A uniform draw of ``shape`` from ``gen``; under an active mesh, this
    rank's rows of the global batch's draw."""
    if gen is None:
        raise ValueError("the training pass needs a torch.Generator or injected draws")
    return rand_rows(shape, gen, device)


class MHIM(nn.Module):
    """MHIM with the ``selfattn`` (SAttention, its positional module
    ``pos``), ``attn`` (DAttention) or ``dsmil`` (DSMILHead) baseline
    encoder, a linear predictor (none for ``dsmil``, whose head predicts:
    ``0.5·bag + 0.5·instance`` logits) and, with ``merge_enable``, the
    Merge module. The knobs are those of ``mhim.py:55-86``."""

    def __init__(self, input_dim: int = 1024, mlp_dim: int = 512, n_classes: int = 2,
                 dropout: float = 0.25, act: str = "relu", baseline: str = "selfattn",
                 heads: int = 8, da_act: str = "gelu", mask_ratio: float = 0.0,
                 mask_ratio_l: float = 0.0, mask_ratio_h: float = 0.0, mask_ratio_hr: float = 1.0,
                 msa_fusion: str = "vote", attn_layer: int = 0, attn2score: bool = True,
                 temp_t: float = 1.0, temp_s: float = 1.0, merge_enable: bool = True,
                 merge_k: int = 1, merge_mm: float = 0.9998, merge_ratio: float = 0.2,
                 merge_test: bool = False, use_flash: bool = True, pos: str = "ppeg"):
        super().__init__()
        self.baseline = baseline
        self.sched = MaskSchedule(mask_ratio, mask_ratio_l, mask_ratio_h, mask_ratio_hr, msa_fusion)
        self.attn2score, self.attn_layer = attn2score, attn_layer
        self.temp_t, self.temp_s = temp_t, temp_s
        self.merge_enable, self.merge_k, self.merge_ratio = merge_enable, merge_k, merge_ratio
        self.merge_test = merge_test
        self.feature = FeatureEmbed(input_dim, mlp_dim, act, dropout)
        if baseline == "selfattn":
            # attn2score mining reads only layer 1's attention and scored values
            need = (0,) if (attn2score and attn_layer == 0) else (0, 1)
            self.online_encoder = SAttentionBaseline(mlp_dim, heads, use_flash, attn_layers=need, pos=pos)
        elif baseline == "attn":
            self.online_encoder = DAttentionBaseline(mlp_dim, da_act, use_flash=use_flash)
        elif baseline == "dsmil":
            self.online_encoder = DSMILHead(mlp_dim, n_classes, cls_attn=attn2score)
        else:
            raise ValueError(f"unknown baseline: {baseline!r}")
        if baseline != "dsmil":
            self.predictor = dense(mlp_dim, n_classes)
        if merge_enable:
            self.merge = Merge(mlp_dim, k=merge_k, g_q_mm=merge_mm, merge_ratio=merge_ratio)

    # ---- teacher ------------------------------------------------------------

    def _seq(self, feats: torch.Tensor) -> Optional[Seq]:
        return seq_layout(feats.shape[1], feats.device)

    @staticmethod
    def _sp(seq: Optional[Seq]) -> Dict[str, Seq]:
        """The keyword that hands a layout on (none without one)."""
        return {} if seq is None else {"seq": seq}

    @torch.no_grad()
    def forward_teacher(self, feats: torch.Tensor, mask: torch.Tensor, training: bool = False,
                        gen: Optional[torch.Generator] = None):
        """Teacher pass over the full bag (reference mhim.py:181-227):
        ``(cls_feat[B,D], mining score[B,N])``; for ``dsmil`` the bag
        feature ``[B,C,D]`` and each instance's largest class logit (or
        attention, without ``attn2score``). The train step runs it with
        ``training=True``: the reference's EMA teacher mines with its
        dropouts on, and their masks come from ``gen``."""
        mask = mask.bool()
        seq = self._seq(feats)
        out = self.online_encoder(self.feature(feats, training, gen, seq), mask, True, training, gen,
                                  **self._sp(seq))
        if self.baseline == "dsmil":
            return out["bag_feat"], out["attn"]
        if not self.attn2score:
            return out["cls_feat"], (out["attns"][self.attn_layer] if "attns" in out else out["attn"])
        if self.baseline == "selfattn":
            feats_w = out["scored_act"]  # layer 1's to_out(v ⊙ attn)
        else:
            feats_w = out["act"] * out["attn"][..., None]
        return out["cls_feat"], _cam_score(feats_w, self.predictor.weight, mask)

    # ---- student ------------------------------------------------------------

    def static_survivors(self, n: int) -> int:
        """Static bound on the instances that survive mining (mhim.py:202-207).
        The stages compose by union, so the guaranteed removal is the largest
        always-firing stage; the scheduled high stage guarantees nothing
        (−1 absorbs the float32 rounding of the per-bag counts)."""
        guar = 0
        if self.sched.mask_ratio > 0:
            guar = max(guar, int(n * self.sched.mask_ratio) - 1)
        if self.sched.mask_ratio_l > 0:
            guar = max(guar, int(n * self.sched.mask_ratio_l) - 1)
        return n - max(guar, 0)

    def merge_len(self, v_static: int) -> int:
        """Static slice of the kept tokens after Merge (mhim.py:223; +1 absorbs
        the float32 rounding of the per-bag keep counts)."""
        return max(1, min(int(v_static * self.merge_ratio) + 1, v_static))

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, attn: Optional[torch.Tensor] = None,
                teacher_cls_feat: Optional[torch.Tensor] = None, mask_ratio_h_now=None,
                training: bool = True, gen: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, object]] = None) -> Dict[str, torch.Tensor]:
        """Student training pass (reference mhim.py:318-378, JAX mhim.py:166-267):
        mask hard instances by the teacher's ``attn``, compact the survivors,
        embed, merge, encode, predict, and pay the consistency loss against
        the teacher's feature.

        ``draws`` may hold the uniform draws ``"mask"`` (three ``[B,N]``
        tensors or None, for the random, low and high stages) and
        ``"merge"`` (``[B, v_static]``); a draw that is not given comes from
        ``gen``. Under an active mesh the given draws are the global batch's,
        of which this rank takes its rows."""
        mask = mask.bool()
        b, n, _ = feats.shape
        seq = self._seq(feats)
        if seq is not None:
            n = seq.total
        draws = draws or {}
        if active_mesh() is not None:
            draws = {"mask": None if draws.get("mask") is None
                     else [None if u is None else local_rows(u) for u in draws["mask"]],
                     "merge": None if draws.get("merge") is None else local_rows(draws["merge"])}

        if attn is not None:
            u = draws.get("mask")
            if u is None:
                on = self.sched.stages(mask_ratio_h_now is not None)
                u = [_uniform((b, n), gen, mask.device) if s else None for s in on]
            removed = layered_mask(u, sp_gather(attn, seq, -1), sp_gather(mask, seq), self.sched, mask_ratio_h_now)
            visible = mask & (~removed if seq is None else ~removed[:, seq.cols])
            v_static = self.static_survivors(n)
        else:
            visible, v_static = mask, n

        seq_v = seq
        if v_static < n and seq is not None:
            feats_v, vis, seq_v = compact_sharded(feats, visible, v_static, seq)
        elif v_static < n:
            feats_v, vis, _ = compact(feats, visible, out_len=v_static)
        else:
            feats_v, vis = feats, visible
        x = self.feature(feats_v, training, gen, seq_v)

        seq_x = seq_v
        if self.merge_enable:
            u_merge = draws.get("merge")
            if training and u_merge is None:
                u_merge = _uniform((b, v_static), gen, vis.device)
            keep_sel, merged = self.merge(x, vis, training, gen, u_merge, **self._sp(seq_v))
            ones = vis.new_ones((b, self.merge_k))
            if training and seq_v is not None:
                x, valid, seq_x = compact_sharded(x, keep_sel, self.merge_len(v_static), seq_v)
            elif training:
                x, valid, _ = compact(x, keep_sel, out_len=self.merge_len(v_static))
            else:
                # Eval-mode Merge keeps every visible token (merge.py:178-203).
                valid = vis
            if seq_x is None or seq_x.index == len(seq_x.counts) - 1:  # the merged tokens go last
                x, valid = torch.cat([x, merged], dim=1), torch.cat([valid, ones], dim=1)
            else:
                x = sp_join(x, merged)
            seq_x = None if seq_x is None else seq_x.append(self.merge_k)
        else:
            valid = vis

        logits, cls_feat = self._predict(self.online_encoder(x, valid, False, training, gen, **self._sp(seq_x)))
        patch_num, keep_num = mask.sum(dim=-1), valid.sum(dim=-1)
        if seq is not None:
            patch_num, keep_num = sp_sum(torch.stack([patch_num, keep_num])).unbind()
        aux_loss = logits.new_zeros((), dtype=torch.float32)
        if teacher_cls_feat is not None:
            # Fake zero-padded bags (mask all False) contribute nothing. The
            # dsmil feature [B,C,D] pays the loss of each class, weighted by
            # its bag (JAX's weights broadcast against the class axis).
            weights = patch_num > 0
            if cls_feat.dim() == 3:
                weights = weights[:, None]
            aux_loss = soft_target_ce(cls_feat, teacher_cls_feat.detach(), self.temp_t, self.temp_s,
                                      weights=weights)
        return {
            "logits": logits,
            "aux_loss": aux_loss,
            "patch_num": patch_num,
            "keep_num": keep_num,
        }

    def pure(self, feats: torch.Tensor, mask: torch.Tensor, training: bool = False,
             gen: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Baseline-only pass, no mining or merging: the ``mhim_pure`` model
        that the teacher stage trains (reference mhim.py:274-298, JAX
        mhim.py:293-307). The feature MLP, the encoder over the whole bag
        and the predictor; ``aux_loss`` is 0 and ``patch_num`` and
        ``keep_num`` are both the bag's size. With the selfattn baseline and
        ``use_flash`` a training pass runs K3 at the bag's full length."""
        mask = mask.bool()
        seq = self._seq(feats)
        logits, _ = self._predict(self.online_encoder(self.feature(feats, training, gen, seq), mask, False,
                                                      training, gen, **self._sp(seq)))
        n = mask.sum(dim=-1) if seq is None else sp_sum(mask.sum(dim=-1))
        return {"logits": logits, "aux_loss": logits.new_zeros((), dtype=torch.float32),
                "patch_num": n, "keep_num": n}

    def _predict(self, out: Dict[str, torch.Tensor]):
        """``(logits, feature)`` from the encoder's output: the predictor on
        ``cls_feat``; for ``dsmil`` ``0.5·bag + 0.5·instance`` logits and the
        ``[B,C,D]`` bag feature (``mhim.py:243-245``)."""
        if self.baseline == "dsmil":
            return 0.5 * out["bag_logits"] + 0.5 * out["inst_logits"], out["bag_feat"]
        return self.predictor(out["cls_feat"]), out["cls_feat"]

    # ---- inference ----------------------------------------------------------

    @torch.no_grad()
    def forward_test(self, feats: torch.Tensor, mask: torch.Tensor,
                     return_attn: bool = False, no_norm: bool = False):
        """Inference pass (reference mhim.py:229-272): ``{"logits"[, "attn"]}``;
        ``no_norm`` returns the unsoftmaxed attention."""
        seq = self._seq(feats)
        x = self.feature(feats, seq=seq)
        mask = mask.bool()
        if self.merge_enable and self.merge_test:
            _, merged = self.merge(x, mask, **self._sp(seq))
            if seq is None or seq.index == len(seq.counts) - 1:
                x = torch.cat([x, merged], dim=1)
                mask = torch.cat([mask, mask.new_ones((x.shape[0], self.merge_k))], dim=1)
            seq = None if seq is None else seq.append(self.merge_k)
        out = self.online_encoder(x, mask, return_attn, no_norm=no_norm, **self._sp(seq))
        res = {"logits": self._predict(out)[0]}
        if return_attn:
            res["attn"] = out["attn"]
        return res

