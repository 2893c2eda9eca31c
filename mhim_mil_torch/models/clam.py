"""CLAM, single and multi branch, with its clustering-constrained instance
loss (port of ``mhim_mil_tpu/models/clam.py``).

Reference: modules/clam.py:31-337 (Attn_Net, Attn_Net_Gated, CLAM_SB,
CLAM_MB) and modules/topk (SmoothTop1SVM). The modules keep the
reference's names: ``attention_net`` is the ``Sequential`` of the embed
``Linear``, the activation, the dropout (where there is one) and the
attention net, so the attention net sits at index 3 with dropout and 2
without; ``classifiers`` is one ``Linear`` (SB) or one ``Linear(D, 1)`` per
class (MB); ``instance_classifiers.{c}`` are the per-class
``Linear(D, 2)``.

The instance loss mines the top-k and bottom-k attended valid instances
per class. Among equal scores it takes the lower index first, as
``lax.top_k`` does: a stable descending sort, on the CPU and on the card.

Under a mesh that splits the instances (``parallel/mesh.py``, ``sp > 1``)
``feats`` and ``mask`` are this rank's block: the attention pool's softmax
and sum run over the sp row (the logits are the whole bag's on every rank,
``attn`` this block's); the instance loss picks its instances from the
gathered ``[B, N, C]`` attention logits, fetches their features from the
ranks that hold them (``sp_pick``) and counts each bag on sp rank 0 only
(``owner_weight``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masked import NEG_INF, masked_softmax
from ..parallel.mesh import Seq, batch_sum, owner_weight, seq_layout, sp_gather, sp_pick, sp_sum
from .layers import Dropout, dense, get_act


def smooth_top1_svm(logits: torch.Tensor, labels: torch.Tensor, tau: float = 1.0,
                    alpha: float = 1.0) -> torch.Tensor:
    """Per-example smooth top-1 SVM loss ``τ·logsumexp((x + α·(1−onehot_y) −
    x_y)/τ)`` in fp32 (``clam.py:29-38``). Returns ``[...]``."""
    logits = logits.float()
    onehot = F.one_hot(labels.long(), logits.shape[-1]).float()
    x_y = (logits * onehot).sum(dim=-1, keepdim=True)
    z = (logits + alpha * (1.0 - onehot) - x_y) / tau
    return tau * torch.logsumexp(z, dim=-1)


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries on the last axis, largest
    first and, among equal values, the lower index first (``lax.top_k``)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def _dropout(p: float) -> list:
    """A dropout layer where the reference's ``Sequential`` holds one: only when ``p > 0``."""
    return [Dropout(p)] if p > 0 else []


class AttnNetGated(nn.Module):
    """Gated attention scorer ``attention_c(tanh(a·x) ⊙ σ(b·x))`` →
    ``[B, N, K]`` logits (``clam.py:41-58``): ``attention_a`` and
    ``attention_b`` are ``Sequential(Linear, act[, Dropout])``."""

    def __init__(self, dim: int, attn_dim: int = 256, n_branches: int = 1, dropout: float = 0.0,
                 use_bias: bool = True):
        super().__init__()
        self.attention_a = nn.Sequential(dense(dim, attn_dim, use_bias), nn.Tanh(), *_dropout(dropout))
        self.attention_b = nn.Sequential(dense(dim, attn_dim, use_bias), nn.Sigmoid(), *_dropout(dropout))
        self.attention_c = dense(attn_dim, n_branches, use_bias)

    def forward(self, x: torch.Tensor, training: bool = False, gen: Optional[torch.Generator] = None,
                seq: Optional[Seq] = None):
        a = self.attention_a[1](self.attention_a[0](x))
        b = self.attention_b[1](self.attention_b[0](x))
        if len(self.attention_a) > 2:
            a = self.attention_a[2](a, training, gen, seq)
            b = self.attention_b[2](b, training, gen, seq)
        return self.attention_c(a * b)


class AttnNet(nn.Module):
    """Ungated tanh attention scorer (``clam.py:61-74``): ``module`` is
    ``Sequential(Linear, Tanh[, Dropout], Linear)``."""

    def __init__(self, dim: int, attn_dim: int = 256, n_branches: int = 1, dropout: float = 0.0,
                 use_bias: bool = True):
        super().__init__()
        self.module = nn.Sequential(dense(dim, attn_dim, use_bias), nn.Tanh(), *_dropout(dropout),
                                    dense(attn_dim, n_branches, use_bias))

    def forward(self, x: torch.Tensor, training: bool = False, gen: Optional[torch.Generator] = None,
                seq: Optional[Seq] = None):
        a = self.module[1](self.module[0](x))
        if len(self.module) > 3:
            a = self.module[2](a, training, gen, seq)
        return self.module[-1](a)


class CLAM(nn.Module):
    """``clam_sb`` (one attention branch, a shared bag head, max over the
    branch) and ``clam_mb`` (per-class attention and per-class bag heads)
    (``clam.py:77-199``). With ``mil_norm="ln"`` a LayerNorm ``in_norm``
    runs on the raw features. The training forward with a ``label`` adds
    the instance loss as ``aux_loss``."""

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, inner_dim: int = 512,
                 attn_dim: int = 256, dropout: float = 0.25, act: str = "relu", gate: bool = True,
                 k_sample: int = 8, subtyping: bool = False, multi_branch: bool = False,
                 mil_norm: Optional[str] = None, mil_bias: bool = True, svm_tau: float = 1.0):
        super().__init__()
        self.n_classes, self.k_sample, self.subtyping = n_classes, k_sample, subtyping
        self.multi_branch, self.mil_norm, self.svm_tau = multi_branch, mil_norm, svm_tau
        if mil_norm == "ln":
            self.in_norm = nn.LayerNorm(input_dim, eps=1e-5, bias=mil_bias)
        n_branches = n_classes if multi_branch else 1
        net = (AttnNetGated if gate else AttnNet)(inner_dim, attn_dim, n_branches, dropout)
        self.attention_net = nn.Sequential(dense(input_dim, inner_dim, mil_bias), get_act(act),
                                           *_dropout(dropout), net)
        if multi_branch:
            self.classifiers = nn.ModuleList(dense(inner_dim, 1) for _ in range(n_classes))
        else:
            self.classifiers = dense(inner_dim, n_classes, mil_bias)
        self.instance_classifiers = nn.ModuleList(dense(inner_dim, 2) for _ in range(n_classes))

    def inst_loss(self, attn_logits: torch.Tensor, h: torch.Tensor, mask: torch.Tensor,
                  label: torch.Tensor, seq: Optional[Seq] = None) -> torch.Tensor:
        """The clustering-constrained instance loss (``clam.py:96-146``): per
        class, the top-k attended valid instances should classify as in-class
        and the bottom-k as out; with ``subtyping`` the other classes' top-k
        as out. A mean over the bags that hold a valid instance: under an
        active mesh this rank's sum over the whole batch's count of such
        bags (``batch_sum``), so that the ranks' terms add up to the
        one-process mean, as ``engine/losses._wmean`` weighs the criterion.
        Given ``seq`` (``h`` and ``mask`` this rank's block), the picks run
        on the whole bag's gathered logits and the rank counts each bag's
        term only on sp rank 0."""
        b = h.shape[0]
        c, k = self.n_classes, self.k_sample
        a = attn_logits if attn_logits.shape[-1] == c else attn_logits.repeat_interleave(c, dim=-1)
        a, mask = sp_gather(a.detach(), seq), sp_gather(mask, seq)  # the whole bag's [B,N,C], [B,N]
        a = torch.where(mask[..., None], a, NEG_INF)
        top_p = top_k_indices(a.transpose(1, 2), k)  # [B,C,k]
        top_n = top_k_indices(torch.where(mask[..., None], -a, NEG_INF).transpose(1, 2), k)
        w = torch.stack([lin.weight for lin in self.instance_classifiers])  # [C,2,D]
        bias = torch.stack([lin.bias for lin in self.instance_classifiers])  # [C,2]

        def logit(idx):
            picked = sp_pick(h, idx.reshape(b, c * k), seq).view(b, c, k, -1)
            return torch.einsum("bckd,ced->bcke", picked, w) + bias[None, :, None]

        lp, ln = logit(top_p), logit(top_n)
        ones = torch.ones(lp.shape[:-1], dtype=torch.long, device=h.device)
        zeros = torch.zeros_like(ones)
        in_loss = 0.5 * (smooth_top1_svm(lp, ones, self.svm_tau).mean(-1)
                         + smooth_top1_svm(ln, zeros, self.svm_tau).mean(-1))
        out_loss = smooth_top1_svm(lp, zeros, self.svm_tau).mean(-1)  # [B,C]
        onehot = F.one_hot(label.long(), c).float()
        per_class = onehot * in_loss
        if self.subtyping:
            per_class = per_class + (1.0 - onehot) * out_loss
        total = per_class.sum(-1)
        if self.subtyping:
            total = total / c
        valid_bag = mask.any(dim=-1).float() * owner_weight()
        return (total * valid_bag).sum() / batch_sum(valid_bag.sum()).clamp_min(1.0)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, label: Optional[torch.Tensor] = None,
                training: bool = False, gen: Optional[torch.Generator] = None, return_attn: bool = False):
        """``{"logits", "bag_feat"[, "aux_loss"][, "attn" [B,N]]}``."""
        mask = mask.bool()
        seq = seq_layout(feats.shape[1], feats.device)
        x = self.in_norm(feats) if self.mil_norm == "ln" else feats
        net = self.attention_net
        x = net[1](net[0](x))
        if len(net) > 3:
            x = net[2](x, training, gen, seq)
        attn_logits = net[-1](x, training, gen, seq)  # [B,N,K]
        a = masked_softmax(attn_logits.transpose(-1, -2), mask[:, None, :], sharded=seq is not None)  # [B,K,N]
        m = torch.einsum("bkn,bnd->bkd", a, torch.where(mask[..., None], x, 0))
        if seq is not None:
            m = sp_sum(m)
        if self.multi_branch:
            wc = torch.cat([lin.weight for lin in self.classifiers])  # [C,D]
            bc = torch.cat([lin.bias for lin in self.classifiers])
            logits = torch.einsum("bcd,cd->bc", m, wc) + bc
        else:
            logits = self.classifiers(m).amax(dim=1)
        out = {"logits": logits, "bag_feat": m.reshape(feats.shape[0], -1)}
        if label is not None and training:
            out["aux_loss"] = self.inst_loss(attn_logits, x, mask, label, seq)
        if return_attn:
            out["attn"] = a[:, 0]
        return out
