"""Nystrom transformer blocks (port of ``mhim_mil_tpu/models/transformer.py``).

Reference: modules/nystrom_attention.py:30-152 and modules/transmil.py:23-47,
batched and masked over ``(x[B,N,D], mask[B,N])``. Parameter names follow the
original PyTorch repo (``to_qkv``, ``to_out.0``, ``res_conv``, ``norm``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_nystrom import flash_nystrom, flash_nystrom_infer
from ..ops.nystrom import nystrom_attention, nystrom_attention_streamed
from ..parallel.mesh import Seq, seq_layout, sp_first, sp_halo
from .layers import Dropout, FeatureEmbed, dense
from .positional import make_pos


class _DepthwiseResConv(nn.Conv2d):
    """The Nystrom value residual: a per-head 33-tap convolution along the
    sequence, shared across the head's channels (reference
    ``Conv2d(heads, heads, (33, 1), groups=heads)``, weight ``[H,1,33,1]``).
    Given ``seq``, ``v`` is this rank's block of a sequence sharded over the
    active sp row, and the 16 tokens on each side come from the
    neighbouring blocks (:func:`~..parallel.mesh.sp_halo`)."""

    def __init__(self, heads: int, kernel_size: int = 33):
        super().__init__(heads, heads, (kernel_size, 1), padding=(kernel_size // 2, 0),
                         groups=heads, bias=False)

    def forward(self, v: torch.Tensor, seq: Optional[Seq] = None) -> torch.Tensor:  # [B,N,H,dh] -> [B,N,H·dh]
        b, n, h, dh = v.shape
        if seq is not None:
            p = self.padding[0]
            out = F.conv2d(sp_halo(v, seq, p, p).transpose(1, 2), self.weight, None, groups=self.groups)
            return out.transpose(1, 2).reshape(b, n, h * dh)
        out = super().forward(v.transpose(1, 2))  # [B,H,N,dh]
        return out.transpose(1, 2).reshape(b, n, h * dh)


class NystromMSA(nn.Module):
    """Multi-head Nystrom self-attention with the depthwise-conv value residual.

    The attention takes one of three paths (:meth:`path`), in the order of
    JAX's layer (``transformer.py:111-150``):

    - ``kernels``: with ``use_flash`` on CUDA tensors, K3 (:func:`flash_nystrom`)
      when a gradient is wanted, :func:`flash_nystrom_infer` (K1 + K2)
      otherwise;
    - ``streamed``: otherwise, from ``stream_min_len`` tokens,
      :func:`nystrom_attention_streamed`, which builds no ``[B,H,N,m]``
      tensor: what JAX's layer runs there on the CPU and without ``use_flash``;
    - below ``stream_min_len``: the kernels' wrappers under ``use_flash``
      (on CPU tensors they run their plain versions), else the materialising
      :func:`nystrom_attention`.

    JAX's layer takes the materialising op below ``stream_min_len`` on the
    CPU. The port keeps the wrappers there so that the CPU tests of a
    ``use_flash`` model go through the kernel path's own autograd wiring
    (K3's ``FlashNystrom`` with its recompute backward, the no-grad route)
    and hold it against JAX. The two ops compute the same function and
    differ only in rounding: a whole MHIM train step's gradients match
    JAX's within 1e-5 of each tensor's max|g| with either
    (``tests/test_torch_train.py::test_first_step_gradients_match_jax``).
    Adam's first update magnifies that rounding on weights whose gradient
    is itself rounding noise, far under Adam's eps: there the parameters
    after a step differ from JAX's by a few 1e-6 with either op.

    The ``parity`` layer and a ``no_norm`` call always take the
    materialising op, as JAX's layer does: the kernels and the streamed op
    compute neither mode, so the mode asked for selects the plain op; it is
    not a fallback from a kernel.

    Given ``seq``, the layer runs on this rank's block of a sequence
    sharded over the active sp row: the path is chosen by the whole
    sequence's length, each op takes the layout (the ``parity`` layer's
    front padding goes in front of sp rank 0's block), the value residual
    reads its halo from the neighbouring blocks, and the outputs are this
    block's. The cls token is the sequence's first. ``to_out`` is a one-layer ``Sequential`` so that its weights
    keep the reference's name ``to_out.0``; the dropout after it (p=0.1, as
    in the JAX package) applies to the attention output only, never to the
    scored values.
    """

    def __init__(self, dim: int = 512, heads: int = 8, dim_head: int = 64,
                 num_landmarks: int = 256, pinv_iterations: int = 6, use_flash: bool = True,
                 parity: bool = False, stream_min_len: int = 4096):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.num_landmarks, self.pinv_iterations = num_landmarks, pinv_iterations
        self.use_flash, self.parity, self.stream_min_len = use_flash, parity, stream_min_len
        inner = heads * dim_head
        self.to_qkv = dense(dim, inner * 3, use_bias=False)
        self.to_out = nn.Sequential(dense(inner, dim))
        self.drop = Dropout(0.1)
        self.res_conv = _DepthwiseResConv(heads)

    def path(self, n: int, on_cuda: bool, no_norm: bool = False) -> str:
        """The attention's path for ``n`` tokens: ``kernels``, ``streamed`` or ``materialising``."""
        if no_norm or self.parity:
            return "materialising"
        if self.use_flash and on_cuda:
            return "kernels"
        if n >= self.stream_min_len:
            return "streamed"
        return "kernels" if self.use_flash else "materialising"

    def forward(self, x: torch.Tensor, mask: torch.Tensor, return_attn: bool = False,
                training: bool = False, gen: Optional[torch.Generator] = None, no_norm: bool = False,
                seq: Optional[Seq] = None):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        inner = h * dh
        # One masking pass on the qkv input: to_qkv has no bias, so q/k/v are
        # zero at masked tokens; the outputs there are re-zeroed at the end.
        x = torch.where(mask[..., None], x, 0)
        qkv = self.to_qkv(x).view(b, n, 3, h, dh)
        q = qkv[:, :, 0] * dh ** -0.5  # [B,N,H,dh]
        k, v = qkv[:, :, 1], qkv[:, :, 2]  # strided views, no copy
        path = self.path(n if seq is None else seq.total, qkv.is_cuda, no_norm)
        if path == "streamed":
            out, attn = nystrom_attention_streamed(q, k, v, mask, self.num_landmarks, self.pinv_iterations,
                                                   return_attn=return_attn, pre_masked=True, seq=seq)
        else:
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B,H,N,dh] views
            if path == "materialising":
                out, attn = nystrom_attention(
                    qh, kh, vh, mask, self.num_landmarks, self.pinv_iterations,
                    return_attn=return_attn, no_norm=no_norm, parity=self.parity, seq=seq,
                )
            elif torch.is_grad_enabled() and qkv.requires_grad:
                out, attn = flash_nystrom(qh, kh, vh, mask, self.num_landmarks, self.pinv_iterations, seq=seq)
            else:
                out, attn = flash_nystrom_infer(qh, kh, vh, mask, self.num_landmarks, self.pinv_iterations,
                                                seq=seq)
            out = out.transpose(1, 2).reshape(b, n, inner)
        out = out.to(x.dtype) + self.res_conv(v, seq)
        out = torch.where(mask[..., None], self.drop(self.to_out(out), training, gen, seq), 0)
        if not return_attn:
            return out
        # Pseudo-score ingredients: the cls-attention-weighted values of the
        # instance tokens (all but the cls token, the first) through this
        # layer's to_out, bias included.
        skip = 1 if seq is None or seq.first else 0
        v_inst = v[:, skip:]  # [B,N-1,H,dh]
        a_inst = attn[:, :, skip:].transpose(1, 2)[..., None].to(v.dtype)  # [B,N-1,H,1]
        scored = self.to_out((v_inst * a_inst).reshape(b, n - skip, inner))
        return out, attn, v_inst, scored


class TransLayer(nn.Module):
    """Pre-norm Nystrom block ``x + MSA(LN(x))`` (reference transmil.py:23-47)
    with dim/heads head width and dim/2 landmarks; ``no_norm`` reaches the
    attention only with ``need_attn``, as in JAX's layer."""

    def __init__(self, dim: int = 512, heads: int = 8, use_flash: bool = True, parity: bool = False):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = NystromMSA(dim, heads, dim // heads, dim // 2, use_flash=use_flash, parity=parity)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, need_attn: bool = False,
                training: bool = False, gen: Optional[torch.Generator] = None, no_norm: bool = False,
                seq: Optional[Seq] = None):
        normed = self.norm(x)
        if need_attn:
            z, attn, v, scored = self.attn(normed, mask, True, training, gen, no_norm, seq)
            return x + z, attn, v, scored
        return x + self.attn(normed, mask, False, training, gen, seq=seq)


class TransMIL(nn.Module):
    """``transmil``: embed → cls token → TransLayer → positional module →
    TransLayer → LayerNorm → linear head (``transformer.py:225-313``;
    reference modules/transmil.py:66-175), with padding masked rather than
    filled by repeated tokens.

    ``mil_norm="ln"`` adds a LayerNorm ``in_norm`` on the raw features; the
    embed's dropout is 0.25 whenever ``dropout`` is set. ``pos`` is the
    module ``pos_layer``: ``ppeg``, ``sincos`` (from ``coords``, else the
    row-major grid), ``peg`` or ``none``. The cls token starts at
    N(0, 1e-6²), as in JAX's TransMIL (SAttention's starts at N(0, 1)).
    ``return_attn`` adds both layers' cls attention (``attns``, each
    ``[B,H,N]``) and layer 2's as ``attn``. Both TransLayers run K3 in
    training and K1 + K2 otherwise under ``use_flash``, unless ``parity``.
    """

    cls_token_std = 1e-6

    def __init__(self, input_dim: int = 1024, n_classes: int = 2, inner_dim: int = 512,
                 dropout: float = 0.25, act: str = "relu", mil_norm: Optional[str] = None,
                 mil_bias: bool = True, pos: str = "ppeg", n_heads: int = 8, parity: bool = False,
                 use_flash: bool = True):
        super().__init__()
        self.mil_norm, self.pos = mil_norm, pos
        if mil_norm == "ln":
            self.in_norm = nn.LayerNorm(input_dim, eps=1e-5, bias=mil_bias)
        self.feature = FeatureEmbed(input_dim, inner_dim, act, 0.25 if dropout else 0.0, mil_bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, inner_dim))
        self.layer1 = TransLayer(inner_dim, n_heads, use_flash, parity)
        self.pos_layer = make_pos(pos, inner_dim, 7, mil_bias)
        self.layer2 = TransLayer(inner_dim, n_heads, use_flash, parity)
        self.norm = nn.LayerNorm(inner_dim, eps=1e-5)
        self.classifier = dense(inner_dim, n_classes, mil_bias)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None, return_attn: bool = False,
                coords: Optional[torch.Tensor] = None):
        """``{"logits", "bag_feat"[, "attn", "attns"]}``. Under a mesh that
        splits the instances (``parallel/mesh.py``, ``sp > 1``) ``feats``,
        ``mask`` and ``coords`` are this rank's block, as in
        ``SAttentionBaseline``: the cls token goes in front of sp rank 0's
        block, both TransLayers and the positional module run on the block
        in the whole sequence's layout, the cls row comes from rank 0
        (``sp_first``), the logits are the whole bag's on every rank and
        the returned attention is this block's (the cls column dropped on
        rank 0 only)."""
        b = feats.shape[0]
        mask = mask.bool()
        seq = seq_layout(feats.shape[1], feats.device)
        x = self.in_norm(feats) if self.mil_norm == "ln" else feats
        x = self.feature(x, training, gen, seq)
        c = 1 if seq is None or seq.index == 0 else 0  # this rank holds the cls token
        if c:
            x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
            full_mask = torch.cat([mask.new_ones((b, 1)), mask], dim=1)
        else:
            full_mask = mask
        kw = {} if seq is None else {"seq": seq.prepend(1)}

        attns = []
        if return_attn:
            x, a, *_ = self.layer1(x, full_mask, True, training, gen, **kw)
            attns.append(a[:, :, c:])  # drop the cls column
        else:
            x = self.layer1(x, full_mask, False, training, gen, **kw)
        if self.pos_layer is not None:
            extra = (coords,) if self.pos == "sincos" else ()
            pos_kw = {} if seq is None else {"seq": seq}
            x = torch.cat([x[:, :c], self.pos_layer(x[:, c:], mask, *extra, **pos_kw)], dim=1)
        if return_attn:
            x, a, *_ = self.layer2(x, full_mask, True, training, gen, **kw)
            attns.append(a[:, :, c:])
        else:
            x = self.layer2(x, full_mask, False, training, gen, **kw)

        cls = x[:, 0] if seq is None else sp_first(x[:, 0], kw["seq"])
        x = self.norm(cls)  # LayerNorm is per token
        out = {"logits": self.classifier(x), "bag_feat": x}
        if return_attn:
            out["attn"] = attns[-1]
            out["attns"] = attns
        return out
