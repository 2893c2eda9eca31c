"""Model factory (port of ``mhim_mil_tpu/models/registry.py``).

Ported: ``model=mhim`` and ``model=mhim_pure`` with the ``selfattn`` or
``attn`` baseline (families ``mhim`` and ``mhim_pure``) and ``2dmamba``
(family ``mamba2d``); anything else raises.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..utils.platform import resolve_device
from .layers import init_weights
from .mamba import MambaMIL2D
from .mhim import MHIM


def build_model(
    cfg,
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.nn.Module, str]:
    """Build ``(model, family)`` on ``device`` (CUDA unless ``"cpu"`` is asked
    for), in eval mode, with weights drawn from ``generator`` (default: a CPU
    generator seeded with ``cfg.seed``); with ``merge_enable`` (never for
    ``mhim_pure``) it holds the Merge module. ``cfg.use_flash_attn=False``
    selects the plain attention, pooling and 2D scan instead of the kernels."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    if cfg.model == "2dmamba":
        model = MambaMIL2D(
            input_dim=cfg.input_dim,
            n_classes=cfg.n_classes,
            dim=cfg.mambamil_dim,
            n_layers=cfg.mambamil_layer,
            d_state=cfg.mambamil_state_dim,
            dropout=cfg.dropout,
            max_w=cfg.mamba_2d_max_w or cfg.mamba_2d_max_hw,
            max_h=cfg.mamba_2d_max_h or cfg.mamba_2d_max_hw,
            pad_token_mode=cfg.mamba_2d_pad_token,
            pos_emb_type=cfg.mamba_2d_pos_emb_type or "none",
            pos_emb_dropout=cfg.pos_emb_dropout,
            use_flash=cfg.use_flash_attn is not False,
        )
        return init_weights(model, generator).to(device).eval(), "mamba2d"
    if cfg.model not in ("mhim", "mhim_pure") or cfg.baseline not in ("selfattn", "attn") \
            or (cfg.pos or "ppeg") != "ppeg":
        raise NotImplementedError(
            f"model={cfg.model!r} baseline={cfg.baseline!r} pos={cfg.pos!r}: only 2dmamba, and "
            "mhim / mhim_pure with the selfattn (ppeg) or attn baseline, are ported"
        )
    # mhim_pure, the teacher stage: the same MHIM without mining or merge
    # (JAX registry.py:122-161, reference modules/__init__.py:101-102)
    pure = cfg.model == "mhim_pure"
    model = MHIM(
        input_dim=cfg.input_dim,
        mlp_dim=cfg.inner_dim,
        n_classes=cfg.n_classes,
        dropout=cfg.dropout,
        act=cfg.act,
        baseline=cfg.baseline,
        heads=cfg.n_heads,
        da_act=cfg.da_act,
        mask_ratio=0.0 if pure else cfg.mask_ratio,
        mask_ratio_l=0.0 if pure else cfg.mask_ratio_l,
        mask_ratio_h=0.0 if pure else cfg.mask_ratio_h,
        mask_ratio_hr=cfg.mask_ratio_hr,
        msa_fusion=cfg.msa_fusion,
        attn_layer=cfg.attn_layer,
        attn2score=cfg.attn2score,
        temp_t=cfg.temp_t,
        merge_enable=False if pure else cfg.merge_enable,
        merge_k=cfg.merge_k,
        merge_mm=cfg.merge_mm,
        merge_ratio=cfg.merge_ratio,
        merge_test=cfg.merge_test,
        use_flash=cfg.use_flash_attn is not False,
    )
    init_weights(model, generator)
    return model.to(device).eval(), cfg.model
