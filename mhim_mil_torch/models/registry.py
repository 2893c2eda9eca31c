"""Model factory (port of ``mhim_mil_tpu/models/registry.py``).

Ported: ``mhim`` and ``mhim_pure`` with the ``selfattn`` (``pos`` ppeg,
sincos, peg or none), ``attn`` or ``dsmil`` baseline (families ``mhim``
and ``mhim_pure``); ``abmil``, ``gabmil``, ``meanmil``, ``maxmil`` and
``transmil`` (family ``default``); ``dsmil`` (family ``dsmil``); and
``2dmamba`` (family ``mamba2d``). The other models of the JAX registry
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..utils.platform import resolve_device
from .abmil import ABMIL
from .dsmil import DSMIL
from .layers import init_weights
from .mamba import MambaMIL2D
from .mean_max import MaxMIL, MeanMIL
from .mhim import MHIM
from .transformer import TransMIL

NOT_PORTED = ("clam_sb", "clam_mb", "dtfd", "ibmil", "rrtmil", "mambamil")


def _mil_norm(cfg):
    return None if cfg.mil_norm in (None, "none") else cfg.mil_norm


def _zoo(cfg, use_flash: bool):
    """The zoo models of ``registry.py:35-111,164-184,319-335``: ``(model, family)``."""
    if cfg.model in ("abmil", "gabmil"):
        gated = cfg.model == "gabmil"
        return ABMIL(input_dim=cfg.input_dim, n_classes=cfg.n_classes, inner_dim=cfg.inner_dim,
                     dropout=cfg.dropout, act=cfg.act, mil_norm=None if gated else _mil_norm(cfg),
                     mil_bias=cfg.mil_bias, gated=gated, pos=cfg.pos, use_flash=use_flash), "default"
    if cfg.model in ("meanmil", "maxmil"):
        cls = MeanMIL if cfg.model == "meanmil" else MaxMIL
        return cls(cfg.input_dim, cfg.n_classes, cfg.inner_dim, cfg.dropout, cfg.act), "default"
    if cfg.model == "transmil":
        return TransMIL(input_dim=cfg.input_dim, n_classes=cfg.n_classes, inner_dim=cfg.inner_dim,
                        dropout=cfg.dropout, act=cfg.act, mil_norm=_mil_norm(cfg), mil_bias=cfg.mil_bias,
                        pos=cfg.pos or "ppeg", n_heads=cfg.n_heads, use_flash=use_flash), "default"
    if cfg.model == "dsmil":
        return DSMIL(input_dim=cfg.input_dim, n_classes=cfg.n_classes, inner_dim=cfg.inner_dim,
                     dropout=cfg.dropout, act=cfg.act, mil_norm=_mil_norm(cfg), mil_bias=cfg.mil_bias), "dsmil"
    return None, None


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
    use_flash = cfg.use_flash_attn is not False
    model, family = _zoo(cfg, use_flash)
    if model is not None:
        return init_weights(model, generator).to(device).eval(), family
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
            use_flash=use_flash,
        )
        return init_weights(model, generator).to(device).eval(), "mamba2d"
    if cfg.model in NOT_PORTED:
        raise NotImplementedError(f"model={cfg.model!r} is not ported yet (not ported: {', '.join(NOT_PORTED)})")
    if cfg.model not in ("mhim", "mhim_pure"):
        raise ValueError(f"unknown model {cfg.model!r}")
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
        use_flash=use_flash,
        pos=cfg.pos or "ppeg",
    )
    init_weights(model, generator)
    return model.to(device).eval(), cfg.model
