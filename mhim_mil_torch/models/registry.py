"""Model factory (port of ``mhim_mil_tpu/models/registry.py``).

Ported: ``mhim`` and ``mhim_pure`` with the ``selfattn`` (``pos`` ppeg,
sincos, peg or none), ``attn`` or ``dsmil`` baseline (families ``mhim``
and ``mhim_pure``); ``abmil``, ``gabmil``, ``meanmil``, ``maxmil``,
``transmil``, ``dtfd``, ``ibmil`` and ``rrtmil`` (family ``default``);
``clam_sb`` and ``clam_mb`` (family ``clam``, whose training forward takes
the bag label); ``dsmil`` (family ``dsmil``); ``2dmamba`` (family
``mamba2d``); and ``mambamil`` (family ``default``), whose
``--mambamil_type`` selects the simple, srmamba or bimamba block. Every
model of the JAX registry builds.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.platform import resolve_device
from .abmil import ABMIL
from .clam import CLAM
from .dsmil import DSMIL
from .dtfd import DTFD
from .ibmil import IBMIL
from .layers import init_weights
from .mamba import MambaMIL1D, MambaMIL2D
from .mean_max import MaxMIL, MeanMIL
from .mhim import MHIM
from .rrt import RRTMIL
from .transformer import TransMIL

NOT_PORTED: Tuple[str, ...] = ()  # the JAX registry's models that the port does not build: none

# --mambamil_type (JAX registry.py:208-230, reference options.py:158): Mamba
# and SimpleMamba are both the single-branch block.
MAMBAMIL_VARIANTS = {None: "simple", "none": "simple", "mamba": "simple", "simplemamba": "simple",
                     "srmamba": "srmamba", "bimamba": "bimamba"}


def _mil_norm(cfg):
    return None if cfg.mil_norm in (None, "none") else cfg.mil_norm


def load_confounders(cfg) -> Optional[np.ndarray]:
    """IBMIL's bank from ``--confounder_path`` (``registry.py:282-304``): a
    file, or a directory, which selects
    ``train_bag_cls_agnostic_feats_proto_{confounder_k}.npy`` in it, else in
    its ``0/`` (the reference's ``<dir>/[fold/]`` scheme); a list of them is
    concatenated. Each file is read as rows of ``inner_dim``. None without
    a path."""
    if not cfg.confounder_path:
        return None
    paths = cfg.confounder_path if isinstance(cfg.confounder_path, (list, tuple)) else [cfg.confounder_path]
    proto = f"train_bag_cls_agnostic_feats_proto_{cfg.confounder_k}.npy"
    resolved = []
    for p in paths:
        if os.path.isdir(p):
            cand = os.path.join(p, proto)
            resolved.append(cand if os.path.exists(cand) else os.path.join(p, "0", proto))
        else:
            resolved.append(p)
    return np.concatenate([np.load(p).reshape(-1, cfg.inner_dim) for p in resolved], axis=0)


def _zoo(cfg, use_flash: bool):
    """The zoo models of ``registry.py:35-111,164-184,208-335``: ``(model, family)``."""
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
    if cfg.model in ("clam_sb", "clam_mb"):
        return CLAM(input_dim=cfg.input_dim, n_classes=cfg.n_classes, inner_dim=cfg.inner_dim, dropout=cfg.dropout,
                    act=cfg.act, multi_branch=cfg.model == "clam_mb", mil_norm=_mil_norm(cfg),
                    mil_bias=cfg.mil_bias), "clam"
    if cfg.model == "dtfd":
        return DTFD(input_dim=cfg.input_dim, n_classes=cfg.n_classes, inner_dim=cfg.inner_dim, act=cfg.act), "default"
    if cfg.model == "ibmil":
        return IBMIL(input_dim=cfg.input_dim, n_classes=cfg.n_classes, inner_dim=cfg.inner_dim, dropout=cfg.dropout,
                     act=cfg.act, confounders=load_confounders(cfg)), "default"
    if cfg.model == "rrtmil":
        return RRTMIL(input_dim=cfg.input_dim, n_classes=cfg.n_classes, inner_dim=cfg.inner_dim,
                      dropout=cfg.dropout, act=cfg.act, da_act=cfg.da_act, da_gated=cfg.da_gated,
                      n_layers=cfg.rrt_n_layers, n_heads=cfg.rrt_n_heads, region_num=cfg.region_num,
                      epeg_k=cfg.epeg_k, crmsa_k=cfg.crmsa_k, mil_bias=cfg.mil_bias), "default"
    if cfg.model == "mambamil":
        return MambaMIL1D(input_dim=cfg.input_dim, n_classes=cfg.n_classes, dim=cfg.mambamil_dim,
                          n_layers=cfg.mambamil_layer, d_state=cfg.mambamil_state_dim, dropout=cfg.dropout,
                          variant=MAMBAMIL_VARIANTS[(cfg.mambamil_type or "none").lower()],
                          sr_rate=cfg.mambamil_rate), "default"
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
