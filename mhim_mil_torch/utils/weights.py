"""Flax parameter tree → the port's ``state_dict`` (for MHIM the reverse of
``import_mhim_selfattn``, ``import_mhim_attn``, ``import_mhim_dsmil`` and
``import_merge`` in ``mhim_mil_tpu/utils/torch_import.py``; for the zoo
:func:`abmil_state_from_flax`, :func:`mean_max_state_from_flax`,
:func:`transmil_state_from_flax` and :func:`dsmil_state_from_flax`, the
reverses of ``import_abmil``, ``import_transmil`` and ``import_dsmil`` where
those exist; for ``2dmamba`` and ``mambamil``, which have no importer
there, :func:`mamba2d_state_from_flax` and :func:`mambamil_state_from_flax`;
for the rest of the classification zoo
:func:`clam_state_from_flax`, :func:`dtfd_state_from_flax`,
:func:`ibmil_state_from_flax` and :func:`rrtmil_state_from_flax`, the
reverses of ``import_clam``, ``import_dtfd``, ``import_ibmil`` and
``import_rrtmil`` and beyond them where those read no such weights; for
the patch encoders :func:`encoder_state_dict_from_flax`, the reverse of the
``import_*`` functions of ``mhim_mil_tpu/preprocess/encoders.py``).

The port keeps the original PyTorch repo's names, so the JAX package's
importer maps a port ``state_dict`` straight back onto the flax tree:
flax ``Dense.kernel [in,out]`` ↔ torch ``Linear.weight [out,in]``, LayerNorm
``scale`` ↔ ``weight``, depthwise conv ``kernel [kh,kw,1,C]`` ↔
``weight [C,1,kh,kw]``, the value-residual ``kernel [33,1,1,H]`` ↔
``res_conv.weight [H,1,33,1]``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear(sd: Dict, prefix: str, p: Mapping):
    sd[f"{prefix}.weight"] = _t(p["kernel"]).t().contiguous()
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(sd: Dict, prefix: str, p: Mapping):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd: Dict, prefix: str, p: Mapping):
    sd[f"{prefix}.weight"] = _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def translayer_state(sd: Dict, prefix: str, p: Mapping):
    """A ``TransLayer``'s flax params into ``sd`` under ``prefix`` (ending in "." or empty)."""
    _layernorm(sd, f"{prefix}norm", p["norm"])
    _linear(sd, f"{prefix}attn.to_qkv", p["attn"]["to_qkv"])
    _linear(sd, f"{prefix}attn.to_out.0", p["attn"]["to_out"])
    _conv(sd, f"{prefix}attn.res_conv", p["attn"]["res_conv"])


def ppeg_state(sd: Dict, prefix: str, p: Mapping):
    """A ``PPEG``'s flax params into ``sd`` under ``prefix``."""
    for name in ("proj", "proj1", "proj2"):
        _conv(sd, f"{prefix}{name}", p[name])


def pos_state(sd: Dict, prefix: str, p: Optional[Mapping]):
    """A positional module's flax params into ``sd`` under ``prefix``: PPEG
    (``proj``, ``proj1``, ``proj2``), PEG (``proj``), or nothing (SINCOS
    and ``none`` have no parameters)."""
    if p is None:
        return
    if "proj1" in p:
        ppeg_state(sd, prefix, p)
    else:
        _conv(sd, f"{prefix}proj", p["proj"])


def sattention_state(sd: Dict, prefix: str, p: Mapping):
    """A ``SAttentionBaseline``'s flax params into ``sd`` under ``prefix``."""
    sd[f"{prefix}cls_token"] = _t(p["cls_token"])
    translayer_state(sd, f"{prefix}layer1.", p["layer1"])
    pos_state(sd, f"{prefix}pos_embedding.", p.get("pos_embedding"))
    translayer_state(sd, f"{prefix}layer2.", p["layer2"])
    _layernorm(sd, f"{prefix}norm", p["norm"])


def bclassifier_state(sd: Dict, prefix: str, p: Mapping):
    """A DSMIL ``BClassifier``'s flax params into ``sd`` under ``prefix``, by
    the names ``import_dsmil`` reads: ``q0``/``q1`` as ``q.0``/``q.2``, ``v``
    as ``v.1``, and the dense ``fcc`` kernel ``[C·D, C]`` (input index
    ``c_in·D + d``) as the ``Conv1d(C, C, kernel_size=D)`` weight ``[C, C, D]``."""
    _linear(sd, f"{prefix}q.0", p["q0"])
    _linear(sd, f"{prefix}q.2", p["q1"])
    _linear(sd, f"{prefix}v.1", p["v"])
    k = _t(p["fcc"]["kernel"])
    c = k.shape[1]
    sd[f"{prefix}fcc.weight"] = k.reshape(c, -1, c).permute(2, 0, 1).contiguous()
    if "bias" in p["fcc"]:
        sd[f"{prefix}fcc.bias"] = _t(p["fcc"]["bias"])


def dattention_state(sd: Dict, prefix: str, p: Mapping):
    """A ``DAttentionBaseline``'s flax params into ``sd`` under ``prefix``
    (the reference's ``attention.attention.{0,2}``, as ``import_mhim_attn`` reads them)."""
    _linear(sd, f"{prefix}attention.attention.0", p["attention"]["attn_a"])
    _linear(sd, f"{prefix}attention.attention.2", p["attention"]["attn_c"])


def merge_state(sd: Dict, prefix: str, p: Mapping, buffers: Optional[Mapping] = None):
    """A ``Merge``'s flax params and, when ``buffers`` is given, its
    ``global_q`` buffer into ``sd`` under ``prefix``, by the names
    ``import_merge`` reads."""
    _layernorm(sd, f"{prefix}norm", p["norm"])
    _linear(sd, f"{prefix}attn.to_kv", p["attn"]["to_kv"])
    _linear(sd, f"{prefix}attn.to_q", p["attn"]["to_q"])
    _linear(sd, f"{prefix}attn.to_out.0", p["attn"]["to_out"])
    if buffers is not None:
        sd[f"{prefix}global_q_mm"] = _t(buffers["global_q"])


def state_dict_from_flax(params: Mapping, buffers: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's MHIM (``selfattn`` with any ``pos``,
    ``attn`` or ``dsmil`` baseline, told apart by the encoder's params) from the JAX package's
    ``params`` and, when they hold a ``merge`` subtree, its ``buffers``
    collection (``model_state["buffers"]``, which carries ``global_q``).
    Without ``buffers`` the result has the merge parameters but no
    ``merge.global_q_mm`` (the teacher init of a JAX ``.ckpt`` reads params
    only); a ``mhim_pure`` tree has no ``merge`` at all."""
    unknown = sorted(set(params) - {"feature", "online_encoder", "predictor", "merge"})
    if unknown:
        raise ValueError(f"state_dict_from_flax: unknown subtrees {unknown}")
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "feature.0", params["feature"]["proj"])
    enc = params["online_encoder"]
    if "attention" in enc:
        dattention_state(sd, "online_encoder.", enc)
    elif "b_classifier" in enc:  # dsmil: no predictor (import_mhim_dsmil)
        _linear(sd, "online_encoder.i_classifier.0", enc["i_classifier"])
        bclassifier_state(sd, "online_encoder.b_classifier.", enc["b_classifier"])
    else:
        sattention_state(sd, "online_encoder.", enc)
    if "predictor" in params:
        _linear(sd, "predictor", params["predictor"])
    if "merge" in params:
        merge_state(sd, "merge.", params["merge"], None if buffers is None else buffers["merge"])
    return sd


def abmil_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``ABMIL`` (``abmil`` or ``gabmil``)
    from the JAX ``ABMIL``'s params: ``FeatureEmbed_0/proj`` as
    ``feature.0``; the tanh pool's ``attn_a``/``attn_c`` as
    ``attention.0``/``.2``, or the gated pool's ``attn_a``/``attn_b``/
    ``attn_c`` as ``attention_a.0``/``attention_b.0``/``attention_c``;
    ``LayerNorm_0``/``LayerNorm_1`` (``mil_norm="ln"``) as ``norm``/``norm1``;
    ``classifier``."""
    sd: Dict[str, torch.Tensor] = {}
    if "LayerNorm_0" in params:
        _layernorm(sd, "norm", params["LayerNorm_0"])
        _layernorm(sd, "norm1", params["LayerNorm_1"])
    _linear(sd, "feature.0", params["FeatureEmbed_0"]["proj"])
    if "GatedAttentionPool_0" in params:
        pool = params["GatedAttentionPool_0"]
        _linear(sd, "attention_a.0", pool["attn_a"])
        _linear(sd, "attention_b.0", pool["attn_b"])
        _linear(sd, "attention_c", pool["attn_c"])
    else:
        pool = params["TanhAttentionPool_0"]
        _linear(sd, "attention.0", pool["attn_a"])
        _linear(sd, "attention.2", pool["attn_c"])
    _linear(sd, "classifier", params["classifier"])
    return sd


def mean_max_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``MeanMIL`` or ``MaxMIL``:
    ``FeatureEmbed_0/proj`` as ``feature.0``, and ``classifier``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "feature.0", params["FeatureEmbed_0"]["proj"])
    _linear(sd, "classifier", params["classifier"])
    return sd


def transmil_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``TransMIL`` (the reverse of
    ``import_transmil``): ``LayerNorm_0`` (``mil_norm="ln"``) as
    ``in_norm``, ``FeatureEmbed_0/proj`` as ``feature.0``, ``cls_token``,
    ``layer1``/``layer2``, ``pos_layer`` (PPEG or PEG), ``norm`` and
    ``classifier``."""
    sd: Dict[str, torch.Tensor] = {}
    if "LayerNorm_0" in params:
        _layernorm(sd, "in_norm", params["LayerNorm_0"])
    _linear(sd, "feature.0", params["FeatureEmbed_0"]["proj"])
    sd["cls_token"] = _t(params["cls_token"])
    translayer_state(sd, "layer1.", params["layer1"])
    pos_state(sd, "pos_layer.", params.get("pos_layer"))
    translayer_state(sd, "layer2.", params["layer2"])
    _layernorm(sd, "norm", params["norm"])
    _linear(sd, "classifier", params["classifier"])
    return sd


def dsmil_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``DSMIL`` (the reverse of
    ``import_dsmil``): ``LayerNorm_0`` (``mil_norm="ln"``) as ``in_norm``,
    ``feature`` as ``feature.0``, ``i_classifier`` and ``b_classifier``
    (:func:`bclassifier_state`)."""
    sd: Dict[str, torch.Tensor] = {}
    if "LayerNorm_0" in params:
        _layernorm(sd, "in_norm", params["LayerNorm_0"])
    _linear(sd, "feature.0", params["feature"])
    _linear(sd, "i_classifier", params["i_classifier"])
    bclassifier_state(sd, "b_classifier.", params["b_classifier"])
    return sd


def _rmsnorm(sd: Dict, prefix: str, p: Mapping):
    sd[f"{prefix}.weight"] = _t(p["weight"])


def _mamba_layers(sd: Dict, params: Mapping):
    """``layer{i}/norm`` and ``layer{i}/mixer`` as ``layers.{i}.*``: the
    mixer's ``in_proj``, ``out_proj`` and each branch's ``conv1d``,
    ``x_proj``, three inner RMSNorms, ``dt_proj``, ``A_log``, ``D`` (the
    second branch's with the suffix ``_b``: ``conv1d_b`` … ``A_b_log``,
    ``D_b``, where the mixer has it). The flax 1D conv kernel ``[k, 1, C]``
    becomes the torch weight ``[C, 1, k]``."""
    layers = sorted((k for k in params if k.startswith("layer")), key=lambda k: int(k[5:]))
    for i, name in enumerate(layers):
        pre, p = f"layers.{i}", params[name]
        _rmsnorm(sd, f"{pre}.norm", p["norm"])
        m = p["mixer"]
        for lin in ("in_proj", "out_proj"):
            _linear(sd, f"{pre}.mixer.{lin}", m[lin])
        for sfx in ("", "_b") if "conv1d_b" in m else ("",):
            for lin in ("x_proj", "dt_proj"):
                _linear(sd, f"{pre}.mixer.{lin}{sfx}", m[f"{lin}{sfx}"])
            conv = m[f"conv1d{sfx}"]
            sd[f"{pre}.mixer.conv1d{sfx}.weight"] = _t(conv["kernel"]).permute(2, 1, 0).contiguous()
            sd[f"{pre}.mixer.conv1d{sfx}.bias"] = _t(conv["bias"])
            for norm in ("dt_layernorm", "B_layernorm", "C_layernorm"):
                _rmsnorm(sd, f"{pre}.mixer.{norm}{sfx}", m[f"{norm}{sfx}"])
            sd[f"{pre}.mixer.A{sfx}_log"] = _t(m[f"A{sfx}_log"])
            sd[f"{pre}.mixer.D{sfx}"] = _t(m[f"D{sfx}"])


def mamba2d_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``MambaMIL2D`` from the JAX
    package's ``MambaMIL2D`` params: ``_fc1``, ``pos_embs`` and
    ``pad_token`` where the model has them, the layers
    (:func:`_mamba_layers`), ``norm``, ``attn_0`` / ``attn_1`` as
    ``attention.0`` / ``attention.2``, and ``classifier``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "_fc1", params["_fc1"])
    if "pos_embs" in params:
        _linear(sd, "pos_embs", params["pos_embs"])
    if "pad_token" in params:
        sd["pad_token"] = _t(params["pad_token"])
    _mamba_layers(sd, params)
    _layernorm(sd, "norm", params["norm"])
    _linear(sd, "attention.0", params["attn_0"])
    _linear(sd, "attention.2", params["attn_1"])
    _linear(sd, "classifier", params["classifier"])
    return sd


def mambamil_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``MambaMIL1D`` from the JAX
    package's ``MambaMIL1D`` params (the port's own map: the JAX package
    has no importer for it): ``_fc1``, the layers with both branches of an
    srmamba or bimamba mixer (:func:`_mamba_layers`), ``norm``,
    ``attn_0`` / ``attn_1`` as ``attention.0`` / ``attention.2``, and
    ``classifier``."""
    return mamba2d_state_from_flax(params)


def clam_state_from_flax(params: Mapping, dropout: bool = True) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``CLAM`` (SB or MB, gated or not)
    from the JAX ``CLAM``'s params: ``fc`` as ``attention_net.0``, the
    attention net at ``attention_net.3`` (``attention_net.2`` without
    ``dropout``: the reference's ``Sequential`` then holds no dropout) with
    the gated net's ``attention_a.0``/``attention_b.0``/``attention_c`` or
    the ungated's ``module.0`` and its last ``module`` index (3 with
    ``dropout``, 2 without), ``classifiers`` (SB) or the rows of
    ``classifiers_w``/``classifiers_b`` as ``classifiers.{c}`` (MB), the
    bank ``inst_classifiers_w [C,D,2]``/``_b`` as ``instance_classifiers.{c}``,
    and ``LayerNorm_0`` (``mil_norm="ln"``, which ``import_clam`` does not
    read) as ``in_norm``."""
    sd: Dict[str, torch.Tensor] = {}
    if "LayerNorm_0" in params:
        _layernorm(sd, "in_norm", params["LayerNorm_0"])
    _linear(sd, "attention_net.0", params["fc"])
    net, pre = params["attention_net"], f"attention_net.{3 if dropout else 2}"
    if "attention_b" in net:
        _linear(sd, f"{pre}.attention_a.0", net["attention_a"])
        _linear(sd, f"{pre}.attention_b.0", net["attention_b"])
        _linear(sd, f"{pre}.attention_c", net["attention_c"])
    else:
        _linear(sd, f"{pre}.module.0", net["attention_a"])
        _linear(sd, f"{pre}.module.{3 if dropout else 2}", net["attention_c"])
    if "classifiers_w" in params:
        for c, (w, b) in enumerate(zip(np.asarray(params["classifiers_w"]), np.asarray(params["classifiers_b"]))):
            sd[f"classifiers.{c}.weight"] = _t(w)[None]
            sd[f"classifiers.{c}.bias"] = _t(b).reshape(1)
    else:
        _linear(sd, "classifiers", params["classifiers"])
    for c, (w, b) in enumerate(zip(np.asarray(params["inst_classifiers_w"]),
                                   np.asarray(params["inst_classifiers_b"]))):
        _linear(sd, f"instance_classifiers.{c}", {"kernel": w, "bias": b})
    return sd


def _gated_attention(sd: Dict, prefix: str, p: Mapping):
    _linear(sd, f"{prefix}.attention_V.0", p["attention_V"])
    _linear(sd, f"{prefix}.attention_U.0", p["attention_U"])
    _linear(sd, f"{prefix}.attention_weights", p["attention_weights"])


def dtfd_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``DTFD`` (the reverse of
    ``import_dtfd``): ``dimReduction.fc1``, ``attention``, ``classifier.fc``,
    ``UClassifier.attention`` and ``UClassifier.classifier.fc``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "dimReduction.fc1", params["dimReduction"])
    _gated_attention(sd, "attention", params["attention"])
    _linear(sd, "classifier.fc", params["classifier"])
    _gated_attention(sd, "UClassifier.attention", params["u_attention"])
    _linear(sd, "UClassifier.classifier.fc", params["u_classifier"])
    return sd


def ibmil_state_from_flax(params: Mapping, confounders: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``IBMIL`` (the reverse of
    ``import_ibmil``): ``embedding.embed.0``, ``attention.{0,2}``, ``W_q``
    and ``W_k`` where the model has a bank, ``head``, and the bank
    ``confounders`` (a constructor argument of the JAX model, not a
    parameter) as the buffer ``confounder_feat``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "embedding.embed.0", params["embedding"]["proj"])
    _linear(sd, "attention.0", params["attn_0"])
    _linear(sd, "attention.2", params["attn_1"])
    if "W_q" in params:
        _linear(sd, "W_q", params["W_q"])
        _linear(sd, "W_k", params["W_k"])
    if confounders is not None:
        sd["confounder_feat"] = _t(confounders)
    _linear(sd, "head", params["head"])
    return sd


def _rrt_inner_attention(sd: Dict, prefix: str, p: Mapping):
    _linear(sd, f"{prefix}.qkv", p["qkv"])
    _linear(sd, f"{prefix}.proj", p["proj"])
    if "pe" in p:
        _conv(sd, f"{prefix}.pe", p["pe"])


def rrtmil_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``RRTMIL`` (the reverse of
    ``import_rrtmil``): ``FeatureEmbed_0/proj`` as ``feature.0``, the
    encoder's ``layer{i}`` as ``online_encoder.layers.{i}`` (``norm``,
    ``attn.attn.qkv``/``proj``/``pe``, the EPEG kernel ``[k,1,1,H]`` as the
    depthwise ``Conv2d`` weight ``[H,1,k,1]``), ``cr_msa`` (``norm``,
    ``attn.phi``, ``attn.attn``), ``norm``, the pool ``pool_fn`` as
    ``pool_fn.attention.attention.{0,2}``, or, gated (``da_gated``, which
    ``import_rrtmil`` does not read), as ``pool_fn.attention.attention_a.0``,
    ``attention_b.0`` and ``attention_c``; and ``predictor``."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "feature.0", params["FeatureEmbed_0"]["proj"])
    enc = params["online_encoder"]
    layers = sorted((k for k in enc if k.startswith("layer")), key=lambda k: int(k[5:]))
    for i, name in enumerate(layers):
        _layernorm(sd, f"online_encoder.layers.{i}.norm", enc[name]["norm"])
        _rrt_inner_attention(sd, f"online_encoder.layers.{i}.attn.attn", enc[name]["attn"]["attn"])
    _layernorm(sd, "online_encoder.cr_msa.norm", enc["cr_msa"]["norm"])
    sd["online_encoder.cr_msa.attn.phi"] = _t(enc["cr_msa"]["attn"]["phi"])
    _rrt_inner_attention(sd, "online_encoder.cr_msa.attn.attn", enc["cr_msa"]["attn"]["attn"])
    _layernorm(sd, "online_encoder.norm", enc["norm"])
    pool = params["pool_fn"]
    if "attn_b" in pool:
        _linear(sd, "pool_fn.attention.attention_a.0", pool["attn_a"])
        _linear(sd, "pool_fn.attention.attention_b.0", pool["attn_b"])
        _linear(sd, "pool_fn.attention.attention_c", pool["attn_c"])
    else:
        _linear(sd, "pool_fn.attention.attention.0", pool["attn_a"])
        _linear(sd, "pool_fn.attention.attention.2", pool["attn_c"])
    _linear(sd, "predictor", params["predictor"])
    return sd


# ---- the patch encoders (preprocess/encoders.py) ------------------------------------


def _batchnorm(sd: Dict, prefix: str, p: Mapping, stats: Mapping):
    _layernorm(sd, prefix, p)
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _resnet_encoder_state(sd: Dict, params: Mapping, stats: Mapping):
    _conv(sd, "conv1", params["conv1"])
    _batchnorm(sd, "bn1", params["bn1"], stats["bn1"])
    for blk in (k for k in params if k.startswith("layer")):
        base = blk.replace("_", ".")
        p, s = params[blk], stats[blk]
        for ci in (1, 2, 3):
            if f"conv{ci}" in p:
                _conv(sd, f"{base}.conv{ci}", p[f"conv{ci}"])
                _batchnorm(sd, f"{base}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
        if "downsample_conv" in p:
            _conv(sd, f"{base}.downsample.0", p["downsample_conv"])
            _batchnorm(sd, f"{base}.downsample.1", p["downsample_bn"], s["downsample_bn"])


def _vit_encoder_state(sd: Dict, params: Mapping):
    _conv(sd, "patch_embed.proj", params["patch_embed"])
    sd["cls_token"] = _t(params["cls_token"])
    sd["pos_embed"] = _t(params["pos_embed"])
    _layernorm(sd, "norm", params["norm"])
    for i in range(sum(1 for k in params if k.startswith("block"))):
        p, base = params[f"block{i}"], f"blocks.{i}"
        _layernorm(sd, f"{base}.norm1", p["norm1"])
        _linear(sd, f"{base}.attn.qkv", p["qkv"])
        _linear(sd, f"{base}.attn.proj", p["attn_proj"])
        _layernorm(sd, f"{base}.norm2", p["norm2"])
        _linear(sd, f"{base}.mlp.fc1", p["fc1"])
        _linear(sd, f"{base}.mlp.fc2", p["fc2"])
        for ls in ("ls1", "ls2"):
            if ls in p:
                sd[f"{base}.{ls}.gamma"] = _t(p[ls])


def _clip_encoder_state(sd: Dict, params: Mapping):
    _conv(sd, "conv1", params["conv1"])
    sd["class_embedding"] = _t(params["class_embedding"])
    sd["positional_embedding"] = _t(params["positional_embedding"])
    _layernorm(sd, "ln_pre", params["ln_pre"])
    _layernorm(sd, "ln_post", params["ln_post"])
    for i in range(sum(1 for k in params if k.startswith("resblock"))):
        p, base = params[f"resblock{i}"], f"transformer.resblocks.{i}"
        _layernorm(sd, f"{base}.ln_1", p["ln_1"])
        sd[f"{base}.attn.in_proj_weight"] = _t(p["in_proj"]["kernel"]).t().contiguous()
        sd[f"{base}.attn.in_proj_bias"] = _t(p["in_proj"]["bias"])
        _linear(sd, f"{base}.attn.out_proj", p["out_proj"])
        _layernorm(sd, f"{base}.ln_2", p["ln_2"])
        _linear(sd, f"{base}.mlp.c_fc", p["c_fc"])
        _linear(sd, f"{base}.mlp.c_proj", p["c_proj"])


def _swin_encoder_state(sd: Dict, params: Mapping, stats: Mapping):
    pe, st = params["patch_embed"], stats["patch_embed"]
    _conv(sd, "patch_embed.proj.0", pe["conv0"])
    _batchnorm(sd, "patch_embed.proj.1", pe["bn0"], st["bn0"])
    _conv(sd, "patch_embed.proj.3", pe["conv1"])
    _batchnorm(sd, "patch_embed.proj.4", pe["bn1"], st["bn1"])
    _conv(sd, "patch_embed.proj.6", pe["conv2"])
    _layernorm(sd, "patch_embed.norm", pe["norm"])
    for name, p in params.items():
        if name.startswith("stage"):
            si, bi = name[5:].split("_block")
            base = f"layers.{si}.blocks.{bi}"
            _layernorm(sd, f"{base}.norm1", p["norm1"])
            _linear(sd, f"{base}.attn.qkv", p["attn"]["qkv"])
            _linear(sd, f"{base}.attn.proj", p["attn"]["proj"])
            sd[f"{base}.attn.relative_position_bias_table"] = _t(p["attn"]["rel_bias_table"])
            _layernorm(sd, f"{base}.norm2", p["norm2"])
            _linear(sd, f"{base}.mlp.fc1", p["fc1"])
            _linear(sd, f"{base}.mlp.fc2", p["fc2"])
        elif name.startswith("merge"):  # old timm: the merge at the end of stage si
            _layernorm(sd, f"layers.{name[5:]}.downsample.norm", p["norm"])
            _linear(sd, f"layers.{name[5:]}.downsample.reduction", p["reduction"])
    _layernorm(sd, "norm", params["norm"])


def _vae_encoder_state(sd: Dict, params: Mapping):
    def resnet(dst, p):
        for part in ("norm1", "norm2"):
            _layernorm(sd, f"{dst}.{part}", p[part])
        for part in ("conv1", "conv2", "conv_shortcut"):
            if part in p:
                _conv(sd, f"{dst}.{part}", p[part])

    _conv(sd, "encoder.conv_in", params["conv_in"])
    for name, p in params.items():
        if name.startswith("down") and "_res" in name:
            i, j = name[4:].split("_res")
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", p)
        elif name.startswith("down"):
            _conv(sd, f"encoder.down_blocks.{name[4:].split('_')[0]}.downsamplers.0.conv", p)
    for j in (0, 1):
        resnet(f"encoder.mid_block.resnets.{j}", params[f"mid_res{j}"])
    ab, p = "encoder.mid_block.attentions.0", params["mid_attn"]
    _layernorm(sd, f"{ab}.group_norm", p["group_norm"])
    for part in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{ab}.{part}", p[part])
    _linear(sd, f"{ab}.to_out.0", p["to_out"])
    _layernorm(sd, "encoder.conv_norm_out", params["conv_norm_out"])
    _conv(sd, "encoder.conv_out", params["conv_out"])
    _conv(sd, "quant_conv", params["quant_conv"])


def encoder_state_dict_from_flax(name: str, variables: Mapping) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's encoder ``name`` (``preprocess.encoders``)
    from the JAX encoder's ``variables`` (``params`` and, for the ResNets and
    CHIEF, ``batch_stats``), in the upstream names: the reverse of
    ``import_resnet_trunc``, ``import_vit``, ``import_clip_visual`` (or, for a
    ``conch_v1`` CoCa trunk, ``import_vit``), ``import_swin_chief`` (old
    timm's merge layout) and ``import_sd_vae`` (modern attention names)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    if name in ("resnet50_trunc", "r18"):
        _resnet_encoder_state(sd, params, stats)
    elif name in ("uni_v1", "gigap") or (name == "conch_v1" and "patch_embed" in params):
        _vit_encoder_state(sd, params)
    elif name == "conch_v1":
        _clip_encoder_state(sd, params)
    elif name == "chief":
        _swin_encoder_state(sd, params, stats)
    elif name == "sd_vae":
        _vae_encoder_state(sd, params)
    else:
        raise ValueError(f"encoder_state_dict_from_flax: unknown encoder {name!r}")
    return sd
