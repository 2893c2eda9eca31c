"""The port's patch encoders (``mhim_mil_torch/preprocess/encoders.py``)
against the JAX package's (``mhim_mil_tpu/preprocess/encoders.py``) on the
CPU: each family's port module with random weights from a seed, its
``state_dict`` read by JAX's ``import_*``, both run on the same numpy
inputs at the JAX tests' small shapes and tolerances (``tests/test_encoders.py``:
ResNet atol/rtol 1e-4; ViT atol 8e-4, rtol 1e-3; Swin and CLIP atol 1e-4,
rtol 1e-3; the VAE atol 2e-4, rtol 1e-3); ``get_encoder`` from the same
``.pt`` on both sides; and ``encoder_state_dict_from_flax`` against the
importers it reverses."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mhim_mil_tpu.preprocess import encoders as J
from mhim_mil_torch.preprocess import encoders as P
from mhim_mil_torch.utils.weights import encoder_state_dict_from_flax

RESNET_TOL = dict(atol=1e-4, rtol=1e-4)
VIT_TOL = dict(atol=8e-4, rtol=1e-3)
SWIN_CLIP_TOL = dict(atol=1e-4, rtol=1e-3)
VAE_TOL = dict(atol=2e-4, rtol=1e-3)


def _port(module, seed):
    return P.random_init_(module, torch.Generator().manual_seed(seed)).eval()


def _images(b, size, seed):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _run_port(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


def _run_jax(model, variables, x):
    return np.asarray(jax.jit(model.apply)(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))


def _small_vit(seed, ls=True, d=64, heads=4):
    return _port(P.ViTEncoder(d, 2, heads, layer_scale=ls), seed)


def _small_swin(seed):
    return _port(P.SwinChief(16, (1, 1, 2, 1), (1, 2, 4, 8)), seed)


def _small_clip(seed):
    return _port(P.CLIPVisualTower(64, 2, 1), seed)


def _small_vae(seed):
    return _port(P.SDVAEEncoder((32, 64), 1), seed)


def _new_timm_layout(sd):
    """Old timm's merge at the end of stage i moved to the start of stage i+1."""
    out = {}
    for k, v in sd.items():
        if ".downsample." in k:
            si = int(k.split(".")[1])
            k = k.replace(f"layers.{si}.downsample.", f"layers.{si + 1}.downsample.")
        out[k] = v
    return out


# ---- each family against JAX ---------------------------------------------------------


@pytest.mark.parametrize("depths,block", [((3, 4, 6), "bottleneck"), ((2, 2, 2), "basic")])
def test_resnet_trunc_matches_jax(depths, block):
    port = _port(P.ResNetTrunc(depths, block), 1)
    x = _images(2, 96, 0)
    want = _run_jax(J.ResNetTrunc(depths=depths, block=block), J.import_resnet_trunc(port.state_dict(), depths, block), x)
    got = _run_port(port, x)
    assert got.shape == (2, 1024 if block == "bottleneck" else 256)
    np.testing.assert_allclose(got, want, **RESNET_TOL)


@pytest.mark.parametrize("size", [224, 256, 192])
@pytest.mark.parametrize("ls", [True, False])
def test_vit_matches_jax(size, ls):
    """At 224 the 14 × 14 pos-embed grid is used as it is; at 256 it is
    enlarged to 16 × 16, at 192 shrunk to 12 × 12 (antialiased, as
    ``jax.image.resize`` does)."""
    port = _small_vit(2, ls)
    x = _images(2, size, 1)
    want = _run_jax(J.ViTEncoder(embed_dim=64, depth=2, heads=4, layer_scale=ls), J.import_vit(port.state_dict()), x)
    np.testing.assert_allclose(_run_port(port, x), want, **VIT_TOL)


@pytest.mark.parametrize("side,out", [(14, 16), (14, 12), (14, 7), (14, 13), (16, 14)])
def test_pos_grid_resize_matches_jax_image_resize(side, out):
    """The pos-embed resize alone, at unit scale (in the encoder the grid is
    0.02 × N(0, 1), too small for the features' tolerance to see a wrong
    filter)."""
    d = 32
    grid = np.random.default_rng(side * out).standard_normal((1, side * side, d)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(grid).reshape(1, side, side, d), (1, out, out, d), "bilinear"))
    got = P.resize_pos_grid(torch.from_numpy(grid), out, out).numpy()
    np.testing.assert_allclose(got, want.reshape(1, out * out, d), atol=1e-5, rtol=1e-5)
    if out < side:  # a shrink is antialiased: plain bilinear sampling would miss by far more
        plain = torch.nn.functional.interpolate(torch.from_numpy(grid).reshape(1, side, side, d).permute(0, 3, 1, 2),
                                                size=(out, out), mode="bilinear", align_corners=False)
        assert np.abs(plain.permute(0, 2, 3, 1).reshape(1, -1, d).numpy() - want.reshape(1, -1, d)).max() > 1e-2


@pytest.mark.parametrize("layout", ["old", "new"])
def test_swin_chief_matches_jax(layout):
    """Both timm layouts of the patch merging; the old one with the buffers
    old timm writes (``relative_position_index``, ``attn_mask``), which the
    loader drops."""
    port = _small_swin(3)
    x = _images(2, 224, 2)
    sd = port.state_dict()
    if layout == "new":
        sd = _new_timm_layout(sd)
    else:
        for name, buf in port.named_buffers():
            if name.endswith(("relative_position_index", "attn_mask")):
                sd[name] = buf
    want = _run_jax(J.SwinChief(embed_dim=16, depths=(1, 1, 2, 1), heads=(1, 2, 4, 8)), J.import_swin_chief(sd), x)
    loaded, sd2 = P._swin_from_sd(sd)
    P.load_encoder_state(loaded, sd2).eval()
    got = _run_port(loaded, x)
    np.testing.assert_allclose(got, _run_port(port, x), atol=0, rtol=0)
    np.testing.assert_allclose(got, want, **SWIN_CLIP_TOL)


def test_swin_chief_takes_224_only():
    with pytest.raises(ValueError, match="224x224"):
        _small_swin(0)(torch.zeros(1, 3, 256, 256))


def test_clip_visual_matches_jax():
    port = _small_clip(4)
    x = _images(2, 224, 3)
    want = _run_jax(J.CLIPVisualTower(embed_dim=64, depth=2, heads=1), J.import_clip_visual(port.state_dict()), x)
    np.testing.assert_allclose(_run_port(port, x), want, **SWIN_CLIP_TOL)
    with pytest.raises(ValueError, match="positional embedding"):
        _run_port(port, _images(1, 256, 0))


def test_sd_vae_matches_jax():
    port = _small_vae(5)
    x = _images(2, 32, 4)
    want = _run_jax(J.SDVAEEncoder(block_out_channels=(32, 64), layers_per_block=1),
                    J.import_sd_vae(port.state_dict()), x)
    got = _run_port(port, x)
    assert got.shape == (2, 4 * 16 * 16)  # [C, H/2, W/2] flattened: one downsampling
    np.testing.assert_allclose(got, want, **VAE_TOL)


# ---- the registry, from the same .pt on both sides -----------------------------------------


def _legacy_vae(sd):
    """diffusers' legacy mid-block attention names, with 1x1-conv weights."""
    names = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    out = {}
    ab = "encoder.mid_block.attentions.0."
    for k, v in sd.items():
        if k.startswith(ab):
            head, _, tail = k[len(ab):].rpartition(".")
            if head in names:
                k, v = f"{ab}{names[head]}.{tail}", (v[:, :, None, None] if tail == "weight" else v)
        out[k] = v
    out["decoder.conv_in.weight"] = torch.zeros(3)  # a full AutoencoderKL: the decoder is ignored
    out["post_quant_conv.weight"] = torch.zeros(3)
    return out


def _clip_with_text_tower(sd):
    """A full classic-CLIP checkpoint: the visual tower under ``visual.``,
    the text tower at the top level with dims that collide if leaked."""
    out = {f"visual.{k}": v for k, v in sd.items()}
    d = 32
    out.update({"positional_embedding": torch.randn(77, d), "text_projection": torch.randn(d, d),
                "logit_scale": torch.tensor(2.6592), "token_embedding.weight": torch.randn(99, d),
                "ln_final.weight": torch.randn(d), "ln_final.bias": torch.randn(d), "visual.proj": torch.randn(64, 16)})
    for bi in range(2):
        for part, shape in (("attn.in_proj_weight", (3 * d, d)), ("attn.in_proj_bias", (3 * d,)),
                            ("ln_1.weight", (d,)), ("mlp.c_fc.weight", (4 * d, d))):
            out[f"transformer.resblocks.{bi}.{part}"] = torch.randn(*shape)
    return out


REGISTRY_CASES = {
    # name: (port module, how the upstream file wraps its state_dict, input size)
    "resnet50_trunc": (lambda: P.ResNetTrunc(), lambda sd: {"state_dict": {f"model.{k}": v for k, v in sd.items()}}, 64),
    "r18": (lambda: P.ResNetTrunc((2, 2, 2), "basic"), lambda sd: sd, 64),
    # heads = 1 so that the registry's head_dim = 64 matches d = 64
    "uni_v1": (lambda: P.ViTEncoder(64, 2, 1), lambda sd: sd, 224),
    "gigap": (lambda: P.ViTEncoder(64, 2, 1), lambda sd: {f"model.{k}": v for k, v in sd.items()}, 256),
    "conch_v1": (lambda: P.CLIPVisualTower(64, 2, 1), _clip_with_text_tower, 224),
    "conch_v1-trunk": (lambda: P.ViTEncoder(64, 2, 1, layer_scale=False),
                       lambda sd: {f"visual.trunk.{k}": v for k, v in sd.items()}, 224),
    "chief": (lambda: P.SwinChief(16, (1, 1, 2, 1), (1, 2, 4, 8)), lambda sd: {"model": _new_timm_layout(sd)}, 224),
    "sd_vae": (lambda: P.SDVAEEncoder((32, 64), 1), _legacy_vae, 32),
}
REGISTRY_TOL = {"resnet50_trunc": RESNET_TOL, "r18": RESNET_TOL, "uni_v1": VIT_TOL, "gigap": VIT_TOL,
                "conch_v1": SWIN_CLIP_TOL, "conch_v1-trunk": VIT_TOL, "chief": SWIN_CLIP_TOL, "sd_vae": VAE_TOL}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_get_encoder_matches_jax(case, tmp_path):
    """``get_encoder(name, path)`` of both packages on one upstream-named
    file, in the wrapping each family's checkpoints come in: the port
    module's features equal the file's own weights and JAX's features."""
    make, wrap, size = REGISTRY_CASES[case]
    name = case.split("-")[0]
    source = _port(make(), 10 + len(case))
    path = str(tmp_path / f"{case}.pt")
    torch.save(wrap(source.state_dict()), path)
    module, norm = P.get_encoder(name, path, device="cpu")
    fn, jnorm = J.get_encoder(name, path)
    assert norm == jnorm == P.ENCODER_NORM[name]
    assert not module.training and next(module.parameters()).device.type == "cpu"
    x = _images(2, size, 5)
    got = _run_port(module, x)
    np.testing.assert_array_equal(got, _run_port(source, x))
    np.testing.assert_allclose(got, np.asarray(fn(jnp.asarray(x))), **REGISTRY_TOL[case])


@pytest.mark.parametrize("name", ["uni_v1", "gigap", "conch_v1", "chief", "sd_vae", "nope"])
def test_missing_checkpoint_raises_as_jax(name, monkeypatch):
    for env in P.ENCODER_CKPT_ENV.values():
        monkeypatch.delenv(env, raising=False)
    with pytest.raises(NotImplementedError) as want:
        J.get_encoder(name)
    with pytest.raises(NotImplementedError) as got:
        P.get_encoder(name, device="cpu")
    assert str(got.value) == str(want.value)
    assert ("not implemented" if name == "nope" else P.ENCODER_CKPT_ENV[name]) in str(got.value)


def test_env_var_checkpoint(tmp_path, monkeypatch):
    source = _small_vit(6, d=64, heads=1)
    path = tmp_path / "uni.pt"
    torch.save(source.state_dict(), path)
    monkeypatch.setenv("UNI_CKPT_PATH", str(path))
    module, _ = P.get_encoder("uni_v1", device="cpu")
    x = _images(1, 224, 6)
    np.testing.assert_array_equal(_run_port(module, x), _run_port(source, x))


def test_cnn_fallback_is_random_from_seed_zero(monkeypatch):
    monkeypatch.delenv("R18_CKPT_PATH", raising=False)
    with pytest.warns(UserWarning, match="RANDOM weights"):
        a, _ = P.get_encoder("r18", device="cpu")
    with pytest.warns(UserWarning, match="RANDOM weights"):
        b, _ = P.get_encoder("r18", device="cpu")
    want = P.random_init_(P.ResNetTrunc((2, 2, 2), "basic"), torch.Generator().manual_seed(0)).state_dict()
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]) and torch.equal(v, want[k]), k


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.get_encoder("r18")


def test_checkpoint_missing_a_key_raises(tmp_path):
    sd = _small_vit(7, d=64, heads=1).state_dict()
    del sd["blocks.1.mlp.fc2.bias"]
    path = tmp_path / "broken.pt"
    torch.save(sd, path)
    with pytest.raises(KeyError, match="blocks.1.mlp.fc2.bias"):
        P.get_encoder("uni_v1", str(path), device="cpu")


# ---- the weights carried across ------------------------------------------------------------


def _init(model, size, seed):
    """Variables of flax's own tree (``model.init``'s structure and shapes),
    filled from a seed."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


ROUND_TRIPS = {
    # name: (JAX model, input size, importer, port module)
    "resnet50_trunc": (J.ResNetTrunc(), 64, J.import_resnet_trunc, P.ResNetTrunc()),
    "r18": (J.ResNetTrunc(depths=(2, 2, 2), block="basic"), 64,
            lambda sd: J.import_resnet_trunc(sd, (2, 2, 2), "basic"), P.ResNetTrunc((2, 2, 2), "basic")),
    "uni_v1": (J.ViTEncoder(embed_dim=64, depth=2, heads=4), 224, J.import_vit, P.ViTEncoder(64, 2, 4)),
    "gigap": (J.ViTEncoder(embed_dim=64, depth=3, heads=4, layer_scale=False), 224, J.import_vit,
              P.ViTEncoder(64, 3, 4, layer_scale=False)),
    "conch_v1": (J.CLIPVisualTower(embed_dim=64, depth=2, heads=1), 224, J.import_clip_visual,
                 P.CLIPVisualTower(64, 2, 1)),
    "chief": (J.SwinChief(embed_dim=16, depths=(1, 1, 2, 1), heads=(1, 2, 4, 8)), 224, J.import_swin_chief,
              P.SwinChief(16, (1, 1, 2, 1), (1, 2, 4, 8))),
    "sd_vae": (J.SDVAEEncoder(block_out_channels=(32, 64), layers_per_block=1), 32, J.import_sd_vae,
               P.SDVAEEncoder((32, 64), 1)),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_encoder_state_dict_from_flax_round_trip(name):
    """``import_*(encoder_state_dict_from_flax(name, v)) == v`` for flax's
    own tree, and the ``state_dict`` loads into the port module
    strictly (every key, no other)."""
    model, size, importer, port = ROUND_TRIPS[name]
    variables = dict(_init(model, size, 3))
    sd = encoder_state_dict_from_flax(name, variables)
    back = importer(sd)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a).reshape(np.shape(b)), b)
    port.load_state_dict(sd)


def test_encoder_state_dict_from_flax_features():
    """The carried weights give JAX's features: a CoCa-trunk ``conch_v1``
    through ``encoder_state_dict_from_flax`` into the port's ViT."""
    model = J.ViTEncoder(embed_dim=64, depth=2, heads=4, layer_scale=False)
    variables = _init(model, 224, 4)
    port = P.ViTEncoder(64, 2, 4, layer_scale=False).eval()
    port.load_state_dict(encoder_state_dict_from_flax("conch_v1", variables))
    x = _images(2, 224, 7)
    np.testing.assert_allclose(_run_port(port, x), _run_jax(model, variables, x), **VIT_TOL)
    with pytest.raises(ValueError, match="unknown encoder"):
        encoder_state_dict_from_flax("nope", variables)
