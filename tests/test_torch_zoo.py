"""The port's zoo models against the JAX package on the same weights, fp32 on
the CPU: the masked reductions, PEG / sincos_2d / SINCOS, ABMIL and gabmil,
MeanMIL and MaxMIL, TransMIL, DSMIL's BClassifier, DSMILHead and DSMIL, and
the weight mapping both ways (the JAX package's ``IMPORTERS`` from a port
``state_dict`` to flax, ``utils/weights`` from flax to the port).

The JAX weights are initialised by flax and carried into the port by the
port's ``*_state_from_flax``. Ragged masks and a fake bag whose mask is all
False. The JAX ABMIL pools through its Pallas kernel in interpreter mode
(``FORCE_INTERPRET``), the port's through K4's plain version. Small
widths: input_dim 16, inner_dim 32, 2 heads, 16 landmarks. Tolerance
rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.ops.pallas_abmil as jpa
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.abmil import ABMIL as JABMIL
from mhim_mil_tpu.models.dsmil import BClassifier as JBClassifier, DSMILHead as JDSMILHead
from mhim_mil_tpu.models.positional import PEG as JPEG, SINCOS as JSINCOS, sincos_2d as j_sincos_2d
from mhim_mil_tpu.ops import masked as jmasked
from mhim_mil_tpu.utils.torch_import import IMPORTERS
from mhim_mil_torch.config import load_config
from mhim_mil_torch.models import build_model
from mhim_mil_torch.models.abmil import ABMIL
from mhim_mil_torch.models.dsmil import BClassifier, DSMILHead
from mhim_mil_torch.models.positional import PEG, SINCOS, sincos_2d
from mhim_mil_torch.ops import masked
from mhim_mil_torch.utils import weights

RTOL, ATOL = 1e-4, 1e-5
IN_DIM, DIM, HEADS = 16, 32, 2
LENGTHS = (64, 41, 0)  # ragged, plus a fake bag
N = 64
CFG = dict(input_dim=IN_DIM, inner_dim=DIM, n_heads=HEADS, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch: beside the other test workers its
    thread pool spins against theirs, and a tiny run takes 10–100× longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _bags(seed, dim, n=N, lengths=LENGTHS):
    g = np.random.default_rng(seed)
    x = g.normal(size=(len(lengths), n, dim)).astype(np.float32)
    return x, np.arange(n)[None] < np.array(lengths)[:, None]


def _coords(seed, b, n, side=9):
    g = np.random.default_rng(seed)
    return np.stack([g.permutation(side * side)[:n] for _ in range(b)])[..., None] // np.array([1, side]) % side


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- ops and positional modules ---------------------------------------------------------


def test_masked_reductions_match_jax():
    x, mask = _bags(0, 5)
    for name in ("masked_mean", "masked_max"):
        want = getattr(jmasked, name)(jnp.asarray(x), jnp.asarray(mask)[..., None], axis=-2)
        got = getattr(masked, name)(_t(x), _t(mask)[..., None], dim=-2)
        _close(got, want, msg=name)
    want = jmasked.masked_logsumexp(jnp.asarray(x[..., 0]), jnp.asarray(mask), axis=-1)
    got = masked.masked_logsumexp(_t(x[..., 0]), _t(mask), dim=-1)
    _close(got, want)
    assert torch.all(masked.masked_mean(_t(x), _t(mask)[..., None])[2] == 0)  # the fake bag


def test_peg_matches_jax():
    x, mask = _bags(1, DIM)
    jm = JPEG(DIM)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    port = PEG(DIM)
    sd = {}
    weights.pos_state(sd, "", _np(v["params"]))
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(_t(x), _t(mask))
    _close(got, jm.apply(v, jnp.asarray(x), jnp.asarray(mask)))
    assert torch.equal(got[2], _t(x[2]))  # masked tokens keep their input


@pytest.mark.parametrize("with_coords", [False, True])
def test_sincos_matches_jax(with_coords):
    x, mask = _bags(2, DIM)
    coords = _coords(3, len(LENGTHS), N) if with_coords else None
    want = JSINCOS(DIM).apply({}, jnp.asarray(x), jnp.asarray(mask),
                              None if coords is None else jnp.asarray(coords))
    got = SINCOS(DIM)(_t(x), _t(mask), None if coords is None else _t(coords))
    _close(got, want)
    c = _coords(4, 2, 10)
    _close(sincos_2d(_t(c), DIM), j_sincos_2d(jnp.asarray(c), DIM))


# ---- ABMIL / gabmil, MeanMIL / MaxMIL --------------------------------------------------


ABMIL_CASES = [
    dict(gated=False),
    dict(gated=True),
    dict(gated=False, mil_norm="ln", embed_norm_pos=0),
    dict(gated=False, mil_norm="ln", embed_norm_pos=1, mil_bias=False),
    dict(gated=True, pos="sincos"),
    dict(gated=False, mil_norm="ln", embed_norm_pos=1, pos="sincos"),
]


@pytest.mark.parametrize("kw", ABMIL_CASES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_abmil_matches_jax(monkeypatch, kw):
    """Eval (the JAX pool on its interpreted kernel, the port's on K4's plain
    version), with coords for sincos, return_attn on."""
    x, mask = _bags(5, IN_DIM)
    coords = _coords(6, len(LENGTHS), N) if kw.get("pos") else None
    ckw = {} if coords is None else {"coords": coords}
    jm = JABMIL(input_dim=IN_DIM, inner_dim=DIM, use_flash=True, **kw)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask), **ckw)
    port = ABMIL(input_dim=IN_DIM, inner_dim=DIM, **kw).eval()
    port.load_state_dict(weights.abmil_state_from_flax(_np(v["params"])))
    monkeypatch.setattr(jpa, "FORCE_INTERPRET", True)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), return_attn=True,
                    **{k: jnp.asarray(c) for k, c in ckw.items()})
    with torch.no_grad():
        got = port(_t(x), _t(mask), return_attn=True, **{k: _t(c) for k, c in ckw.items()})
    for key in ("logits", "bag_feat", "attn"):
        _close(got[key], want[key], msg=key)
    assert torch.all(got["attn"][2] == 0)


@pytest.mark.parametrize("model", ["meanmil", "maxmil"])
def test_mean_max_match_jax(model):
    x, mask = _bags(7, IN_DIM, lengths=(64, 41, 1))
    jcfg = j_load_config([], model=model, **CFG)
    jm, jfam = j_build_model(jcfg)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(mask))
    port, fam = build_model(load_config([], model=model, **CFG), device="cpu")
    assert fam == jfam == "default"
    port.load_state_dict(weights.mean_max_state_from_flax(_np(v["params"])))
    with torch.no_grad():
        got = port(_t(x), _t(mask))["logits"]
    _close(got, jm.apply(v, jnp.asarray(x), jnp.asarray(mask))["logits"])


# ---- TransMIL ------------------------------------------------------------------------------


def _transmil_pair(seed, **kw):
    """A JAX TransMIL (through its registry) and the port's, on the same weights."""
    jm, jfam = j_build_model(j_load_config([], model="transmil", **CFG, **kw))
    x, mask = _bags(seed, IN_DIM)
    ckw = {"coords": jnp.asarray(_coords(seed, len(LENGTHS), N))} if kw.get("pos") == "sincos" else {}
    params = _np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mask), **ckw)["params"])
    port, fam = build_model(load_config([], model="transmil", **CFG, **kw), device="cpu")
    assert fam == jfam == "default"
    port.load_state_dict(weights.transmil_state_from_flax(params))
    return jm, params, port, x, mask, ckw


@pytest.mark.parametrize("kw", [dict(pos="ppeg"), dict(pos="sincos"), dict(pos="peg"),
                                dict(pos="none", mil_norm="ln", mil_bias=False)],
                         ids=["ppeg", "sincos", "peg", "none-ln-nobias"])
def test_transmil_matches_jax(kw):
    """Eval with return_attn: logits, bag_feat and both layers' cls
    attention; sincos reads the batch's coords."""
    jm, params, port, x, mask, ckw = _transmil_pair(8, **kw)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), return_attn=True, **ckw)
    with torch.no_grad():
        got = port(_t(x), _t(mask), return_attn=True, **{k: _t(np.asarray(c)) for k, c in ckw.items()})
    for key in ("logits", "bag_feat", "attn"):
        _close(got[key], want[key], msg=key)
    assert len(got["attns"]) == len(want["attns"]) == 2
    for g, w in zip(got["attns"], want["attns"]):
        _close(g, w)
    assert got["attns"][0].shape == (len(LENGTHS), HEADS, N)


def test_transmil_parity_matches_jax():
    """``parity``: both layers on the reference's unmasked landmark arithmetic."""
    jm, _, _, x, mask, _ = _transmil_pair(9)
    jpar = jm.clone(parity=True)
    params = _np(jpar.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask))["params"])
    from mhim_mil_torch.models.transformer import TransMIL

    port = TransMIL(input_dim=IN_DIM, inner_dim=DIM, n_heads=HEADS, parity=True).eval()
    port.load_state_dict(weights.transmil_state_from_flax(params))
    want = jpar.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = port(_t(x), _t(mask))
    _close(got["logits"], want["logits"])


def test_transmil_cls_token_starts_near_zero():
    port, _ = build_model(load_config([], model="transmil", **CFG), device="cpu")
    assert 0 < port.cls_token.abs().max().item() < 1e-4  # normal(1e-6), as JAX's TransMIL


# ---- DSMIL -------------------------------------------------------------------------------


def _bclassifier_pair(seed, classes):
    x, mask = _bags(seed, DIM)
    jm = JBClassifier(DIM, 2)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(classes), jnp.asarray(mask))
    port = BClassifier(DIM, 2)
    sd = {}
    weights.bclassifier_state(sd, "", _np(v["params"]))
    port.load_state_dict(sd)
    return jm, v, port, x, mask


@pytest.mark.parametrize("no_norm", [False, True])
def test_bclassifier_matches_jax(no_norm):
    classes = np.random.default_rng(10).normal(size=(len(LENGTHS), N, 2)).astype(np.float32)
    jm, v, port, x, mask = _bclassifier_pair(10, classes)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(classes), jnp.asarray(mask), no_norm=no_norm)
    with torch.no_grad():
        got = port(_t(x), _t(classes), _t(mask), no_norm=no_norm)
    for g, w, name in zip(got, want, ("logits", "attention", "bag")):
        _close(g, w, msg=name)


def test_bclassifier_tie_takes_the_first_instance():
    """A planted tie for the largest class score, at instances 3 and 9 (and a
    larger score at a masked instance): the critical instance is 3, as
    ``jnp.argmax`` picks, and the result matches JAX's."""
    g = np.random.default_rng(11)
    classes = g.normal(size=(len(LENGTHS), N, 2)).astype(np.float32)
    classes[:2, [3, 9], 0] = 5.0
    classes[1, 50, 0] = 9.0  # bag 1 has 41 valid instances: masked
    jm, v, port, x, mask = _bclassifier_pair(12, classes)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(classes), jnp.asarray(mask))
    with torch.no_grad():
        tie = port(_t(x), _t(classes), _t(mask))
        for g_, w in zip(tie, want):
            _close(g_, w)
        later, earlier = classes.copy(), classes.copy()
        later[:2, 9, 0] = 4.0  # instance 3 alone holds the max
        earlier[:2, 3, 0] = 4.0  # instance 9 alone holds the max
        first = port(_t(x), _t(later), _t(mask))
        second = port(_t(x), _t(earlier), _t(mask))
    assert torch.equal(tie[0], first[0]) and not torch.allclose(tie[0], second[0])


@pytest.mark.parametrize("cls_attn", [True, False])
def test_dsmil_head_matches_jax(cls_attn):
    x, mask = _bags(13, DIM)
    jm = JDSMILHead(DIM, 2, cls_attn=cls_attn)
    v = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(mask))
    p = _np(v["params"])
    sd = {}
    weights._linear(sd, "i_classifier.0", p["i_classifier"])
    weights.bclassifier_state(sd, "b_classifier.", p["b_classifier"])
    port = DSMILHead(DIM, 2, cls_attn=cls_attn)
    port.load_state_dict(sd)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(mask), return_attn=True)
    with torch.no_grad():
        got = port(_t(x), _t(mask), return_attn=True)
    for key in ("bag_logits", "inst_logits", "bag_feat", "attn"):
        _close(got[key][:2], want[key][:2], msg=key)  # the fake bag's max is NEG_INF on both sides
    assert torch.all(got["attn"][2] == 0)


@pytest.mark.parametrize("kw", [{}, dict(mil_norm="ln", mil_bias=False)], ids=["plain", "ln-nobias"])
def test_dsmil_matches_jax(kw):
    x, mask = _bags(14, IN_DIM, lengths=(64, 41, 2))
    jm, jfam = j_build_model(j_load_config([], model="dsmil", **CFG, **kw))
    params = _np(jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(mask))["params"])
    port, fam = build_model(load_config([], model="dsmil", **CFG, **kw), device="cpu")
    assert fam == jfam == "dsmil"
    port.load_state_dict(weights.dsmil_state_from_flax(params))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), return_attn=True)
    with torch.no_grad():
        got = port(_t(x), _t(mask), return_attn=True)
    for key in ("logits", "inst_logits_bag", "bag_feat", "attn"):
        _close(got[key], want[key], msg=key)


# ---- the weight mapping, both ways ---------------------------------------------------------


def _jax_params(model, **kw):
    jm, _ = j_build_model(j_load_config([], model=model, **CFG, **kw))
    x, mask = _bags(15, IN_DIM)
    return _np(jm.init(jax.random.PRNGKey(6), jnp.asarray(x), jnp.asarray(mask))["params"])


@pytest.mark.parametrize("model,importer,to_port", [
    ("abmil", "abmil", weights.abmil_state_from_flax),
    ("gabmil", None, weights.abmil_state_from_flax),
    ("meanmil", None, weights.mean_max_state_from_flax),
    ("maxmil", None, weights.mean_max_state_from_flax),
    ("transmil", "transmil", weights.transmil_state_from_flax),
    ("dsmil", "dsmil", weights.dsmil_state_from_flax),
])
def test_weights_map_both_ways(model, importer, to_port):
    """flax → port by the port's function: every tensor of the port's
    ``state_dict`` and nothing else, shapes equal; port → flax by the JAX
    package's importer where it has one, back onto the same tree bit for bit."""
    params = _jax_params(model)
    port, _ = build_model(load_config([], model=model, **CFG), device="cpu")
    sd = to_port(params)
    assert set(sd) == set(port.state_dict())
    for k, t in port.state_dict().items():
        assert tuple(t.shape) == tuple(sd[k].shape), k
    port.load_state_dict(sd)
    if importer is None:
        return
    back = IMPORTERS[importer]({k: v.numpy() for k, v in port.state_dict().items()})
    got, want = _flat(back), _flat(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mhim_dsmil_weights_map_both_ways():
    """MHIM's dsmil baseline: ``state_dict_from_flax`` (no predictor) and
    ``import_mhim_dsmil`` back (the Merge module through ``import_merge``)."""
    from mhim_mil_tpu.utils.torch_import import import_merge

    jm, _ = j_build_model(j_load_config(["-c", "config/mhim_c16.yaml"], baseline="dsmil", **CFG))
    x, mask = _bags(16, IN_DIM)
    rngs = {"params": jax.random.PRNGKey(7), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    v = _np(jm.init(rngs, jnp.asarray(x), jnp.asarray(mask), jnp.zeros(mask.shape, jnp.float32), training=True))
    port, _ = build_model(load_config(["-c", "config/mhim_c16.yaml"], baseline="dsmil", **CFG), device="cpu")
    sd = weights.state_dict_from_flax(v["params"], v["buffers"])
    assert set(sd) == set(port.state_dict()) and not any(k.startswith("predictor") for k in sd)
    port.load_state_dict(sd)
    psd = {k: t.numpy() for k, t in port.state_dict().items()}
    back = IMPORTERS["mhim_dsmil"](psd)
    back["merge"], back_buffers = import_merge(psd)
    for got, want in ((_flat(back), _flat(v["params"])), (_flat(back_buffers), _flat(v["buffers"]["merge"]))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
