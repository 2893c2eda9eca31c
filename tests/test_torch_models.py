"""The port's MHIM-selfattn modules against the JAX package on the same weights.

The JAX params (and the Merge module's ``global_q`` buffer) are initialised
by flax, converted with ``state_dict_from_flax`` (or its per-module helpers)
and loaded into the port;
both frameworks then run the same numpy inputs in fp32 on the CPU, with ragged
masks and one fake bag whose mask is all False. Small widths: input_dim 16,
inner_dim 32, 2 heads, 16 landmarks. Tolerance rtol 1e-4, atol 1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.baselines import SAttentionBaseline as JSAttention
from mhim_mil_tpu.models.mhim import MHIM as JMHIM
from mhim_mil_tpu.models.positional import PPEG as JPPEG
from mhim_mil_tpu.models.transformer import TransLayer as JTransLayer
from mhim_mil_tpu.utils.torch_import import import_merge, import_mhim_attn, import_mhim_selfattn
from mhim_mil_torch.config import load_config
from mhim_mil_torch.models import build_model
from mhim_mil_torch.models.baselines import SAttentionBaseline
from mhim_mil_torch.models.positional import PPEG
from mhim_mil_torch.models.transformer import TransLayer
from mhim_mil_torch.utils import weights

RTOL, ATOL = 1e-4, 1e-5
DIM, HEADS, IN_DIM = 32, 2, 16
LENGTHS = (90, 57, 0)  # ragged, plus a fake bag
N = 90

CFG = dict(model="mhim", baseline="selfattn", input_dim=IN_DIM, inner_dim=DIM, n_heads=HEADS,
           compute_dtype="float32")


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _bags(seed, n, dim, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(lengths), n, dim)).astype(np.float32)
    mask = np.arange(n)[None] < np.array(lengths)[:, None]
    return x, mask


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}


def _jax_init(baseline, seed=0):
    """A flax MHIM (flagship preset, small widths) and its variables, made by
    the training pass as ``create_mhim_state`` makes them, so that they hold
    the Merge module's params and its ``global_q`` buffer."""
    jcfg = j_load_config(["-c", "config/mhim_c16.yaml"], **{**CFG, "baseline": baseline})
    jmodel, _ = j_build_model(jcfg)
    feats, mask = _bags(seed, N, IN_DIM)
    init = jax.jit(partial(jmodel.init, training=True))
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    variables = init(rngs, jnp.asarray(feats), jnp.asarray(mask), jnp.zeros(mask.shape, jnp.float32))
    return jmodel, _np_tree(variables["params"]), _np_tree(variables["buffers"])


@pytest.fixture(scope="module")
def mhim_pair():
    """A flax MHIM-selfattn with its params, and the port's MHIM carrying the
    same weights, global_q included."""
    jmodel, params, buffers = _jax_init("selfattn")
    cfg = load_config(["-c", "config/mhim_c16.yaml"], **CFG)
    model, family = build_model(cfg, device="cpu")
    assert family == "mhim"
    model.load_state_dict(weights.state_dict_from_flax(params, buffers))
    return jmodel, params, model, cfg


def _check_round_trip(baseline):
    """The converter carries every param and the Merge buffer into the port's
    state_dict, by the original repo's names, and the JAX package's importers
    (import_mhim_selfattn / import_mhim_attn + import_merge) map the port's
    state_dict back onto the same flax trees."""
    _, params, buffers = _jax_init(baseline, seed=1)
    model, _ = build_model(load_config(["-c", "config/mhim_c16.yaml"], **{**CFG, "baseline": baseline}),
                           device="cpu")
    sd = weights.state_dict_from_flax(params, buffers)
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert tuple(t.shape) == tuple(sd[name].shape), name
    model.load_state_dict(sd)
    if baseline == "selfattn":
        assert tuple(sd["online_encoder.layer1.attn.res_conv.weight"].shape) == (HEADS, 1, 33, 1)
        assert tuple(sd["online_encoder.pos_embedding.proj.weight"].shape) == (DIM, 1, 7, 7)
    else:
        assert tuple(sd["online_encoder.attention.attention.0.weight"].shape) == (128, DIM)
    assert tuple(sd["merge.global_q_mm"].shape) == (1, 1, DIM)
    port_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = (import_mhim_selfattn if baseline == "selfattn" else import_mhim_attn)(port_sd)
    back["merge"], back_buffers = import_merge(port_sd)
    for got, want in ((_flat(back), _flat(params)), (_flat(back_buffers), _flat(buffers["merge"]))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    no_buffers = weights.state_dict_from_flax(params)  # a JAX .ckpt's teacher init reads params only
    assert set(no_buffers) == set(sd) - {"merge.global_q_mm"}
    for k, v in no_buffers.items():
        assert torch.equal(v, sd[k]), k


def test_state_dict_round_trips_through_the_jax_importer():
    _check_round_trip("selfattn")


def test_attn_state_dict_round_trips_through_the_jax_importer():
    _check_round_trip("attn")


def test_ppeg_matches_jax():
    x, mask = _bags(1, N, DIM)
    jm = JPPEG(DIM)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))
    sd = {}
    weights.ppeg_state(sd, "", _np_tree(variables["params"]))
    port = PPEG(DIM)
    port.load_state_dict(sd)
    port.eval()
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, want)


@pytest.mark.parametrize("need_attn", [False, True])
def test_translayer_matches_jax(need_attn):
    x, mask = _bags(2, N, DIM)
    mask[:, 0] = True  # token 0 plays the cls token
    jm = JTransLayer(DIM, HEADS)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(mask), False, True, False)
    sd = {}
    weights.translayer_state(sd, "", _np_tree(variables["params"]))
    port = TransLayer(DIM, HEADS)
    port.load_state_dict(sd)
    port.eval()
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), False, need_attn, False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask), need_attn=need_attn)
    if not need_attn:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):  # out, and with need_attn: attn, v_inst, scored
        _close(g, w)


@pytest.mark.parametrize("attn_layers", [(0,), (0, 1)])
def test_sattention_baseline_matches_jax(attn_layers):
    x, mask = _bags(3, N, DIM)
    jm = JSAttention(DIM, HEADS, attn_layers=attn_layers)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask), return_attn=True)
    sd = {}
    weights.sattention_state(sd, "", _np_tree(variables["params"]))
    port = SAttentionBaseline(DIM, HEADS, attn_layers=attn_layers)
    port.load_state_dict(sd)
    port.eval()
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), return_attn=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask), return_attn=True)
    _close(got["cls_feat"], want["cls_feat"])
    _close(got["scored_act"], want["scored_act"])
    assert len(got["attns"]) == len(want["attns"]) == len(attn_layers)
    for g, w in zip(got["attns"], want["attns"]):
        _close(g, w)


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_test_matches_jax(mhim_pair, use_flash):
    """Logits and layer-1 attention, through the kernels' plain versions
    (use_flash) and through the materialising reference attention."""
    jmodel, params, model, _ = mhim_pair
    for layer in (model.online_encoder.layer1, model.online_encoder.layer2):
        layer.attn.use_flash = use_flash
    feats, mask = _bags(4, N, IN_DIM)
    want = jmodel.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask),
                        return_attn=True, method=JMHIM.forward_test)
    got = model.forward_test(torch.from_numpy(feats), torch.from_numpy(mask), return_attn=True)
    for layer in (model.online_encoder.layer1, model.online_encoder.layer2):
        layer.attn.use_flash = True
    _close(got["logits"], want["logits"])
    _close(got["attn"], want["attn"])
    assert torch.all(got["attn"][2] == 0)  # the fake bag attends nowhere


def test_forward_teacher_matches_jax(mhim_pair):
    jmodel, params, model, _ = mhim_pair
    feats, mask = _bags(5, N, IN_DIM)
    want_cls, want_score = jmodel.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask),
                                        method=JMHIM.forward_teacher)
    got_cls, got_score = model.forward_teacher(torch.from_numpy(feats), torch.from_numpy(mask))
    _close(got_cls, want_cls)
    _close(got_score, want_score)
    assert torch.all(got_score[~torch.from_numpy(mask)] == 0)


def test_unported_configurations_raise():
    """Every model of the JAX registry builds in the port, with the JAX
    registry's family (``NOT_PORTED`` is empty); unknown names of a model,
    a baseline or a position module raise."""
    from mhim_mil_tpu.models.registry import MODEL_REGISTRY
    from mhim_mil_torch.models.registry import NOT_PORTED

    assert NOT_PORTED == ()
    cfg = load_config([], **CFG)
    for model in sorted(MODEL_REGISTRY):
        kw = dict(model=model, mambamil_dim=DIM, mambamil_state_dim=4, mamba_2d_max_hw=4)
        _, family = build_model(cfg.replace(**kw), device="cpu")
        _, j_family = j_build_model(j_load_config([], **{**CFG, **kw}))
        assert family == j_family, model
    for kw in ({"model": "nomil"}, {"baseline": "nobaseline"}, {"pos": "nopos"}):
        with pytest.raises(ValueError):
            build_model(cfg.replace(**kw), device="cpu")
