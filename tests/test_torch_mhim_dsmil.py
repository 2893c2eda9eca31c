"""MHIM with the ``dsmil`` baseline, MHIM-selfattn with ``pos`` sincos, peg
and none, and ``merge_test``, against the JAX package, fp32 on the CPU.

The JAX params (and the Merge module's ``global_q``) come from flax's init
and are carried into the port by ``state_dict_from_flax``. Dropout is
patched to the identity on both sides where a pass trains; the student's
mining and merge draws are JAX's own uniforms, recorded and handed to the
port. Small widths: input_dim 16, inner_dim 32, 2 heads, bags of up to 96
instances. Tolerance rtol 1e-4, atol 1e-5 (parameters after a step: atol
1e-6, as ``test_torch_train``).

MHIM-dsmil's consistency loss runs on the ``[B, C, D]`` bag feature; JAX
weights its ``[B, C]`` per-class losses by a ``[B]`` bag weight, which
broadcasts against the class axis (ROADMAP.md, "Behaviours ... kept on
purpose"): the cases compared with JAX use batches where that broadcast
agrees with the port's per-bag weight (every bag valid and B = C).
"""

from functools import partial

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.models.merge as jmerge_mod
import mhim_mil_tpu.ops.masking as jmasking_mod
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.train_state import MILTrainState, make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.mhim import MHIM as JMHIM, make_mhim_train_step as j_make_mhim_train_step
from mhim_mil_tpu.ops import masked as jmasked
from mhim_mil_tpu.utils import schedules as jsched
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine import losses
from mhim_mil_torch.engine.steps import make_mhim_train_step
from mhim_mil_torch.engine.train_state import create_mhim_state
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.utils.weights import state_dict_from_flax

RTOL, ATOL = 1e-4, 1e-5
C16 = "config/mhim_c16.yaml"
IN_DIM, DIM, HEADS, N = 16, 32, 2, 96
SPE = 2
CFG = dict(input_dim=IN_DIM, inner_dim=DIM, n_heads=HEADS, num_epoch=2, compute_dtype="float32")


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
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, dtype=np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _identity(self, x, *a, **k):
    return x


def _batch(seed, lengths=(96, 70)):
    g = np.random.default_rng(seed)
    b = len(lengths)
    return {"feats": g.normal(size=(b, N, IN_DIM)).astype(np.float32),
            "mask": np.arange(N)[None] < np.array(lengths)[:, None], "bag_valid": np.array(lengths) > 0,
            "target": np.arange(b, dtype=np.int32) % 2}


def _pair(seed=0, **kw):
    """The JAX MHIM with flax's params and buffers, and the port's MHIM on
    the same weights (``global_q`` included)."""
    kw = {**CFG, **kw}
    jm, _ = j_build_model(j_load_config(["-c", C16], **kw))
    b = _batch(seed)
    rngs = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    v = jax.jit(partial(jm.init, training=True))(rngs, jnp.asarray(b["feats"]), jnp.asarray(b["mask"]),
                                                 jnp.zeros(b["mask"].shape, jnp.float32))
    v = jax.tree.map(np.asarray, v)
    cfg = load_config(["-c", C16], **kw)
    port, _ = build_model(cfg, device="cpu")
    port.load_state_dict(state_dict_from_flax(v["params"], v.get("buffers")))
    return jm, v, port, cfg


def _recorder(monkeypatch):
    """Record every uniform draw of JAX's mining and merge stages, in order."""
    draws = []

    def rec(rng, pool, k):
        u = jax.random.uniform(rng, pool.shape)
        jax.debug.callback(lambda a: draws.append(np.asarray(a)), u, ordered=True)
        return jmasked.topk_mask(u, pool, k, largest=True)

    monkeypatch.setattr(jmasking_mod, "random_subset_mask", rec)
    monkeypatch.setattr(jmerge_mod, "random_subset_mask", rec)
    return draws


def _port_draws(model, draws):
    it = iter(draws)
    return {"mask": [_t(next(it)) if s else None for s in model.sched.stages(True)], "merge": _t(next(it))}


# ---- MHIM-dsmil, pass by pass ------------------------------------------------------------


@pytest.mark.parametrize("attn2score", [True, False])
def test_dsmil_forward_teacher_matches_jax(attn2score):
    """The teacher's bag feature ``[B, C, D]`` and its mining score: each
    instance's largest class logit (``attn2score``) or attention, 0 at
    masked instances."""
    jm, v, port, _ = _pair(baseline="dsmil", attn2score=attn2score)
    b = _batch(3)
    want = jm.apply(v, jnp.asarray(b["feats"]), jnp.asarray(b["mask"]), method=JMHIM.forward_teacher)
    got = port.forward_teacher(_t(b["feats"]), _t(b["mask"]))
    assert got[0].shape == (2, 2, DIM)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_dsmil_forward_matches_jax_with_its_draws(monkeypatch):
    """The student's training pass with the teacher's score, its feature and
    the scheduled high ratio, on JAX's own mining and merge uniforms: the
    fused logits, the consistency loss on the ``[B, C, D]`` feature, the
    bag sizes before and after mining and merge."""
    jm, v, port, _ = _pair(baseline="dsmil")
    monkeypatch.setattr(flax.linen.Dropout, "__call__", _identity)
    monkeypatch.setattr(layers.Dropout, "forward", _identity)
    draws = _recorder(monkeypatch)
    b = _batch(4)
    feats, mask = jnp.asarray(b["feats"]), jnp.asarray(b["mask"])
    cls_tea, attn = jm.apply(v, feats, mask, method=JMHIM.forward_teacher)
    want, _ = jm.apply(v, feats, mask, attn, cls_tea, 0.02, training=True, mutable=["buffers"],
                       rngs={"mask": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)})
    jax.effects_barrier()
    assert len(draws) == 3
    got = port(_t(b["feats"]), _t(b["mask"]), _t(attn), _t(cls_tea), 0.02, training=True,
               draws=_port_draws(port, draws))
    for key in ("logits", "aux_loss", "patch_num", "keep_num"):
        _close(got[key], want[key], msg=key)


@pytest.mark.parametrize("return_attn", [False, True])
def test_dsmil_forward_test_and_pure_match_jax(monkeypatch, return_attn):
    """``forward_test`` (``0.5·bag + 0.5·instance`` logits, the mining score
    as attention) and the teacher stage's ``pure`` pass in eval and in
    training, dropout off."""
    jm, v, port, _ = _pair(baseline="dsmil")
    monkeypatch.setattr(flax.linen.Dropout, "__call__", _identity)
    monkeypatch.setattr(layers.Dropout, "forward", _identity)
    b = _batch(5)
    feats, mask = jnp.asarray(b["feats"]), jnp.asarray(b["mask"])
    want = jm.apply(v, feats, mask, return_attn=return_attn, method=JMHIM.forward_test)
    got = port.forward_test(_t(b["feats"]), _t(b["mask"]), return_attn=return_attn)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], msg=k)
    for training in (False, True):
        want = jm.apply(v, feats, mask, training=training, method=JMHIM.pure,
                        rngs={"dropout": jax.random.PRNGKey(0)})
        got = port.pure(_t(b["feats"]), _t(b["mask"]), training=training, gen=torch.Generator())
        _close(got["logits"], want["logits"])


@pytest.mark.parametrize("model", ["mhim", "mhim_pure"])
def test_dsmil_train_steps_match_jax(monkeypatch, model):
    """Two whole MHIM-dsmil train steps (teacher, mining, student,
    consistency loss, Adam, EMA; for ``mhim_pure`` the pure pass, no EMA)
    from the same weights and draws against JAX's ``make_mhim_train_step``:
    the metrics, the student's and the teacher's parameters."""
    jm, v, port, cfg = _pair(seed=6, baseline="dsmil", model=model, batch_size=2)
    jcfg = j_load_config(["-c", C16], **CFG, baseline="dsmil", model=model, batch_size=2)
    monkeypatch.setattr(flax.linen.Dropout, "__call__", _identity)
    monkeypatch.setattr(layers.Dropout, "forward", _identity)
    draws = _recorder(monkeypatch)
    params = jax.tree.map(jnp.asarray, v["params"])
    model_state = {"buffers": v["buffers"]} if "buffers" in v else {}
    tx = j_make_optimizer(jcfg, jsched.make_lr_schedule(jcfg, SPE))
    jstate = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=model_state,
                           teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(0), tx=tx, apply_fn=jm.apply)
    jstep = j_make_mhim_train_step(jcfg, jm, SPE)
    state = create_mhim_state(cfg, port, SPE, device="cpu")
    step = make_mhim_train_step(cfg, SPE, device="cpu")
    batch = _batch(7)
    jb, tb = {k: jnp.asarray(x) for k, x in batch.items()}, {k: _t(x) for k, x in batch.items()}
    for i in range(2):
        jstate, jmetrics = jstep(jstate, jb)
        jax.block_until_ready(jmetrics)
        metrics = step(state, tb, draws=None if model == "mhim_pure" else _port_draws(port, draws[3 * i:]))
        for k, want in jmetrics.items():
            _close(metrics[k], want, msg=k)
        buffers = jax.tree.map(np.asarray, jstate.model_state.get("buffers"))
        for module, p in ((state.model, jstate.params), (state.teacher, jstate.teacher_params)):
            want = state_dict_from_flax(jax.tree.map(np.asarray, p), buffers)
            for k, t in module.state_dict().items():
                if not (module is state.teacher and k == "merge.global_q_mm"):  # the teacher's copy is never read
                    _close(t, want[k], atol=1e-6, msg=k)
    if model == "mhim":
        assert float(metrics["aux_loss"]) > 0


def test_dsmil_consistency_loss_weights_each_bag():
    """The consistency loss on the ``[B, C, D]`` feature sums each bag's
    per-class losses and averages over the bags that are not fake: a fake
    bag changes nothing, at any batch size. JAX's weighting broadcasts a
    ``[B]`` weight against the class axis, which fails at B = 3, C = 2."""
    g = np.random.default_rng(8)
    s, t = (g.normal(size=(3, 2, DIM)).astype(np.float32) for _ in range(2))
    w = torch.tensor([True, True, False])
    got = losses.soft_target_ce(_t(s), _t(t), weights=w[:, None])
    per_bag = [losses.soft_target_ce(_t(s[i:i + 1]), _t(t[i:i + 1]), weights=torch.ones(1, 1, dtype=torch.bool))
               for i in range(2)]
    _close(got, (per_bag[0] + per_bag[1]) / 2)
    from mhim_mil_tpu.engine import losses as jlosses

    with pytest.raises(ValueError):
        jlosses.soft_target_ce(jnp.asarray(s), jnp.asarray(t), weights=jnp.asarray(w.numpy()))


# ---- MHIM-selfattn: the pos choices, merge_test -------------------------------------------


@pytest.mark.parametrize("pos", ["sincos", "peg", "none"])
def test_selfattn_pos_matches_jax(pos):
    """MHIM-selfattn with the positional module between the TransLayers
    ``sincos`` (the row-major grid), ``peg`` or ``none``: ``forward_test``
    with attention and the teacher's feature and score."""
    jm, v, port, _ = _pair(seed=9, pos=pos)
    assert (port.online_encoder.pos_embedding is None) == (pos == "none")
    b = _batch(10)
    feats, mask = jnp.asarray(b["feats"]), jnp.asarray(b["mask"])
    want = jm.apply(v, feats, mask, return_attn=True, method=JMHIM.forward_test)
    got = port.forward_test(_t(b["feats"]), _t(b["mask"]), return_attn=True)
    for k in want:
        _close(got[k], want[k], msg=k)
    want = jm.apply(v, feats, mask, method=JMHIM.forward_teacher)
    got = port.forward_teacher(_t(b["feats"]), _t(b["mask"]))
    for g_, w in zip(got, want):
        _close(g_, w)


@pytest.mark.parametrize("baseline", ["selfattn", "attn"])
def test_merge_test_forward_test_matches_jax(baseline):
    """``forward_test`` with ``merge_enable`` and ``merge_test``: the merged
    tokens join the bag at inference (JAX ``mhim.py:275-280``)."""
    jm, v, port, _ = _pair(seed=11, baseline=baseline, merge_test=True)
    assert port.merge_enable and port.merge_test
    b = _batch(12)
    want = jm.apply(v, jnp.asarray(b["feats"]), jnp.asarray(b["mask"]), method=JMHIM.forward_test)
    got = port.forward_test(_t(b["feats"]), _t(b["mask"]))
    _close(got["logits"], want["logits"])
    port.merge_test = False
    without = port.forward_test(_t(b["feats"]), _t(b["mask"]))
    assert not torch.allclose(without["logits"], got["logits"])
