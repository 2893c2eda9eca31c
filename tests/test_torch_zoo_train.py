"""The port's generic train step (families ``default`` and ``dsmil``) and
eval step against the JAX package's, fp32 on the CPU.

From the same initial weights (flax's, carried into the port), with dropout
patched to the identity on both sides: two SGD steps of abmil, gabmil,
maxmil, TransMIL, DSMIL (its max-pooled instance loss in ``aux_loss``) and
a ``pos="sincos"`` abmil whose batch holds ``pos``, under ``model_ema``.
The losses and meters, the gradients of the first step (JAX's by
``jax.grad`` of the step's loss), and the student's and the EMA teacher's
parameters after each step match at rtol 1e-4, atol 1e-5. SGD, since
Adam's first steps move a parameter by about lr·sign(g). Then the eval
step of DSMIL, whose ``sub_logits`` the caller fuses, and the ``Scorer``
of abmil and dsmil against JAX's serving closure. Small widths:
input_dim 16, inner_dim 32, 2 heads, bags of up to 48 instances with a
ragged and a fake bag.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.losses import build_criterion as j_build_criterion
from mhim_mil_tpu.engine.steps import make_eval_step as j_make_eval_step, make_train_step as j_make_train_step
from mhim_mil_tpu.engine.train_state import MILTrainState, make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.utils.schedules import make_lr_schedule as j_make_lr_schedule
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import make_eval_step, make_train_step
from mhim_mil_torch.engine.train_state import create_train_state
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.utils import weights

RTOL, ATOL = 1e-4, 1e-5
IN_DIM, DIM, HEADS = 16, 32, 2
N, LENGTHS = 48, (48, 29, 0)
SPE = 2
CFG = dict(input_dim=IN_DIM, inner_dim=DIM, n_heads=HEADS, compute_dtype="float32", opt="sgd", lr=0.1,
           lr_sche="const", weight_decay=0.0, batch_size=len(LENGTHS), num_epoch=1, model_ema=True,
           model_ema_decay=0.9, aux_alpha=0.5)
TO_PORT = {"abmil": weights.abmil_state_from_flax, "gabmil": weights.abmil_state_from_flax,
           "maxmil": weights.mean_max_state_from_flax, "meanmil": weights.mean_max_state_from_flax,
           "transmil": weights.transmil_state_from_flax, "dsmil": weights.dsmil_state_from_flax}


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
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _batch(seed):
    g = np.random.default_rng(seed)
    return {"feats": g.normal(size=(len(LENGTHS), N, IN_DIM)).astype(np.float32),
            "mask": np.arange(N)[None] < np.array(LENGTHS)[:, None],
            "pos": np.stack([g.permutation(49)[:N] for _ in LENGTHS])[..., None] // np.array([1, 7]) % 7,
            "target": np.array([1, 0, 0], np.int32), "bag_valid": np.array(LENGTHS) > 0}


def _pair(model, seed=0, **kw):
    """The JAX model with flax's initial params, and the port's model and
    configs on the same weights."""
    jcfg = j_load_config([], model=model, **CFG, **kw)
    jm, family = j_build_model(jcfg)
    b = _batch(seed)
    ckw = {"coords": jnp.asarray(b["pos"])} if kw.get("pos") == "sincos" else {}
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(b["feats"]), jnp.asarray(b["mask"]), **ckw)["params"]
    cfg = load_config([], model=model, **CFG, **kw)
    port, fam = build_model(cfg, device="cpu")
    assert fam == family
    port.load_state_dict(TO_PORT[model](jax.tree.map(np.asarray, params)))
    return jcfg, jm, family, params, cfg, port


def _jax_grads(jcfg, jm, family, params, jbatch):
    """The gradient of JAX's train-step loss (``steps.py:55-101``), dropout off."""
    criterion = j_build_criterion(jcfg)
    kw = {"coords": jbatch["pos"]} if getattr(jm, "pos", None) == "sincos" else {}

    def loss(p):
        out = jm.apply({"params": p}, jbatch["feats"], jbatch["mask"], training=True,
                       rngs={"dropout": jax.random.PRNGKey(0)}, **kw)
        aux = out.get("aux_loss", 0.0)
        if "inst_logits_bag" in out:
            aux = aux + criterion(out["inst_logits_bag"], jbatch)
        return jcfg.main_alpha * criterion(out["logits"], jbatch) + jcfg.aux_alpha * aux

    return jax.grad(loss)(params)


@pytest.mark.parametrize("model,kw", [
    ("abmil", {}),
    ("gabmil", {}),
    ("maxmil", {}),
    ("transmil", {}),
    ("dsmil", {}),
    ("abmil", dict(pos="sincos", mil_norm="ln")),
], ids=["abmil", "gabmil", "maxmil", "transmil", "dsmil", "abmil-sincos-ln"])
def test_generic_train_step_matches_jax(monkeypatch, model, kw):
    jcfg, jm, family, params, cfg, port = _pair(model, **kw)
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jgrads = _jax_grads(jcfg, jm, family, params, jbatch)

    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, SPE))
    jstate = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state={},
                           teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(3), tx=tx, apply_fn=jm.apply)
    jstep = j_make_train_step(jcfg, jm, family, SPE)
    state = create_train_state(cfg, port, SPE, device="cpu")
    step = make_train_step(cfg, family, SPE, "cpu")
    to_port = TO_PORT[model]
    for i in range(2):
        jstate, jmetrics = jstep(jstate, jbatch)
        metrics = step(state, tbatch)
        for k, v in jmetrics.items():
            _close(metrics[k], v, msg=k)
        if family == "dsmil":
            assert float(metrics["aux_loss"]) > 0
        if i == 0:
            want = to_port(jax.tree.map(np.asarray, jgrads))
            for name, p in port.named_parameters():
                _close(p.grad, want[name], msg=f"grad {name}")
        for module, p in ((state.model, jstate.params), (state.teacher, jstate.teacher_params)):
            want = to_port(jax.tree.map(np.asarray, p))
            for k, t in module.state_dict().items():
                _close(t, want[k], msg=k)


def test_dsmil_eval_step_returns_sub_logits_as_jax_does():
    """The eval step of DSMIL gives ``sub_logits`` beside ``logits``, unfused,
    equal to JAX's eval step's on the same weights."""
    jcfg, jm, family, params, cfg, port = _pair("dsmil", seed=2)
    batch = _batch(3)
    jstate = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state={}, teacher_params=None,
                           opt_state=None, rng=jax.random.PRNGKey(0), tx=None, apply_fn=jm.apply)
    want = j_make_eval_step(jcfg, jm, family)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(cfg, port, family)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"logits", "sub_logits"}
    for k in want:
        _close(got[k], want[k], msg=k)
    assert not torch.allclose(got["logits"], got["sub_logits"])


@pytest.mark.parametrize("model", ["abmil", "dsmil"])
def test_scorer_matches_jax_infer_fn(monkeypatch, model):
    """The ``Scorer`` of a zoo family against JAX's serving closure
    ``_infer_fn`` on the same bucket-padded request: ``logits`` and, for
    dsmil, ``sub_logits`` beside them, unfused as JAX's are."""
    import mhim_mil_tpu.ops.pallas_abmil as jpa
    from mhim_mil_tpu.utils.serving import _infer_fn
    from mhim_mil_torch.utils.serving import Scorer

    jcfg, jm, family, params, cfg, port = _pair(model, seed=4)
    monkeypatch.setattr(jpa, "FORCE_INTERPRET", True)
    b = _batch(5)
    feats, mask = b["feats"][:, :40], b["mask"][:, :40]
    out = Scorer(cfg, port, buckets=(N,), device="cpu", family=family).score(feats, mask)
    pad = ((0, 0), (0, N - 40))
    want = _infer_fn(jcfg, jm, family, {"params": params})(
        jnp.asarray(np.pad(feats, pad + ((0, 0),))), jnp.asarray(np.pad(mask, pad)))
    assert set(out) == set(want) == ({"logits", "sub_logits"} if model == "dsmil" else {"logits"})
    for k in want:
        _close(out[k], want[k], msg=k)
