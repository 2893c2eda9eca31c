"""The port's ``mambamil`` (the 1D Mamba MIL model) against the JAX package on the CPU.

The same numpy inputs go through the JAX function and its port: the
masked 1D selective scan (forward and gradients, in chunks that end on the
bag's edges and off them), SRMamba's permutation, the residual block and
the whole ``MambaMIL1D`` of each variant (simple, srmamba, bimamba) with
flax weights carried by ``mambamil_state_from_flax``, its eval step under
fp32 and bf16, one generic train step, and a driver fold. Small widths:
input 16, model dim 32 (ED 64), state 8, SRMamba stride 4.

Tolerances: the scan within rtol 1e-5, atol 1e-6 and its gradients within
1e-4 of max|g|; fp32 logits within 1e-5·max(1, max|ref|); the bf16 policy
within 0.1 of JAX's; a train step's loss within 1e-5 relative and its
parameters within 2·lr (Adam's first step moves each by about lr·sign(g)).
"""

import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.losses import build_criterion as j_build_criterion
from mhim_mil_tpu.engine.steps import make_eval_step as j_make_eval_step, make_train_step as j_make_train_step
from mhim_mil_tpu.engine.train_state import MILTrainState, make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models import mamba as jmamba
from mhim_mil_tpu.ops import scan as jscan
from mhim_mil_tpu.utils.schedules import make_lr_schedule as j_make_lr_schedule
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine import driver
from mhim_mil_torch.engine.steps import make_eval_step, make_train_step
from mhim_mil_torch.engine.train_state import create_train_state
from mhim_mil_torch.models import build_model, layers, mamba
from mhim_mil_torch.ops import scan
from mhim_mil_torch.utils import weights

IN_DIM, DIM, STATE, RATE = 16, 32, 8, 4
N, LENGTHS = 37, (37, 20)
VARIANTS = {"simple": "SimpleMamba", "srmamba": "SRMamba", "bimamba": "BiMamba"}
CFG = dict(model="mambamil", input_dim=IN_DIM, mambamil_dim=DIM, mambamil_state_dim=STATE, mambamil_rate=RATE,
           compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch, beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _scan_inputs(seed, bs, length, ed, n):
    """x, Δ = 0.1·softplus(normal), A = −(1..n), B, C, D as ``tests/test_scan.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bs, length, ed)).astype(np.float32)
    delta = (np.log1p(np.exp(rng.normal(size=(bs, length, ed)))) * 0.1).astype(np.float32)
    A = -np.tile(np.arange(1, n + 1, dtype=np.float32), (ed, 1))
    B = rng.normal(size=(bs, length, n)).astype(np.float32)
    C = rng.normal(size=(bs, length, n)).astype(np.float32)
    D = rng.normal(size=(ed,)).astype(np.float32)
    return x, delta, A, B, C, D


def _bag(seed, b=len(LENGTHS), n=N, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, IN_DIM)).astype(np.float32)
    return feats, np.arange(n)[None] < np.array(lengths)[:, None]


# ---- the scan ---------------------------------------------------------------------


MASKS = {
    "none": None,
    "ragged": lambda length: np.arange(length)[None] < np.array([length, 16])[:, None],  # 16: a chunk edge
    "holes": lambda length: np.random.default_rng(length).random((2, length)) < 0.7,  # permuted padding
}


@pytest.mark.parametrize("length,chunk", [(37, 8), (32, 8), (37, 1024), (5, 1)],
                         ids=["off-edges", "on-edges", "one-chunk", "chunk-1"])
@pytest.mark.parametrize("mask_kind", sorted(MASKS))
def test_selective_scan_1d_matches_jax(length, chunk, mask_kind):
    """y against JAX's ``associative_scan`` form (and, unmasked, against the
    port's and JAX's sequential recurrence), then the gradients of
    Σ y·w with respect to x, Δ, A, B, C and D against ``jax.grad``."""
    x, delta, A, B, C, D = _scan_inputs(length, 2, length, 6, 4)
    mask = None if MASKS[mask_kind] is None else MASKS[mask_kind](length)
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    j_args = [jnp.asarray(a) for a in (x, delta, A, B, C, D)]
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jscan.selective_scan_1d(*j_args, mask=jmask))
    t_args = [_t(a).requires_grad_() for a in (x, delta, A, B, C, D)]
    got = scan.selective_scan_1d(*t_args, mask=None if mask is None else _t(mask), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    if mask is None:
        seq = scan.selective_scan_1d_seq(*(_t(a) for a in (x, delta, A, B, C, D)))
        np.testing.assert_allclose(seq.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(jscan.selective_scan_1d_seq(*j_args)), want, rtol=1e-5, atol=1e-6)

    jgrads = jax.grad(lambda *a: jnp.sum(jscan.selective_scan_1d(*a, mask=jmask) * w), argnums=range(6))(*j_args)
    (got * _t(w)).sum().backward()
    for name, t, g in zip("x delta A B C D".split(), t_args, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=name)


def test_selective_scan_1d_masked_steps_carry_the_state():
    """Scanning a bag with masked holes gives, at its valid steps, the scan
    of the bag with the holes taken out (``tests/test_scan.py:48``), across
    chunk edges; masked steps give 0."""
    x, delta, A, B, C, D = _scan_inputs(3, 1, 29, 4, 3)
    keep = np.random.default_rng(2).random(29) < 0.6
    got = scan.selective_scan_1d(*(_t(a) for a in (x, delta, A, B, C, D)), mask=_t(keep[None]), chunk=4)
    dense = scan.selective_scan_1d(*(_t(a[:, keep]) if a.ndim == 3 else _t(a) for a in (x, delta, A, B, C, D)))
    np.testing.assert_allclose(got[0, keep].numpy(), dense[0].numpy(), rtol=1e-5, atol=1e-6)
    assert torch.all(got[0, ~keep] == 0)


def test_selective_scan_1d_keeps_no_lattice_for_the_backward():
    """Under grad the chunks run under checkpoint: the saved tensors of the
    whole graph hold the thin inputs and the chunk states, far less than
    one ``[Bs, L, ED, N]`` lattice."""
    x, delta, A, B, C, D = _scan_inputs(4, 2, 256, 16, 8)
    args = [_t(a).requires_grad_() for a in (x, delta, A, B, C, D)]
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = scan.selective_scan_1d(*args, chunk=64)
    lattice = 2 * 256 * 16 * 8
    assert sum(saved) < lattice, (sum(saved), lattice)
    y.sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in args)


@pytest.mark.parametrize("rate,length", [(4, 37), (4, 36), (10, 23), (1, 5)])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no-mask"])
def test_sr_permute_matches_jax(rate, length, with_mask):
    """The permuted sequence and its mask, bit for bit, and the inverse."""
    rng = np.random.default_rng(length)
    x = rng.normal(size=(2, length, 3)).astype(np.float32)
    mask = np.arange(length)[None] < np.array([length, length // 2])[:, None]
    jm = jnp.asarray(mask) if with_mask else None
    want_x, want_m = jmamba.sr_permute(jnp.asarray(x), jm, rate)
    got_x, got_m = mamba.sr_permute(_t(x), _t(mask) if with_mask else None, rate)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    back = mamba.sr_unpermute(got_x, rate, length)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jmamba.sr_unpermute(want_x, rate, length)))
    np.testing.assert_array_equal(back.numpy(), x)


# ---- the block and the model ---------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_residual_block_1d_matches_jax(variant):
    """``ResidualMamba`` on a ragged ``[2, 37, 32]`` sequence, fp32."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, N, DIM)).astype(np.float32)
    mask = np.arange(N)[None] < np.array(LENGTHS)[:, None]
    jb = jmamba.ResidualMamba(DIM, STATE, variant=variant, sr_rate=RATE)
    params = jb.init(jax.random.PRNGKey(1), jnp.asarray(x), mask=jnp.asarray(mask))["params"]
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask)))
    sd = {}
    weights._mamba_layers(sd, {"layer0": jax.tree.map(np.asarray, params)})
    block = mamba.ResidualMamba(DIM, STATE, False, variant, RATE)
    block.load_state_dict({k[len("layers.0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = block(_t(x), mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def pairs():
    """For each variant: JAX's mambamil from the config, its params, and the
    port's model and config with the same weights."""
    out = {}
    feats, mask = _bag(0)
    for variant, name in VARIANTS.items():
        jcfg = j_load_config([], **CFG, mambamil_type=name)
        jm, family = j_build_model(jcfg)
        assert family == "default" and jm.variant == variant
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), jnp.asarray(feats),
                                                  jnp.asarray(mask))["params"])
        cfg = load_config([], **CFG, mambamil_type=name)
        model, fam = build_model(cfg, device="cpu")
        assert fam == "default" and model.variant == variant
        model.load_state_dict(weights.mambamil_state_from_flax(params))
        out[variant] = (jcfg, jm, params, cfg, model)
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mambamil_matches_jax(pairs, variant):
    """Logits, bag_feat and attn of the whole model on a ragged batch, fp32."""
    jcfg, jm, params, cfg, model = pairs[variant]
    feats, mask = _bag(1)
    want = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(mask), return_attn=True)
    with torch.no_grad():
        got = model(_t(feats), _t(mask), return_attn=True)
    for key in ("logits", "bag_feat", "attn"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=key)
    assert got["attn"].shape == (2, N) and torch.all(got["attn"][1, LENGTHS[1]:] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_eval_step_matches_the_jax_eval_step(pairs, variant, dtype):
    """The eval steps on a padded batch: fp32 within 1e-5·max(1, max|ref|);
    the bf16 policy within 0.1, the scan and everything after the first
    layer's gate in fp32 on both sides."""
    jcfg, jm, params, cfg, model = pairs[variant]
    feats, mask = _bag(2)
    got = make_eval_step(cfg.replace(compute_dtype=dtype), model, "default")(
        {"feats": _t(feats), "mask": _t(mask)})["logits"]
    state = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state={}, teacher_params=None,
                          opt_state=(), rng=jax.random.PRNGKey(0), tx=optax.identity(), apply_fn=jm.apply)
    want = np.asarray(j_make_eval_step(jcfg.replace(compute_dtype=dtype), jm, "default")(
        state, {"feats": jnp.asarray(feats), "mask": jnp.asarray(mask)})["logits"])
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    tol = 1e-5 * max(1.0, np.abs(want).max()) if dtype == "float32" else 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mambamil_ignores_the_padding(pairs, variant):
    """Garbage in the padded rows leaves the logits as they were
    (``tests/test_scan.py:274``), and the second branch makes the variants
    differ from the single-branch block."""
    model = pairs[variant][4]
    feats, mask = _bag(4)
    poisoned = feats.copy()
    poisoned[1, LENGTHS[1]:] = 123.0
    with torch.no_grad():
        a = model(_t(feats), _t(mask))["logits"]
        b = model(_t(poisoned), _t(mask))["logits"]
        simple = pairs["simple"][4](_t(feats), _t(mask))["logits"]
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)
    assert torch.isfinite(a).all()
    assert (variant == "simple") == torch.allclose(a, simple)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generic_train_step_matches_jax(pairs, variant, monkeypatch):
    """One Adam step of each variant (dropout the identity on both sides):
    the loss within 1e-5 relative, the gradients within 1e-4 of the largest
    |g| of any parameter (JAX's by ``jax.grad``), the parameters within 2·lr."""
    jcfg, jm, params, cfg, model = pairs[variant]
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)
    model = copy.deepcopy(model)
    feats, mask = _bag(5)
    batch = {"feats": feats, "mask": mask, "target": np.array([1, 0], np.int32), "bag_valid": np.ones(2, bool)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = j_make_optimizer(jcfg, j_make_lr_schedule(jcfg, 2))
    jstate = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state={}, teacher_params=None,
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(3), tx=tx, apply_fn=jm.apply)
    jstate, jmetrics = j_make_train_step(jcfg, jm, "default", 2)(jstate, jbatch)
    state = create_train_state(cfg, model, 2, device="cpu")
    lr = float(state.optimizer.lr_schedule(0))
    metrics = make_train_step(cfg, "default", 2, "cpu")(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    criterion = j_build_criterion(jcfg)
    jgrads = jax.grad(lambda p: criterion(jm.apply({"params": p}, jbatch["feats"], jbatch["mask"], training=True,
                                                   rngs={"dropout": jax.random.PRNGKey(0)})["logits"], jbatch))(params)
    want_g = weights.mambamil_state_from_flax(jax.tree.map(np.asarray, jgrads))
    want = weights.mambamil_state_from_flax(jax.tree.map(np.asarray, jstate.params))
    g_max = max(float(g.abs().max()) for g in want_g.values())  # the softmax's bias has a zero gradient
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=0, atol=1e-4 * g_max,
                                   err_msg=f"grad {name}")
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=2 * lr, err_msg=name)
    if variant != "simple":  # the second branch trains
        assert model.layers[0].mixer.A_b_log.grad.abs().sum() > 0


@pytest.mark.parametrize("mambamil_type", [None, "none", "Mamba", "SimpleMamba", "SRMamba", "BiMamba"])
def test_mambamil_type_maps_as_in_jax(mambamil_type):
    """``--mambamil_type`` gives the variant JAX's registry gives, the
    second branch's parameters exactly where the variant has one."""
    cfg = load_config([], **CFG, mambamil_type=mambamil_type)
    model, family = build_model(cfg, device="cpu")
    jm, _ = j_build_model(j_load_config([], **CFG, mambamil_type=mambamil_type))
    assert family == "default" and model.variant == jm.variant
    mixer = model.layers[0].mixer
    assert hasattr(mixer, "conv1d_b") == (jm.variant != "simple")
    assert (mixer.ed, mixer.d_state, mixer.sr_rate) == (2 * DIM, STATE, RATE)


def test_driver_fold_trains_and_tests(monkeypatch):
    """One fold of srmamba through the port's driver under bf16 on
    synthetic bags: finite losses, a finite test row, and the step counts."""
    cfg = load_config([], **{**CFG, "compute_dtype": "bfloat16"}, mambamil_type="SRMamba", datasets="synth",
                      synth_n_slides=12, synth_bag_size=64, bucket_sizes=(64,), batch_size=4, cv_fold=1,
                      num_epoch=2, max_epoch=2, lr=1e-3, lr_sche="const", num_bootstrap=5, output_path="")
    res = driver.run_experiment(cfg, device="cpu")
    fold = res["folds"][0]
    assert res["kernel_gate"]["outcome"] == "skipped"
    assert np.isfinite(fold["test"]["auc"]) and all(np.isfinite(h["train_loss"]) for h in fold["history"])
    assert fold["timing"]["train_steps"] == 2 * 2
