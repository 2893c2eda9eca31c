"""The teacher stage of the port against the JAX package, fp32 on the CPU.

``MHIM.pure`` and the ``mhim_pure`` train step, gradient accumulation
(``optax.MultiSteps``), the JAX ``.ckpt`` read without JAX, flax or optax and
overlaid as JAX's driver overlays it, and Nystrom's ``no_norm`` and
``parity`` modes. Small widths (the ``--small`` shapes of the other port
tests): input_dim 16, inner_dim 32, 2 heads, 16 landmarks, bags of up to 96
instances with a ragged bag and a fake bag; dropout patched to the identity
on both sides where a pass trains. Tolerance rtol 1e-4, atol 1e-5 unless a
test says otherwise.
"""

import copy
import os
import pickle
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine import driver as j_driver
from mhim_mil_tpu.engine.train_state import make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.mhim import MHIM as JMHIM, create_mhim_state as j_create_mhim_state
from mhim_mil_tpu.ops.nystrom import nystrom_attention as j_nystrom_attention
from mhim_mil_tpu.utils import schedules as jsched
from mhim_mil_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine import driver
from mhim_mil_torch.engine.steps import make_mhim_train_step
from mhim_mil_torch.engine.train_state import create_mhim_state, make_optimizer
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.models import transformer
from mhim_mil_torch.ops.nystrom import nystrom_attention
from mhim_mil_torch.utils import schedules
from mhim_mil_torch.utils.checkpoint import is_jax_checkpoint, load_jax_checkpoint, save_checkpoint
from mhim_mil_torch.utils.weights import state_dict_from_flax
from test_torch_train import CFG, LENGTHS, SPE, _batch, _check_state, _close, _jax_steps, _port_draws, _port_flax, _t


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for torch: beside the other test workers its
    thread pool spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C16 = "config/mhim_c16.yaml"
TINY = dict(datasets="synth", synth_n_slides=12, synth_bag_size=64, bucket_sizes=(64,), batch_size=4, cv_fold=1,
            num_epoch=2, max_epoch=2, lr=1e-3, lr_sche="const", num_bootstrap=5, output_path="")


def _identity(self, x, *a, **k):
    return x


def _pair(monkeypatch, model, baseline):
    """The port's model (weights from a seed) and the JAX model with the same
    weights, dropout the identity on both sides."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__", _identity)
    monkeypatch.setattr(layers.Dropout, "forward", _identity)
    kw = {**CFG, "model": model, "baseline": baseline}
    port, _ = build_model(load_config(["-c", C16], **kw), device="cpu", generator=torch.Generator().manual_seed(0))
    jmodel, _ = j_build_model(j_load_config(["-c", C16], **kw))
    params, model_state = _port_flax(port, baseline)
    return port, jmodel, {"params": params, **model_state}


# ---- MHIM.pure and the mhim_pure step --------------------------------------------------


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
@pytest.mark.parametrize("baseline", ["selfattn", "attn"])
def test_pure_matches_jax(monkeypatch, baseline, training):
    """``MHIM.pure`` (the selfattn training pass through K3's composition)
    against JAX's ``MHIM.pure``: logits, a zero aux_loss, and patch_num and
    keep_num both the bag's size."""
    port, jmodel, variables = _pair(monkeypatch, "mhim_pure", baseline)
    b = _batch(4)
    want = jmodel.apply(variables, jnp.asarray(b["feats"]), jnp.asarray(b["mask"]), training=training,
                        method=JMHIM.pure, rngs={"dropout": jax.random.PRNGKey(0)})
    got = port.pure(_t(b["feats"]), _t(b["mask"]), training=training, gen=torch.Generator().manual_seed(0))
    _close(got["logits"], want["logits"])
    assert float(got["aux_loss"]) == float(want["aux_loss"]) == 0.0
    for key in ("patch_num", "keep_num"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(got["keep_num"].numpy(), LENGTHS)


@pytest.mark.parametrize("baseline", ["selfattn", "attn"])
def test_pure_train_steps_match_jax(monkeypatch, baseline):
    """Two ``mhim_pure`` train steps from identical weights against two JAX
    steps in fp32: loss and metrics, the student's parameters (rtol 1e-4,
    atol 1e-6, as ``test_train_steps_match_jax``); the teacher, which no EMA
    moves, stays the initial copy, bit for bit, as JAX's does."""
    batch = _batch(1)
    cfg, model, jout, draws = _jax_steps(monkeypatch, baseline, "float32", 2, batch, model="mhim_pure")
    assert not draws and not hasattr(model, "merge")
    monkeypatch.setattr(layers.Dropout, "forward", _identity)
    state = create_mhim_state(cfg, model, SPE, device="cpu")
    teacher0 = copy.deepcopy(state.teacher.state_dict())
    step = make_mhim_train_step(cfg, SPE, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    for jstate, jmetrics in jout:
        metrics = step(state, tb)
        _check_state(state, jstate, jmetrics, metrics, rtol=1e-4, atol=1e-6)
        assert all(torch.equal(v, teacher0[k]) for k, v in state.teacher.state_dict().items())
        assert float(metrics["aux_loss"]) == 0.0 and float(metrics["keep_num"]) == float(metrics["patch_num"])
    assert not torch.equal(model.predictor.weight, teacher0["predictor.weight"])


# ---- gradient accumulation -----------------------------------------------------------


@pytest.mark.parametrize("opt,clip", [("adam", 0.5), ("sgd", None)])
def test_accumulation_matches_optax_multisteps(opt, clip):
    """``accumulation_steps`` 2 over four micro-steps against
    ``optax.MultiSteps`` around JAX's chain: the parameters move on the
    second and fourth only, by the clipped mean of two gradients, at the
    learning rate of the update count (cosine over 8 steps, so a schedule
    read at the micro-step count would differ). A copy resumed from the
    ``state_dict`` taken after the first micro-step (mid-accumulation) ends
    where the uninterrupted one does."""
    kw = dict(opt=opt, clip_grad=clip, lr=1e-2, lr_sche="cosine", num_epoch=4, weight_decay=1e-2,
              accumulation_steps=2)
    g = np.random.default_rng(8)
    w0 = g.normal(size=(5, 3)).astype(np.float32)
    grads = [g.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    jcfg = j_load_config([], **kw)
    tx = j_make_optimizer(jcfg, jsched.make_lr_schedule(jcfg, 2))
    params = {"w": jnp.asarray(w0)}
    st = tx.init(params)
    cfg = load_config([], **kw)
    p = torch.nn.Parameter(_t(w0).clone())
    opt_p = make_optimizer(cfg, [p], schedules.make_lr_schedule(cfg, 2))
    resumed = None
    for i, gr in enumerate(grads):
        upd, st = tx.update({"w": jnp.asarray(gr)}, st, params)
        params = optax.apply_updates(params, upd)
        p.grad = _t(gr).clone()
        assert opt_p.step() == (i % 2 == 1)
        assert (opt_p.count, opt_p.mini_step) == ((i + 1) // 2, (i + 1) % 2)
        _close(p, params["w"], rtol=1e-5, atol=1e-7)
        if resumed is not None:
            q.grad = _t(gr).clone()
            resumed.step()
            _close(q, params["w"], rtol=1e-5, atol=1e-7)
        if i == 0:
            assert torch.equal(p, _t(w0))
            sd = copy.deepcopy(opt_p.state_dict())
            q = torch.nn.Parameter(p.detach().clone())
            resumed = make_optimizer(cfg, [q], schedules.make_lr_schedule(cfg, 2))
            resumed.load_state_dict(sd)
    assert int(st.gradient_step) == opt_p.count == 2
    assert torch.equal(p, q)


def test_mhim_steps_with_accumulation_match_jax(monkeypatch):
    """Four MHIM-attn train steps under ``accumulation_steps`` 2 and
    ``clip_grad`` against JAX's: the student moves on the second and fourth
    step only; the teacher EMA and the scheduled mrh run on every micro-step
    at the micro-step count; loss, metrics, student, teacher and global_q as
    ``test_train_steps_match_jax`` holds them."""
    batch = _batch(3)
    cfg, model, jout, draws = _jax_steps(monkeypatch, "attn", "float32", 4, batch, accumulation_steps=2,
                                         clip_grad=1.0)
    monkeypatch.setattr(layers.Dropout, "forward", _identity)
    state = create_mhim_state(cfg, model, SPE, device="cpu")
    step = make_mhim_train_step(cfg, SPE, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    for i, (jstate, jmetrics) in enumerate(jout):
        w, t = (m.predictor.weight.detach().clone() for m in (model, state.teacher))
        metrics = step(state, tb, draws=_port_draws(model, draws[3 * i:3 * i + 3]))
        _check_state(state, jstate, jmetrics, metrics, rtol=1e-4, atol=1e-6)
        assert torch.equal(model.predictor.weight, w) == (i % 2 == 0)
        if i == 2:  # the EMA runs between updates, toward the unmoved student
            assert not torch.equal(state.teacher.predictor.weight, t)
    assert state.optimizer.count == 2 and state.step == 4


# ---- a JAX .ckpt as the teacher ---------------------------------------------------------


def _jax_checkpoint(path, model, **kw):
    """A JAX MHIM-attn train state (flax init, Adam under MultiSteps and a
    clip, so the pickle holds optax's states) written by the JAX package's
    ``save_checkpoint``. Returns its params and buffers as numpy trees."""
    jcfg = j_load_config(["-c", C16], **{**CFG, **TINY, "model": model, "baseline": "attn",
                                          "accumulation_steps": 2, "clip_grad": 1.0, **kw})
    jmodel, _ = j_build_model(jcfg)
    b = _batch(5)
    sample = {"feats": jnp.asarray(b["feats"]), "mask": jnp.asarray(b["mask"])}
    state = j_create_mhim_state(jcfg, jmodel, jax.random.PRNGKey(7), sample, jsched.make_lr_schedule(jcfg, SPE))
    j_save_checkpoint(str(path), state, metadata={"epoch": 3, "val_metric": np.float32(0.75)})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return to_np(state.params), to_np(state.model_state.get("buffers"))


def test_a_jax_ckpt_reads_without_jax_flax_or_optax(tmp_path):
    """A ``mhim_pure`` checkpoint of the JAX package, read by the port in a
    process where importing jax, jaxlib, flax, optax or chex fails: the
    params convert to the state_dict that ``state_dict_from_flax`` makes of
    JAX's own tree, exactly; step and metadata come through."""
    path, out = tmp_path / "fold_0_model_best.ckpt", tmp_path / "sd.pt"
    params, _ = _jax_checkpoint(path, "mhim_pure")
    assert is_jax_checkpoint(str(path))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'chex'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from mhim_mil_torch.utils.checkpoint import is_jax_checkpoint, load_jax_checkpoint\n"
        "from mhim_mil_torch.utils.weights import state_dict_from_flax\n"
        f"path = {str(path)!r}\n"
        "assert is_jax_checkpoint(path)\n"
        "payload = load_jax_checkpoint(path)\n"
        "assert payload['step'] == 0 and payload['metadata']['epoch'] == 3, payload['metadata']\n"
        "assert float(payload['metadata']['val_metric']) == 0.75\n"
        f"torch.save(state_dict_from_flax(payload['params']), {str(out)!r})\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None\n"
        "             and k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'chex', 'mhim_mil_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    got, want = torch.load(out, weights_only=True), state_dict_from_flax(params)
    assert set(got) == set(want) and not any(k.startswith("merge.") for k in got)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_checkpoint_formats_are_told_apart_and_the_reader_admits_numpy_only(tmp_path):
    cfg = load_config(["-c", C16], **CFG)
    model, _ = build_model(cfg, device="cpu")
    port = tmp_path / "port.ckpt"
    save_checkpoint(str(port), create_mhim_state(cfg, model, 1, device="cpu"))
    assert not is_jax_checkpoint(str(port))
    (tmp_path / "text.ckpt").write_text("not a checkpoint")
    with pytest.raises(ValueError):
        is_jax_checkpoint(str(tmp_path / "text.ckpt"))
    evil = tmp_path / "evil.ckpt"
    evil.write_bytes(pickle.dumps({"params": os.getcwd}, protocol=4))
    assert is_jax_checkpoint(str(evil))
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd|os.getcwd|nt.getcwd"):
        load_jax_checkpoint(str(evil))


@pytest.mark.parametrize("mode", ["none", "fc", "all"])
def test_teacher_init_from_a_jax_ckpt_overlays_as_jax_does(tmp_path, mode):
    """``--teacher_init`` with a JAX MHIM checkpoint (Merge included) against
    JAX's ``_build_fold`` on the same file: the teacher takes every param of
    the file (JAX's teacher, converted, equal to the bit), the student the
    params that ``init_stu_type`` names; the rest, and ``global_q`` in both
    modules (JAX's model_state stays at init for a ``.ckpt``), keep the
    port's own initial values."""
    path = tmp_path / "teacher.ckpt"
    params, _ = _jax_checkpoint(path, "mhim")
    loaded = state_dict_from_flax(params)
    assert "merge.attn.to_q.weight" in loaded and "merge.global_q_mm" not in loaded
    kw = {**CFG, **TINY, "baseline": "attn", "teacher_init": str(path), "init_stu_type": mode}
    cfg = load_config(["-c", C16], **kw)
    train = driver.get_folds(cfg)[0][0]
    _, _, state, _ = driver._build_fold(cfg, train, cfg.seed, 0, "cpu")
    init, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(cfg.seed))
    init = init.state_dict()
    jcfg = j_load_config(["-c", C16], **kw)
    jstate = j_driver._build_fold(jcfg, train, jcfg.seed, 0)[2]
    j_teacher = state_dict_from_flax(jax.tree.map(np.asarray, jstate.teacher_params))
    j_student = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    teacher, student = state.teacher.state_dict(), state.model.state_dict()
    for k, v in teacher.items():
        assert torch.equal(v, j_teacher[k] if k in loaded else init[k]), k
    taken = {"none": (), "fc": ("feature.",), "all": ("",)}[mode]
    for k, v in student.items():
        took = k in loaded and k.startswith(taken)
        assert torch.equal(v, j_student[k] if took else init[k]), k
        if took:
            assert torch.equal(v, loaded[k]), k


# ---- Nystrom's no_norm and parity modes ------------------------------------------------------


@pytest.mark.parametrize("n,lengths,no_norm,parity", [
    (100, (100, 73), True, False),
    (100, (100, 100), False, True),
    (96, (96, 60), False, True),
    (100, (100, 100), True, True),
], ids=["no_norm-ragged", "parity-front-pad", "parity-divisible-ragged", "both"])
def test_nystrom_modes_match_jax(n, lengths, no_norm, parity):
    """The plain ``nystrom_attention`` in the reference's ``no_norm`` (raw
    similarities and the pseudo-inverse of the raw sim2 in the returned
    attention) and ``parity`` (front padding counted as keys, landmark means
    over whole groups) modes against JAX's: out and the cls attention."""
    g = np.random.default_rng(9)
    q, k, v = (g.normal(size=(2, 2, n, 8)).astype(np.float32) for _ in range(3))
    q *= 8 ** -0.5
    mask = np.arange(n)[None] < np.array(lengths)[:, None]
    want = j_nystrom_attention(*(jnp.asarray(t) for t in (q, k, v, mask)), 16, return_attn=True,
                               no_norm=no_norm, parity=parity)
    got = nystrom_attention(*(_t(t) for t in (q, k, v, mask)), 16, return_attn=True, no_norm=no_norm,
                            parity=parity)
    for gt, w in zip(got, want):
        assert tuple(gt.shape) == w.shape
        _close(gt, w)


@pytest.mark.parametrize("baseline", ["selfattn", "attn"])
def test_forward_test_no_norm_matches_jax(monkeypatch, baseline):
    """``forward_test(return_attn=True, no_norm=True)`` of the flagship MHIM
    against JAX's: the logits and the unsoftmaxed attention."""
    port, jmodel, variables = _pair(monkeypatch, "mhim", baseline)
    b = _batch(6)
    want = jmodel.apply(variables, jnp.asarray(b["feats"]), jnp.asarray(b["mask"]), return_attn=True,
                        no_norm=True, method=JMHIM.forward_test)
    got = port.forward_test(_t(b["feats"]), _t(b["mask"]), return_attn=True, no_norm=True)
    _close(got["logits"], want["logits"])
    _close(got["attn"], want["attn"])


def test_the_modes_select_the_plain_op_under_use_flash(monkeypatch):
    """With ``use_flash`` on, a ``parity`` layer and a ``no_norm`` call run
    the plain ``nystrom_attention`` (the kernels compute neither mode); a
    default call still reaches the kernels' wrappers."""
    def refuse(*a, **k):
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(transformer, "flash_nystrom", refuse)
    monkeypatch.setattr(transformer, "flash_nystrom_infer", refuse)
    x = torch.randn(2, 40, 32)
    mask = torch.ones(2, 40, dtype=torch.bool)
    with torch.no_grad():
        transformer.NystromMSA(32, 2, 16, 16, use_flash=True, parity=True)(x, mask, True)
        msa = transformer.NystromMSA(32, 2, 16, 16, use_flash=True)
        msa(x, mask, True, no_norm=True)
        with pytest.raises(AssertionError, match="kernel path"):
            msa(x, mask, True)
