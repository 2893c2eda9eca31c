"""The MHIM train step's ``ablate=`` variants against the JAX package's, fp32
on the CPU.

Each variant of ``mhim_mil_torch.engine.steps.make_mhim_train_step`` runs two
steps from the weights, the mining and merge draws and (for ``no_teacher``)
the fixed attention of JAX's ``make_mhim_train_step(..., ablate=v)``, dropout
the identity on both sides, at ``tests/test_torch_train.py``'s small widths:
the loss and every metric (the same keys), the student, the teacher,
``global_q`` and the step count. Parameters at rtol 1e-4, atol 1e-6, as
``test_train_steps_match_jax``, with one exception, :func:`_check_student`:
an entry whose gradient is rounding noise in both frameworks, where Adam's
update divides that noise by itself plus eps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train
from mhim_mil_tpu.models.mhim import make_mhim_train_step as j_make_train_step
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import ABLATIONS, make_mhim_train_step
from mhim_mil_torch.engine.train_state import create_mhim_state
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.models.mhim import MHIM
from mhim_mil_torch.utils.weights import state_dict_from_flax
from test_torch_train import CFG, SPE, _batch, _check_state, _close, _jax_steps, _port_draws, _t

NOISE = 1e-5  # gradients agree to this fraction of a tensor's max|g| (test_first_step_gradients_match_jax)


def _identity(self, x, *a, **k):
    return x


def _check_student(state, jstate, lr, steps, noisy):
    """The student's parameters at rtol 1e-4, atol 1e-6, except entries where
    Adam's first moment (its running gradient) is, at this step or an
    earlier one (``noisy``: name → bool mask, carried between calls), below
    NOISE·max|m| of the tensor in JAX: a gradient of rounding noise, which
    Adam's update divides by itself plus eps, so the two may move apart by
    up to 2·lr a step and stay apart. Those pass within 2·lr·steps; at most
    1e-4 of all entries may be such. After the first step, from the same
    weights, the first moments agree to NOISE·max|m| everywhere (after the
    second the exempt entries have moved the weights apart)."""
    mus = [s for s in jax.tree.leaves(jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    want_m = state_dict_from_flax(mus[0].mu, None)
    want = state_dict_from_flax(jstate.params, None)
    exempt = total = 0
    for k, p in state.model.named_parameters():
        m, wm = state.optimizer.opt.state[p]["exp_avg"], want_m[k]
        scale = NOISE * wm.abs().max().item()
        if steps == 1:
            _close(m, wm, rtol=0, atol=scale, msg=f"first moment {k}")
        noisy[k] = noisy.get(k, torch.zeros_like(p, dtype=torch.bool)) | (wm.abs() <= scale)
        d = (p.detach() - want[k]).abs()
        off = d > 1e-6 + 1e-4 * want[k].abs()
        assert bool(noisy[k][off].all()), f"student {k}: beyond tolerance where the gradient is not noise"
        assert bool((d[off] <= 2 * lr * steps).all()), f"student {k}"
        exempt, total = exempt + int(off.sum()), total + p.numel()
    assert exempt <= 1e-4 * total, (exempt, total)


def _ablated_jax_steps(monkeypatch, ablate, batch, **kw):
    """``_jax_steps`` on JAX's step built with ``ablate``."""
    monkeypatch.setattr(test_torch_train, "j_make_train_step",
                        lambda cfg, model, spe: j_make_train_step(cfg, model, spe, ablate=ablate))
    return _jax_steps(monkeypatch, "selfattn", "float32", 2, batch, **kw)


@pytest.mark.parametrize("model,ablate", [
    ("mhim", "no_teacher"), ("mhim", "fwd_only"), ("mhim", "no_opt_ema"), ("mhim", "no_ema"),
    ("mhim_pure", "no_teacher"), ("mhim_pure", "no_ema"),
])
def test_ablated_steps_match_jax(monkeypatch, model, ablate):
    batch = _batch(1)
    cfg, port, jout, draws = _ablated_jax_steps(monkeypatch, ablate, batch, model=model)
    monkeypatch.setattr(layers.Dropout, "forward", _identity)
    state = create_mhim_state(cfg, port, SPE, device="cpu")
    step = make_mhim_train_step(cfg, SPE, device="cpu", ablate=ablate)
    tb = {k: _t(v) for k, v in batch.items()}
    attn = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), batch["mask"].shape))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    noisy = {}
    for i, (jstate, jmetrics) in enumerate(jout):
        if model == "mhim_pure":
            step_draws = None
        else:
            step_draws = {**_port_draws(port, draws[3 * i:3 * i + 3]), "teacher_attn": _t(attn)}
        metrics = step(state, tb, draws=step_draws)
        assert set(metrics) == set(jmetrics)
        assert state.step == int(jstate.step) == i + 1
        if ablate in ("fwd_only", "no_opt_ema"):  # no update
            _check_state(state, jstate, jmetrics, metrics, rtol=1e-4, atol=1e-6)
        else:  # the teacher and global_q as _check_state holds them, the student by _check_student
            _check_state(state, jstate, jmetrics, metrics, rtol=1e-4, atol=1e-6, student=False)
            _check_student(state, jstate, float(state.optimizer.lr_schedule(0)), i + 1, noisy)
    moved = {k for k, v in port.state_dict().items() if not torch.equal(v, before[k])}
    if ablate in ("fwd_only", "no_opt_ema"):
        assert state.optimizer.count == 0 and state.optimizer.mini_step == 0 and not state.optimizer.opt.state
        assert moved == ({"merge.global_q_mm"} if model == "mhim" else set())
    else:
        assert state.optimizer.count == 2 and len(moved) == len(before)
    if ablate == "no_opt_ema":
        assert all(p.grad is not None for p in port.parameters())


def test_no_teacher_runs_no_teacher_forward(monkeypatch):
    """``no_teacher`` never calls ``forward_teacher``; without an injected
    attention it draws one once a mask shape, the same every step."""
    cfg = load_config(["-c", "config/mhim_c16.yaml"], **CFG)
    model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

    def refuse(*a, **k):
        raise AssertionError("the teacher ran")

    monkeypatch.setattr(MHIM, "forward_teacher", refuse)
    seen = []
    real = MHIM.forward

    def spy(self, feats, mask, attn=None, *a, **k):
        seen.append(attn.clone())
        return real(self, feats, mask, attn, *a, **k)

    monkeypatch.setattr(MHIM, "forward", spy)
    state = create_mhim_state(cfg, model, SPE, device="cpu")
    step = make_mhim_train_step(cfg, SPE, device="cpu", ablate="no_teacher")
    tb = {k: _t(v) for k, v in _batch(1).items()}
    for _ in range(2):
        assert torch.isfinite(step(state, tb)["loss"])
    assert len(seen) == 2 and torch.equal(seen[0], seen[1]) and seen[0].dtype == torch.float32
    mask = tb["mask"]
    assert bool((seen[0][~mask] == 0).all()) and bool((seen[0][mask] > 0).all())


@pytest.mark.parametrize("ablate", ["no_grad", "", "NO_EMA"])
def test_unknown_ablate_raises(ablate):
    cfg = load_config(["-c", "config/mhim_c16.yaml"], **CFG)
    assert ABLATIONS == (None, "no_teacher", "fwd_only", "no_opt_ema", "no_ema")
    with pytest.raises(ValueError, match="ablate"):
        make_mhim_train_step(cfg, SPE, device="cpu", ablate=ablate)
