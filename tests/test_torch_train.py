"""The port's MHIM training path against the JAX package, fp32 on the CPU.

Mining, compaction, the losses, the schedules, the optimizer, K3's
gradients, Merge, and whole train steps from identical weights and
identical random draws. Small widths: input_dim 16, inner_dim 32, 2 heads,
16 landmarks, bags of up to 96 instances with a ragged bag and a fake bag.
Tolerance rtol 1e-4, atol 1e-5 unless a test says otherwise.
"""

import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mhim_mil_tpu.models.merge as jmerge_mod
import mhim_mil_tpu.ops.masking as jmasking_mod
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine import losses as jlosses
from mhim_mil_tpu.engine.train_state import MILTrainState, make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.merge import MCA as JMCA, Merge as JMerge
from mhim_mil_tpu.models.mhim import make_mhim_train_step as j_make_train_step
from mhim_mil_tpu.ops import masked as jmasked, masking as jmasking
from mhim_mil_tpu.ops.pallas_nystrom import flash_nystrom as j_flash_nystrom
from mhim_mil_tpu.utils import schedules as jsched
from mhim_mil_tpu.utils.torch_import import import_merge, import_mhim_attn, import_mhim_selfattn
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine import losses
from mhim_mil_torch.engine.steps import make_mhim_train_step
from mhim_mil_torch.engine.train_state import create_mhim_state, make_optimizer
from mhim_mil_torch.models import build_model
from mhim_mil_torch.models import layers
from mhim_mil_torch.models.merge import MCA, Merge
from mhim_mil_torch.models.transformer import NystromMSA
from mhim_mil_torch.ops import flash_nystrom as fn
from mhim_mil_torch.ops import masked, masking
from mhim_mil_torch.ops.nystrom import nystrom_attention
from mhim_mil_torch.utils import schedules, weights
from mhim_mil_torch.utils.weights import state_dict_from_flax


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


RTOL, ATOL = 1e-4, 1e-5
IN_DIM, DIM, HEADS = 16, 32, 2
B, N, LENGTHS = 3, 96, (96, 70, 0)  # ragged, plus a fake bag
SPE = 2  # steps per epoch
CFG = dict(input_dim=IN_DIM, inner_dim=DIM, n_heads=HEADS, batch_size=B, num_epoch=2,
           compute_dtype="float32")


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, dtype=np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _valid(lengths, n):
    return np.arange(n)[None] < np.array(lengths)[:, None]


# ---- ops: masking ----------------------------------------------------------------


@pytest.mark.parametrize("largest", [True, False])
def test_topk_mask_with_ties_matches_jax(largest):
    """Scores rounded to one decimal tie often; ties are admitted in index
    order. Per-bag and per-head counts, one k of zero."""
    rng = np.random.default_rng(0)
    scores = np.round(rng.random((3, 2, 40)), 1).astype(np.float32)
    valid = np.broadcast_to(_valid((40, 25, 33), 40)[:, None], scores.shape)
    k = np.array([[7, 0], [5, 3], [40, 12]], np.int32)
    got = masked.topk_mask(_t(scores), _t(valid), _t(k), largest=largest)
    want = jmasked.topk_mask(jnp.asarray(scores), jnp.asarray(valid), jnp.asarray(k), largest=largest)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 1].sum() == 0


def test_random_subset_mask_and_compact_match_jax():
    rng = jax.random.PRNGKey(3)
    pool = _valid((50, 31, 0), 50) & (np.random.default_rng(1).random((3, 50)) > 0.3)
    k = np.array([9, 4, 2], np.int32)
    want = jmasked.random_subset_mask(rng, jnp.asarray(pool), jnp.asarray(k))
    u = np.asarray(jax.random.uniform(rng, pool.shape))
    got = masked.random_subset_mask(_t(u), _t(pool), _t(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.random.default_rng(2).normal(size=(3, 50, 4)).astype(np.float32)
    for out_len in (None, 20):
        got_c = masked.compact(_t(x), got, out_len)
        want_c = jmasked.compact(jnp.asarray(x), want, out_len)
        for g, w in zip(got_c, want_c):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fusion,mask_ratio,random_ratio,heads", [
    ("vote", 0.3, 1.0, 4), ("mean", 0.3, 0.5, 4), ("vote", 0.03, 0.5, 0), ("vote", 0.5, 0.001, 4),
])
def test_select_mask_matches_jax(fusion, mask_ratio, random_ratio, heads):
    """vote and mean fusion over heads, a [B,N] score, and the static fast
    path (mask_ratio / random_ratio >= 1); the port takes JAX's uniform draw."""
    rng = jax.random.PRNGKey(5)
    g = np.random.default_rng(4)
    attn = g.random((3, heads, 64) if heads else (3, 64)).astype(np.float32)
    valid = _valid((64, 41, 0), 64)
    prev = g.random((3, 64)) > 0.9
    want = jmasking.select_mask(rng, jnp.asarray(attn), jnp.asarray(valid), mask_ratio, True, random_ratio,
                                prev=jnp.asarray(prev), msa_fusion=fusion)
    u = np.asarray(jax.random.uniform(rng, valid.shape))
    got = masking.select_mask(_t(u), _t(attn), _t(valid), mask_ratio, True, random_ratio, prev=_t(prev),
                              msa_fusion=fusion)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mrh", [None, 0.017])
def test_layered_mask_matches_jax(mrh):
    """The three stages from the split of one key; the port gets
    jax.random.uniform(r_i, shape) for each stage that runs. The scheduled
    ratio is a float32 scalar, as the cosine schedule gives it."""
    sched_kw = dict(mask_ratio=0.5, mask_ratio_l=0.2, mask_ratio_h=0.03, mask_ratio_hr=0.5)
    rng = jax.random.PRNGKey(9)
    attn = np.random.default_rng(6).random((3, 96)).astype(np.float32)
    valid = _valid(LENGTHS, N)
    now = None if mrh is None else np.float32(mrh)
    want = jmasking.layered_mask(rng, jnp.asarray(attn), jnp.asarray(valid), jmasking.MaskSchedule(**sched_kw),
                                 None if now is None else jnp.asarray(now))
    u = [np.asarray(jax.random.uniform(r, valid.shape)) for r in jax.random.split(rng, 3)]
    got = masking.layered_mask([_t(x) for x in u], _t(attn), _t(valid), masking.MaskSchedule(**sched_kw),
                               None if now is None else torch.tensor(now))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(valid.sum())


# ---- losses, schedules, optimizer --------------------------------------------------


def test_losses_match_jax():
    g = np.random.default_rng(7)
    logits = (3 * g.normal(size=(4, 4))).astype(np.float32)
    labels = np.array([0, 3, 1, 2])
    w = np.array([True, True, False, True])
    cens = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    feats = g.normal(size=(4, 8)).astype(np.float32)
    tea = g.normal(size=(4, 8)).astype(np.float32)
    for wt in (None, w):
        wj, wp = (None, None) if wt is None else (jnp.asarray(wt), _t(wt))
        _close(losses.cross_entropy(_t(logits), _t(labels), wp), jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), wj))
        _close(losses.bce_with_logits(_t(logits), _t(labels), wp), jlosses.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels), wj))
        _close(losses.soft_target_ce(_t(feats), _t(tea), 0.1, 1.0, wp),
               jlosses.soft_target_ce(jnp.asarray(feats), jnp.asarray(tea), 0.1, 1.0, wj))
        _close(losses.nll_surv_loss(_t(logits), _t(labels), _t(cens), weights=wp),
               jlosses.nll_surv_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(cens), weights=wj))
    cfg = load_config([], loss="nll_surv")
    batch = {"target": _t(labels), "censorship": _t(cens), "bag_valid": _t(w)}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    _close(losses.build_criterion(cfg)(_t(logits), batch),
           jlosses.build_criterion(j_load_config([], loss="nll_surv"))(jnp.asarray(logits), jbatch))


@pytest.mark.parametrize("sche,supi", [("cosine", False), ("cosine", True), ("step", False), ("const", True)])
def test_schedules_match_jax(sche, supi):
    kw = dict(lr=2e-4, lr_sche=sche, lr_supi=supi, num_epoch=6, warmup_epochs=1, warmup_lr=1e-6)
    got = schedules.make_lr_schedule(load_config([], **kw), 5)
    want = jsched.make_lr_schedule(j_load_config([], **kw), 5)
    cos, jcos = schedules.cosine_schedule(0.03, 0.0, 37), jsched.cosine_schedule(0.03, 0.0, 37)
    for step in range(0, 33, 3):
        _close(got(step), want(step), rtol=1e-6, atol=0)
        assert float(cos(step)) == float(jcos(step))  # float32, bit for bit: it sets mining counts


@pytest.mark.parametrize("opt,clip", [("adam", None), ("adam", 0.5), ("adamw", None), ("sgd", 0.5)])
def test_optimizer_matches_optax(opt, clip):
    """Two updates of one tensor with a learning rate that moves: coupled L2
    (adam, sgd) or decoupled decay (adamw), and the global-norm clip."""
    kw = dict(opt=opt, clip_grad=clip, lr=1e-2, lr_sche="cosine", lr_supi=True, num_epoch=4, weight_decay=1e-2)
    g = np.random.default_rng(8)
    w0 = g.normal(size=(5, 3)).astype(np.float32)
    grads = [g.normal(size=(5, 3)).astype(np.float32) for _ in range(2)]
    tx = j_make_optimizer(j_load_config([], **kw), jsched.make_lr_schedule(j_load_config([], **kw), 2))
    params = {"w": jnp.asarray(w0)}
    st = tx.init(params)
    p = torch.nn.Parameter(_t(w0).clone())
    cfg = load_config([], **kw)
    opt_p = make_optimizer(cfg, [p], schedules.make_lr_schedule(cfg, 2))
    for i, gr in enumerate(grads):
        upd, st = tx.update({"w": jnp.asarray(gr)}, st, params)
        params = optax.apply_updates(params, upd)
        p.grad = _t(gr).clone()
        assert opt_p.step()
        assert opt_p.count == i + 1
        _close(p, params["w"], rtol=1e-5, atol=1e-7)


# ---- K3 ---------------------------------------------------------------------------


def test_flash_nystrom_grads_match_jax_interpret():
    """K3 (on the CPU: the kernels' plain versions forward, recompute
    backward) against JAX's custom-VJP flash_nystrom in interpreter mode:
    out, attn and the q/k/v gradients under random cotangents
    (tests/test_pallas_nystrom.py:61-98's shapes)."""
    g = np.random.default_rng(2)
    b, h, n, dh, m = 2, 2, 128, 16, 8
    q, k, v, co = (g.normal(size=(b, h, n, dh)).astype(np.float32) for _ in range(4))
    ca = g.normal(size=(b, h, n)).astype(np.float32)
    mask = _valid((n, 90), n)

    def jloss(q, k, v):
        out, attn = j_flash_nystrom(q, k, v, jnp.asarray(mask), m, 6, 64, True)
        return jnp.sum(out * co) + jnp.sum(attn * ca), (out, attn)

    (_, (want_out, want_attn)), want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    qt, kt, vt = (_t(t).requires_grad_() for t in (q, k, v))
    out, attn = fn.flash_nystrom(qt, kt, vt, _t(mask), m)
    ((out * _t(co)).sum() + (attn * _t(ca)).sum()).backward()
    _close(out, want_out)
    _close(attn, want_attn)
    for got, want in zip((qt.grad, kt.grad, vt.grad), want_g):
        _close(got, want)


def test_flash_nystrom_grads_with_attn_unused():
    """The student reads only ``out``: K3's backward then gets no attn
    cotangent and must give autograd's gradients through the plain
    attention's ``out`` alone."""
    g = np.random.default_rng(3)
    b, h, n, dh, m = 2, 2, 100, 16, 8
    q, k, v, co = (_t(g.normal(size=(b, h, n, dh)).astype(np.float32)) for _ in range(4))
    mask = _t(_valid((n, 61), n))
    grads = []
    for f in (fn.flash_nystrom, nystrom_attention):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out, _ = f(*qkv, mask, m)
        grads.append(torch.autograd.grad((out * co).sum(), qkv))
    for got, want in zip(*grads):
        _close(got, want)


# ---- modules in training mode -------------------------------------------------------


def _merge_pair(seed):
    jm = JMerge(DIM, k=1, heads=HEADS, dim_head=DIM // HEADS, g_q_mm=0.9, merge_ratio=0.2)
    x = np.random.default_rng(seed).normal(size=(B, N, DIM)).astype(np.float32)
    vis = _valid(LENGTHS, N) & (np.random.default_rng(seed + 1).random((B, N)) > 0.2)
    variables = jm.init({"params": jax.random.PRNGKey(seed), "mask": jax.random.PRNGKey(1)},
                        jnp.asarray(x), jnp.asarray(vis), training=True)
    v = jax.tree.map(np.asarray, variables)
    port = Merge(DIM, k=1, heads=HEADS, dim_head=DIM // HEADS, g_q_mm=0.9, merge_ratio=0.2)
    sd = {}
    weights.merge_state(sd, "", v["params"], v["buffers"])
    port.load_state_dict(sd)
    return jm, v, port, x, vis


def test_merge_matches_jax_in_training_and_eval(monkeypatch):
    """The keep split from an injected draw (floor(n_vis·0.2) per bag, in
    float32), the MCA merge of the rest, and the global_q EMA over the real
    bags only (the fake bag counts for nothing); eval summarises every
    visible token and leaves global_q alone. Dropout off on both sides."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)
    jm, v, port, x, vis = _merge_pair(11)
    rng = jax.random.PRNGKey(4)
    draws = []

    def rec(r, pool, k):  # record the draw JAX makes, then select as it does
        w = jax.random.uniform(r, pool.shape)
        draws.append(np.asarray(w))
        return jmasked.topk_mask(w, pool, k, largest=True)

    monkeypatch.setattr(jmerge_mod, "random_subset_mask", rec)
    (keep_w, merged_w), new_state = jm.apply(v, jnp.asarray(x), jnp.asarray(vis), training=True,
                                             rngs={"mask": rng}, mutable=["buffers"])
    u = draws[0]
    keep, merged = port(_t(x), _t(vis), training=True, gen=torch.Generator(), u=_t(u))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_w))
    np.testing.assert_array_equal(keep.sum(-1).numpy(), (vis.sum(-1) * np.float32(0.2)).astype(np.int32))
    _close(merged, merged_w)
    _close(port.global_q_mm, new_state["buffers"]["global_q"])
    assert not np.allclose(port.global_q_mm.numpy(), v["buffers"]["global_q"])
    before = port.global_q_mm.clone()
    with torch.no_grad():
        keep_e, merged_e = port(_t(x), _t(vis))
    _, merged_ew = jm.apply({"params": v["params"], **new_state}, jnp.asarray(x), jnp.asarray(vis),
                            training=False)
    _close(merged_e, merged_ew)
    assert torch.equal(keep_e, _t(vis)) and torch.equal(port.global_q_mm, before)


def test_mca_matches_jax():
    jm = JMCA(DIM, HEADS, DIM // HEADS)
    g = np.random.default_rng(12)
    x = g.normal(size=(B, N, DIM)).astype(np.float32)
    q = g.normal(size=(B, 2, DIM)).astype(np.float32)
    kv = _valid(LENGTHS, N)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(q), jnp.asarray(kv)))
    port = MCA(DIM, HEADS, DIM // HEADS)
    p = v["params"]
    port.load_state_dict({"to_kv.weight": _t(p["to_kv"]["kernel"].T), "to_q.weight": _t(p["to_q"]["kernel"].T),
                          "to_out.0.weight": _t(p["to_out"]["kernel"].T), "to_out.0.bias": _t(p["to_out"]["bias"])})
    _close(port(_t(x), _t(q), _t(kv)), jm.apply(v, jnp.asarray(x), jnp.asarray(q), jnp.asarray(kv)))


def test_dropout_is_explicit_and_off_the_scored_values():
    """Dropout draws from the generator it is given (reproducible, torch's
    global generator untouched), scales the kept entries by 1/(1-p), and in
    NystromMSA reaches the attention output but not the scored values."""
    drop = layers.Dropout(0.25)
    x = torch.ones(4000)
    state = torch.random.get_rng_state()
    a = drop(x, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, drop(x, True, torch.Generator().manual_seed(3)))
    assert torch.equal(torch.random.get_rng_state(), state)
    assert set(a.unique().tolist()) == {0.0, float(np.float32(1.0) / np.float32(0.75))}
    assert abs(float((a == 0).float().mean()) - 0.25) < 0.03
    with pytest.raises(ValueError):
        drop(x, True, None)
    assert torch.equal(drop(x, False, None), x)

    layers.init_weights(msa := NystromMSA(DIM, HEADS, DIM // HEADS, 8), torch.Generator().manual_seed(0))
    xs = torch.randn(2, 40, DIM)
    mask = torch.ones(2, 40, dtype=torch.bool)
    with torch.no_grad():
        out_e, _, _, scored_e = msa(xs, mask, True)
        out_t, _, _, scored_t = msa(xs, mask, True, True, torch.Generator().manual_seed(1))
    assert torch.equal(scored_t, scored_e)
    assert not torch.allclose(out_t, out_e)


# ---- whole train steps ---------------------------------------------------------------


def _batch(seed):
    g = np.random.default_rng(seed)
    return {"feats": g.normal(size=(B, N, IN_DIM)).astype(np.float32), "mask": _valid(LENGTHS, N),
            "bag_valid": np.array(LENGTHS) > 0, "target": np.array([0, 1, 0], np.int32)}


def _port_flax(model, baseline):
    """The port's weights as the JAX package's params and buffers, through
    its importers (a ``mhim_pure`` model has no Merge and no buffers)."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = (import_mhim_selfattn if baseline == "selfattn" else import_mhim_attn)(sd)
    if not any(k.startswith("merge.") for k in sd):
        return params, {}
    params["merge"], mb = import_merge(sd)
    return params, {"buffers": {"merge": mb}}


def _jax_steps(monkeypatch, baseline, compute_dtype, n_steps, batch, **kw):
    """Build the port's model, carry its weights into JAX and run ``n_steps``
    JAX train steps with dropout off, recording every uniform draw of the
    mining and merge stages in order. ``kw`` overrides the config of both."""
    kw = {**CFG, "compute_dtype": compute_dtype, **kw}
    cfg = load_config(["-c", "config/mhim_c16.yaml"], baseline=baseline, **kw)
    model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    jcfg = j_load_config(["-c", "config/mhim_c16.yaml"], baseline=baseline, **kw)
    jmodel, _ = j_build_model(jcfg)
    params, model_state = _port_flax(model, baseline)
    tx = j_make_optimizer(jcfg, jsched.make_lr_schedule(jcfg, SPE))
    state = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=model_state,
                          teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                          rng=jax.random.PRNGKey(0), tx=tx, apply_fn=jmodel.apply)
    draws = []

    def rec(rng, pool, k):
        u = jax.random.uniform(rng, pool.shape)
        jax.debug.callback(lambda a: draws.append(np.asarray(a)), u, ordered=True)
        return jmasked.topk_mask(u, pool, k, largest=True)

    monkeypatch.setattr(jmasking_mod, "random_subset_mask", rec)
    monkeypatch.setattr(jmerge_mod, "random_subset_mask", rec)
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    step = j_make_train_step(jcfg, jmodel, SPE)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(n_steps):
        state, metrics = step(state, jbatch)
        jax.block_until_ready(metrics)
        out.append((jax.tree.map(np.asarray, state), {k: float(v) for k, v in metrics.items()}))
    return cfg, model, out, draws


def _port_draws(model, draws):
    """The recorded draws of one step as MHIM.forward takes them."""
    it = iter(draws)
    on = model.sched.stages(True)  # the flagship schedules mask_ratio_h
    return {"mask": [_t(next(it)) if s else None for s in on], "merge": _t(next(it))}


def _check_state(state, jstate, jmetrics, metrics, rtol, atol, student=True):
    """The metrics, the student (its parameters only where ``student``; its
    buffers always) and the teacher against JAX's state and metrics."""
    for k, want in jmetrics.items():
        _close(metrics[k], want, rtol=RTOL, atol=ATOL, msg=k)
    buffers = jstate.model_state.get("buffers")
    want = state_dict_from_flax(jstate.params, buffers)
    got = state.model.state_dict()
    assert set(got) == set(want)
    params = {n for n, _ in state.model.named_parameters()}
    for k in want:
        if student or k not in params:
            _close(got[k], want[k], rtol, atol, msg=f"student {k}")
    want_t = state_dict_from_flax(jstate.teacher_params, buffers)
    for k, t in state.teacher.state_dict().items():
        if k != "merge.global_q_mm":  # the teacher's copy of the buffer is never read
            _close(t, want_t[k], rtol, atol, msg=f"teacher {k}")


@pytest.mark.parametrize("baseline", ["selfattn", "attn"])
def test_train_steps_match_jax(monkeypatch, baseline):
    """Two port train steps from identical weights and draws equal two JAX
    steps in fp32 (the mrh schedule moves between them): loss and metrics,
    the student's parameters and global_q, the teacher's parameters.
    Parameters at rtol 1e-4, atol 1e-6, the JAX package's own flash-vs-XLA
    step tolerance (tests/test_pallas_nystrom.py:155-156)."""
    batch = _batch(1)
    cfg, model, jout, draws = _jax_steps(monkeypatch, baseline, "float32", 2, batch)
    assert len(draws) == 6  # per step: the random and high mining stages, the merge split
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)
    state = create_mhim_state(cfg, model, SPE, device="cpu")
    step = make_mhim_train_step(cfg, SPE, device="cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    for i, (jstate, jmetrics) in enumerate(jout):
        metrics = step(state, tb, draws=_port_draws(model, draws[3 * i:3 * i + 3]))
        assert state.step == i + 1
        _check_state(state, jstate, jmetrics, metrics, rtol=1e-4, atol=1e-6)
    v_static = model.static_survivors(N)
    assert (v_static, model.merge_len(v_static)) == (49, 10)
    assert metrics["keep_num"] <= model.merge_len(v_static) + 1


@pytest.mark.parametrize("attention", ["wrappers", "materialising"])
def test_first_step_gradients_match_jax(monkeypatch, attention):
    """The first fp32 MHIM-selfattn step's gradients, read as Adam's first
    moment (1 − β1)·g, equal JAX's within 1e-5 of each tensor's max|·|,
    whether the CPU runs the kernels' wrappers below ``stream_min_len`` (the
    port's dispatch) or the materialising op (JAX's): the two compute the
    same function. The parameters after the step may still differ by more
    (test_train_steps_match_jax), where Adam's first update divides a
    gradient of rounding noise by itself plus eps (NystromMSA's docstring)."""
    if attention == "materialising":
        monkeypatch.setattr(NystromMSA, "path", lambda self, n, on_cuda, no_norm=False: "materialising")
    batch = _batch(1)
    cfg, model, jout, draws = _jax_steps(monkeypatch, "selfattn", "float32", 1, batch)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)
    state = create_mhim_state(cfg, model, SPE, device="cpu")
    make_mhim_train_step(cfg, SPE, device="cpu")(state, {k: _t(v) for k, v in batch.items()},
                                                 draws=_port_draws(model, draws))
    moments = [s for s in jax.tree.leaves(jout[0][0].opt_state, is_leaf=lambda x: hasattr(x, "mu"))
               if hasattr(s, "mu")]
    want = state_dict_from_flax(moments[0].mu, None)
    params = dict(model.named_parameters())
    assert set(params) <= set(want)
    for k, p in params.items():
        got = state.optimizer.opt.state[p]["exp_avg"]
        _close(got, want[k], rtol=0, atol=1e-5 * want[k].abs().max().item(), msg=k)


def test_bf16_step_loss_is_close_to_jax(monkeypatch):
    """Under the default bf16 policy, the port's first step against JAX's on
    the same weights and draws: the two frameworks round to bf16 at other
    places, so the loss agrees to 2e-2 (relative), and the fp32 master
    weights take the update."""
    batch = _batch(2)
    cfg, model, jout, draws = _jax_steps(monkeypatch, "selfattn", "bfloat16", 1, batch)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x, *a, **k: x)
    state = create_mhim_state(cfg, model, SPE, device="cpu")
    before = copy.deepcopy(model.state_dict())
    metrics = make_mhim_train_step(cfg, SPE, device="cpu")(
        state, {k: _t(v) for k, v in batch.items()}, draws=_port_draws(model, draws))
    _close(metrics["loss"], jout[0][1]["loss"], rtol=2e-2, atol=0)
    assert torch.isfinite(metrics["loss"])
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, name
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)  # every parameter and global_q
    assert all(t.dtype == torch.float32 for s in state.optimizer.opt.state.values() for t in s.values()
               if torch.is_tensor(t) and t.dim() > 0)


def test_training_teacher_draws_dropout_from_its_generator():
    """forward_teacher(training=True) is stochastic across generators,
    reproducible from one, and differs from the eval-mode teacher, which is
    deterministic (the JAX package's test_mhim.py:217, for the port)."""
    cfg = load_config(["-c", "config/mhim_c16.yaml"], baseline="attn", **CFG)
    model, _ = build_model(cfg, device="cpu")
    b = _batch(3)
    feats, mask = _t(b["feats"]), _t(b["mask"])

    def tea(seed, training):
        gen = torch.Generator().manual_seed(seed)
        return model.forward_teacher(feats, mask, training=training, gen=gen)[0]

    assert torch.equal(tea(0, True), tea(0, True))
    assert not torch.allclose(tea(0, True), tea(1, True))
    assert not torch.allclose(tea(0, True), tea(0, False))
    assert torch.equal(tea(0, False), tea(1, False))


def test_train_step_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = load_config(["-c", "config/mhim_c16.yaml"], **CFG)
    model, _ = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mhim_train_step(cfg, SPE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_mhim_state(cfg, model, SPE)
