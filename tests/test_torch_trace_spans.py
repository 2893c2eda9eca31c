"""What a profile sees of the port: the backward kernels K1b, K2b and K3p's
reverse sweep as the ops ``torch.ops.mhim_mil_torch.pass_a_backward``,
``.pass_b_backward`` and ``.newton_schulz_backward``, and a scorer request
as the range ``scorer.request`` around its stages.

On CPU tensors the ops run the plain versions: the wrappers give exactly
what those give, the ops pass ``torch.library.opcheck``, and a CPU
``torch.profiler`` run of a small TransMIL train step records each op once
a layer with the input shapes that fix its work. Small widths (input 16,
inner 32, 2 heads, 16 landmarks), bags under ``NystromMSA.stream_min_len``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import make_train_step
from mhim_mil_torch.engine.train_state import create_train_state
from mhim_mil_torch.models import build_model
from mhim_mil_torch.ops import flash_nystrom as fn
from mhim_mil_torch.ops import nystrom_pinv as npv
from mhim_mil_torch.ops.nystrom import pinv_start
from mhim_mil_torch.utils.serving import Scorer, ServingBundle, export_serving_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(input_dim=16, inner_dim=32, n_heads=2, compute_dtype="float32")
STAGES = ("scorer.h2d", "scorer.pad", "scorer.forward", "scorer.to_host")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch: beside the other test workers its
    thread pool spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _operands(seed=0, b=2, h=2, n=24, m=8, dh=16):
    """K1's and K2's operands as K3 forms them, K2's output, and cotangents
    of every output of K1 and K2, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    mask = torch.arange(n)[None] < torch.tensor([[n], [n // 2 + 1]])
    q, k, v = r(b, h, n, dh) * dh ** -0.5, r(b, h, n, dh), r(b, h, n, dh)
    ql, kl, lm, pinv = fn.landmarks(q, k, mask, m)
    attn3v, m3, s3 = fn.pass_a_plain(ql, k, v, mask)
    mid, rp = fn.pass_b_operands(q, kl, mask, lm, pinv, attn3v, s3)
    out, _ = fn.pass_b_plain(q, k, mask, kl, lm, mid, ql, rp, m3)
    return {"a": (ql, k, v, mask, attn3v, m3, s3), "b": (q, k, mask, kl, lm, mid, ql, rp, m3), "out": out,
            "d_attn3v": r(b, h, m, dh), "d_s3": r(b, h, m), "d_out": r(b, h, n, dh), "d_cls": r(b, h, n)}


def _sweep_operands(iters=3, m=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(1)
    x, z0 = pinv_start(torch.softmax(torch.randn(4, m, m, generator=g, dtype=dtype), -1))
    _, iterates = torch.ops.mhim_mil_torch.newton_schulz(x, z0.contiguous(), iters, True)
    return x, iterates, torch.randn(4, m, m, generator=g, dtype=dtype)


@pytest.mark.parametrize("case", ["k1b", "k1b d_s3", "k2b", "k2b d_cls", "k2b without out", "sweep"])
def test_backward_ops_pass_opcheck(case):
    """Each op's schema, its fake's shapes, dtypes and strides against the
    CPU kernel's, and AOT dispatch with a dynamic batch."""
    o = _operands()
    if case.startswith("k1b"):
        op = torch.ops.mhim_mil_torch.pass_a_backward.default
        args = (*o["a"], o["d_attn3v"], o["d_s3"] if "d_s3" in case else None)
    elif case.startswith("k2b"):
        op = torch.ops.mhim_mil_torch.pass_b_backward.default
        args = (*o["b"], o["d_out"], o["d_cls"] if "d_cls" in case else None,
                None if "without" in case else o["out"])
    else:
        op, args = torch.ops.mhim_mil_torch.newton_schulz_backward.default, _sweep_operands()
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("cot", [False, True])
def test_pass_a_backward_is_the_plain_function(cot):
    o = _operands(seed=2)
    args = (*o["a"], o["d_attn3v"], o["d_s3"] if cot else None)
    got, want = fn.pass_a_backward(*args), fn.pass_a_backward_plain(*args)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("cls", [False, True])
def test_pass_b_backward_is_the_plain_function(cls):
    """The seven gradients, None where the plain function gives None, cut
    from the op's landmark rows."""
    o = _operands(seed=3)
    args = (*o["b"], o["d_out"], o["d_cls"] if cls else None)
    want = fn.pass_b_backward_plain(*args)
    for got in (fn.pass_b_backward(*args), fn.pass_b_backward(*args, out=o["out"])):
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if b is not None:
                assert a.shape == b.shape and torch.equal(a, b)


def test_sweep_is_the_vjp_of_the_iterations():
    """The reverse sweep from ``newton_schulz``'s iterates is the
    vector-Jacobian product of the forward iterations (autograd through
    the plain products, fp64)."""
    x, iterates, g = _sweep_operands(dtype=torch.float64)
    z0 = iterates[0, 0].clone()
    _, saved = npv.newton_schulz(x, z0, 3, keep=True)
    assert torch.equal(saved, iterates)
    whole = npv.newton_schulz_backward(x, saved, g)
    xx, zz = x.clone().requires_grad_(), z0.clone().requires_grad_()
    z = zz
    for _ in range(3):
        xz = xx @ z
        u = xz @ (7 * torch.eye(8, dtype=x.dtype) - xz)
        w = xz @ (15 * torch.eye(8, dtype=x.dtype) - u)
        z = 0.25 * z @ (13 * torch.eye(8, dtype=x.dtype) - w)
    want = torch.autograd.grad(z, (xx, zz), g)
    for a, b in zip(whole, want):
        assert (a - b).abs().max() <= 1e-12 * b.abs().max()


def test_sweep_without_iterations_passes_the_cotangent():
    x, _, g = _sweep_operands()
    dx, dz0 = npv.newton_schulz_backward(x, x.new_empty((0, 4, *x.shape)), g)
    assert torch.equal(dx, torch.zeros_like(x)) and torch.equal(dz0, g) and dz0.data_ptr() != g.data_ptr()


def test_train_step_records_each_backward_op_once_a_layer(monkeypatch):
    """One TransMIL train step (two Nystrom layers) on the kernel path, its
    pseudo-inverse on K3p's products (``newton_schulz_pinv``, as on the
    card), profiled with shapes: each backward op twice, with the shapes
    that fix its work (``[B,H,m,dh]`` landmarks, ``[B,H,N,dh]`` tokens, no
    ``d_s3`` or ``d_cls``: the step never reads the attention map, and
    ``[iters, 4, B, H, m, m]`` iterates)."""
    monkeypatch.setattr(fn, "pseudo_inverse", npv.newton_schulz_pinv)
    cfg = load_config(["-c", os.path.join(REPO, "config/feat_cls.yaml")], model="transmil", batch_size=2, **CFG)
    model, family = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, 2, device="cpu")
    step = make_train_step(cfg, family, 2, "cpu")
    n = 48
    batch = {"feats": torch.randn(2, n, 16, generator=torch.Generator().manual_seed(1)),
             "mask": torch.arange(n)[None] < torch.tensor([[n], [30]]),
             "bag_valid": torch.ones(2, dtype=torch.bool), "target": torch.tensor([0, 1], dtype=torch.int32)}
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        step(state, batch)
    seen = {}
    for e in prof.events():
        seen.setdefault(e.name, []).append([list(s) for s in e.input_shapes])
    b, h, m, dh, tokens = 2, 2, 16, 16, n + 1  # the cls token first
    for name in ("pass_a_backward", "pass_b_backward", "newton_schulz_backward"):
        calls = seen.get(f"mhim_mil_torch::{name}", [])
        assert len(calls) == 2, (name, len(calls))
        for s in calls:
            if name == "pass_a_backward":
                assert (s[0], s[1], s[8]) == ([b, h, m, dh], [b, h, tokens, dh], [])
            elif name == "pass_b_backward":
                assert (s[0], s[3], s[10], s[11]) == ([b, h, tokens, dh], [b, h, m, dh], [], [b, h, tokens, dh])
            else:
                assert (s[0], s[1]) == ([b, h, m, m], [6, 4, b, h, m, m])  # TransLayer's 6 iterations


def _stages(prof):
    """The ``scorer.*`` ranges of each request in ``prof``, by request."""
    events = sorted((e for e in prof.events() if e.name.startswith("scorer.")
                     and e.device_type == torch.autograd.DeviceType.CPU), key=lambda e: e.time_range.start)
    requests = [e for e in events if e.name == "scorer.request"]
    return [(r, [e for e in events if e.name != "scorer.request" and r.time_range.start <= e.time_range.start
                 and e.time_range.end <= r.time_range.end]) for r in requests]


@pytest.fixture(scope="module")
def abmil(tmp_path_factory):
    cfg = load_config(["-c", os.path.join(REPO, "config/feat_cls.yaml")], model="abmil", **CFG)
    model, family = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("abmil") / "bundle")
    export_serving_bundle(cfg, model, family, path, buckets=(64,), platforms=("cpu",))
    return Scorer(cfg, model, buckets=(64,), device="cpu", family=family), ServingBundle(path, device="cpu")


@pytest.mark.parametrize("which", ["scorer", "bundle"])
def test_a_request_is_a_range_around_its_stages(abmil, which):
    """Two requests (one bag, a masked batch): each ``scorer.request``
    encloses ``scorer.h2d``, ``.pad``, ``.forward`` and ``.to_host``, each
    once, in that order and one after another."""
    scorer = abmil[0] if which == "scorer" else abmil[1]
    g = np.random.default_rng(0)
    bag, batch = g.normal(size=(40, 16)).astype(np.float32), g.normal(size=(2, 50, 16)).astype(np.float32)
    scorer.score(bag)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        one = scorer.score(bag)
        two = scorer.score(batch, np.arange(50)[None] < np.array([[50], [21]]))
    assert one["logits"].ndim == 1 and two["logits"].shape[0] == 2
    requests = _stages(prof)
    assert len(requests) == 2
    for _, stages in requests:
        assert tuple(e.name for e in stages) == STAGES
        for before, after in zip(stages, stages[1:]):
            assert before.time_range.end <= after.time_range.start


def test_profile_serving_reads_each_stage(abmil):
    """``utils/profile_serving``'s reading of a scorer's ranges on the CPU:
    each stage's host ms a request, under the request's; no device ms."""
    from mhim_mil_torch.utils.profile_serving import STAGES as PRINTED
    from mhim_mil_torch.utils.profile_train import profile_steps

    bag = np.random.default_rng(1).normal(size=(40, 16)).astype(np.float32)
    prof = profile_steps(lambda: abmil[0].score(bag), 2, PRINTED, torch.device("cpu"))
    host = prof["stage_host_ms"]
    assert PRINTED == ("scorer.request",) + STAGES and all(host[s] > 0 for s in PRINTED)
    assert sum(host[s] for s in STAGES) <= host["scorer.request"]
    assert set(prof["stage_device_ms"].values()) == {None}
