"""The Nystrom attention's backward work counts against hand counts and
against FlopCounterMode on the same arithmetic (on meta tensors, so at the
real shapes), the readers of the metrics that read the program's backward
ops and its ``scorer.forward`` range on synthetic traces, a traced tiny
CPU run of each kind, and the three metrics' entries in ``BENCHMARK.json``."""

import json
from collections import Counter
from pathlib import Path

import pytest
import torch

from benchmark import backward_work as bw
from benchmark import cell, trace
from benchmark import workcounts as wc

REPO = Path(__file__).resolve().parents[2]
STUDENT = (4, 8, 256, 1027, 64)  # B, H, m, N, dh: the flagship's student
WHOLE_BAG = (4, 8, 256, 10241, 64)  # a 10,240-instance bag and its cls token


def _flops(fn):
    with wc.flop_counter() as counter:
        fn()
    return counter.get_total_flops()


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _hand_k1b(b, h, m, n, dh, s3_cot):
    """Five m × N × dh products; ql, k, v, mask, attn3v, m3, s3, d_attn3v
    (and d_s3) read, d_ql, d_k, d_v written."""
    flops = 5 * 2 * b * h * m * n * dh
    read = 2 * (b * h * m * dh + 2 * b * h * n * dh) + b * n + 4 * (2 * b * h * m * dh + 2 * b * h * m)
    read += 4 * b * h * m if s3_cot else 0
    return flops, read + 2 * (b * h * m * dh + 2 * b * h * n * dh)


def _hand_k2b(b, h, m, n, dh, cls):
    """Five N × m × dh products, eight with the cls term; q, kl, mid, the
    masks, d_out and out read, d_q, d_kl, d_mid written; with the cls term
    also k, ql, r', m3 and d_cls read, d_k, d_ql and d_r' written."""
    flops = (8 if cls else 5) * 2 * b * h * n * m * dh
    read = 2 * (b * h * n * dh + 2 * b * h * m * dh) + b * n + b * m + 2 * 2 * b * h * n * dh
    written = 2 * (b * h * n * dh + 2 * b * h * m * dh)
    if cls:
        read += 2 * (b * h * n * dh + b * h * m * dh) + 4 * (2 * b * h * m + b * h * n)
        written += 2 * (b * h * n * dh + b * h * m * dh) + 4 * b * h * m
    return flops, read + written


@pytest.mark.parametrize("shape", [STUDENT, WHOLE_BAG])
@pytest.mark.parametrize("extra", [False, True])
def test_k1b_and_k2b_counts(shape, extra):
    """Against the hand counts, and the products against FlopCounterMode on
    the kernels' arithmetic (K1b: S, dP, d_ql, d_k, d_v; K2b: S1, dP1, d_q,
    d_kl, d_mid, and with the cls term E, d_k, d_ql)."""
    b, h, m, n, dh = shape
    assert bw.pass_a_backward((b, h, m, dh), (b, h, n, dh), extra) == _hand_k1b(b, h, m, n, dh, extra)
    assert bw.pass_b_backward((b, h, n, dh), (b, h, m, dh), extra) == _hand_k2b(b, h, m, n, dh, extra)
    ql, k, v, d_a = _meta(b, h, m, dh), _meta(b, h, n, dh), _meta(b, h, n, dh), _meta(b, h, m, dh)
    q, kl, mid, d_out, d_cls = _meta(b, h, n, dh), _meta(b, h, m, dh), _meta(b, h, m, dh), _meta(b, h, n, dh), \
        _meta(b, h, 1, n)

    def k1b():
        p = torch.exp(ql @ k.transpose(-1, -2))
        ds = p * (d_a @ v.transpose(-1, -2))
        ds @ k, ds.transpose(-1, -2) @ ql, p.transpose(-1, -2) @ d_a

    def k2b():
        p1 = torch.softmax(q @ kl.transpose(-1, -2), -1)
        ds1 = p1 * (d_out @ mid.transpose(-1, -2))
        ds1 @ kl, ds1.transpose(-1, -2) @ q, p1.transpose(-1, -2) @ d_out
        if extra:
            g = torch.exp(ql @ k.transpose(-1, -2)) * d_cls
            g.transpose(-1, -2) @ ql, g @ k

    assert bw.pass_a_backward(ql.shape, k.shape, extra)[0] == _flops(k1b)
    assert bw.pass_b_backward(q.shape, kl.shape, extra)[0] == _flops(k2b)


@pytest.mark.parametrize("g,m,iters", [((4, 8), 256, 6), ((4, 8), 128, 6), ((3,), 16, 2)])
def test_reverse_sweep_count(g, m, iters):
    """Eight m × m products an iteration (the sweep's), 16·iters·G·m³, and
    x, the iterates, g, dx and dz0 in fp32."""
    x = (*g, m, m)
    gg = 1
    for d in g:
        gg *= d
    assert bw.newton_schulz_backward(x, iters) == (16 * iters * gg * m ** 3, 4 * (4 * iters + 4) * gg * m * m)
    t = _meta(*x)

    def sweep():
        for _ in range(iters * 8):
            t @ t

    assert bw.newton_schulz_backward(x, iters)[0] == _flops(sweep)


def _run(mode, ops):
    run = cell.Run("w", mode, {}, {})
    run.trace = trace.Trace(window_s=1.0, busy_s=0.5, ops=ops, device_ops=[], idle_gaps=[], memcpy_htod_s=0.0)
    return run


def _op(name, shapes, device_s):
    return trace.Op(name, shapes, [None] * len(shapes), device_s)


K1B = [[4, 8, 256, 64], [4, 8, 1027, 64], [4, 8, 1027, 64], [4, 1027], [4, 8, 256, 64], [4, 8, 256],
       [4, 8, 256], [4, 8, 256, 64], []]
K2B = [[4, 8, 1027, 64], [4, 8, 1027, 64], [4, 1027], [4, 8, 256, 64], [4, 256], [4, 8, 256, 64],
       [4, 8, 256, 64], [4, 8, 256], [4, 8, 256], [4, 8, 1027, 64], [4, 8, 1027], [4, 8, 1027, 64]]
SWEEP = [[4, 8, 256, 256], [6, 4, 4, 8, 256, 256], [4, 8, 256, 256]]


def test_roofline_reader():
    """Σ bound / Σ device time over the three ops' calls, in %: K1b without
    d_s3, K2b with d_cls, the sweep of 6 iterations; a call with no device
    time left out; None with no device time, without the ops (a program
    that launches the kernels outside any op) and without a trace."""
    ops = {bw.OPS[0]: [_op(bw.OPS[0], K1B, 2e-4), _op(bw.OPS[0], K1B, 0.0)],
           bw.OPS[1]: [_op(bw.OPS[1], K2B, 3e-4)],
           bw.OPS[2]: [_op(bw.OPS[2], SWEEP, 1e-3)]}
    works = (bw.pass_a_backward(K1B[0], K1B[1], False), bw.pass_b_backward(K2B[0], K2B[3], True),
             bw.newton_schulz_backward(SWEEP[0], 6))
    bound = sum(wc.bound_s(w) for w in works)
    got = cell.load_reader("nystrom_bwd_roofline.train")(_run("train", ops))
    assert got == pytest.approx(100 * bound / 1.5e-3) and 0 < got < 100
    assert cell.load_reader("nystrom_bwd_roofline.mhim_train")(_run("train", ops)) == got
    zero = {n: [_op(n, o.shapes, 0.0) for o in v] for n, v in ops.items()}
    forward_only = {"mhim_mil_torch::pass_a": [_op("mhim_mil_torch::pass_a", K1B[:4], 1e-3)]}
    for run in (_run("train", zero), _run("train", forward_only), cell.Run("w", "train", {}, {})):
        assert bw.roofline(run) is None


def test_forward_roofline_reads_no_backward_op():
    """``nystrom_fwd_roofline.*`` keeps to the forward ops: the backward ops
    beside them change nothing."""
    from benchmark import readers

    fwd = {"mhim_mil_torch::pass_a": [_op("mhim_mil_torch::pass_a", K1B[:4], 1e-3)]}
    both = dict(fwd, **{bw.OPS[0]: [_op(bw.OPS[0], K1B, 2e-4)], bw.OPS[2]: [_op(bw.OPS[2], SWEEP, 1e-3)]})
    assert readers.nystrom_roofline(_run("train", both)) == readers.nystrom_roofline(_run("train", fwd))


def test_serve_forward_reader_divides_by_requests():
    """Device ms a request of ``scorer.forward``, over the requests traced
    (a serve run's ``steps`` stays 0); None without device time, without
    the range (a program without it), outside a serve run."""
    read = cell.load_reader("serve_forward_ms")
    run = _run("serve", {"scorer.forward": [_op("scorer.forward", [], 2e-3) for _ in range(5)] +
                         [_op("scorer.forward", [], 0.0)]})
    run.traced_buckets = Counter({4096: 4, 16384: 2})
    assert run.steps == 0 and read(run) == pytest.approx(1e3 * 1e-2 / 6)
    none = [_run("serve", {"scorer.forward": [_op("scorer.forward", [], 0.0)]}), _run("serve", {}),
            _run("train", run.trace.ops), cell.Run("w", "serve", {}, {})]
    for r in none:
        r.traced_buckets = Counter({4096: 4})
        assert read(r) is None


@pytest.mark.parametrize("name,spans", [
    ("tiny_transmil_c16.tiny_train", ("mhim_mil_torch::pass_a_backward", "mhim_mil_torch::pass_b_backward")),
    ("tiny_mhim_transmil_c16.tiny_serve", ("scorer.request", "scorer.h2d", "scorer.pad", "scorer.forward",
                                           "scorer.to_host"))])
def test_traced_tiny_run_is_correct_and_records_the_spans(checkout, monkeypatch, name, spans):
    """A traced CPU run comes out correct and its trace holds the program's
    backward ops (with shapes the work counts read) or the scorer's ranges;
    on the CPU no device time, so the new metrics are left out."""
    seen = []
    read = trace.read

    def keep(prof, top=10):
        seen.append(read(prof, top))
        return seen[-1]

    monkeypatch.setattr(trace, "read", keep)
    result = cell.run_cell(name, 2 ** 33 + 11, 0.2, True, torch.device("cpu"), checkout)
    assert result["correct"], result["checks"]
    assert not {"nystrom_bwd_roofline.train", "serve_forward_ms"} & set(result["metrics"])
    ops = seen[-1].ops
    for span in spans:
        assert ops.get(span), span
        if span in bw.OPS:
            assert all(bw.work(span, op.shapes) is not None for op in ops[span])


def test_backward_and_scorer_metrics_are_declared():
    """``BENCHMARK.json`` declares the three metrics, each for the cells in
    which its reader finds something to read."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    want = {"nystrom_bwd_roofline.train": ["transmil_c16.train_mix"],
            "nystrom_bwd_roofline.mhim_train": ["mhim_transmil_c16.train_mix"],
            "serve_forward_ms": ["mhim_transmil_c16.serve_cohort"]}
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in want}
    assert set(got) == set(want)
    for name, metric in got.items():
        assert metric["workloads"] == want[name] and set(metric["workloads"]) <= set(cells)
        assert (REPO / "benchmark" / "metrics" / f"{name}.py").is_file()
