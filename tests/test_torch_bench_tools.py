"""The port's timing tools (``mhim_mil_torch/tools/bench.py``, ``stress_30k.py``,
``latency.py``) against the JAX package's ``bench.py`` and ``tools/*.py``:
the same draws and the same epoch plan, rehearsals on the CPU at tiny
shapes, FLOPs counted against the products of the layer shapes, and no run
without a card unless the CPU is asked for."""

from __future__ import annotations

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from mhim_mil_torch.tools import bench, latency, stress_30k, timing

TINY = ["--device", "cpu", "--input_dim", "16", "--inner_dim", "32", "--n_heads", "2", "--bag_size", "64"]


def _recorder(calls, to_np):
    def step(state, batch):
        mask = to_np(batch["mask"])
        feats = to_np(batch["feats"]).astype(np.float64)
        calls.append((mask.shape[1], tuple(mask.sum(axis=1).tolist()), int(to_np(batch["bag_valid"]).sum()),
                      float(feats.sum())))
        return state, {"loss": jnp.zeros(())}
    return step


def test_epoch_sim_matches_jax(monkeypatch):
    """The same slides (lengths and features), histogram and, call by call,
    the same batches (bucket, valid lengths, valid bags) in the same order
    as JAX's ``_epoch_sim`` on the same seeds, through each package's
    ``batch_bags``: 8 slides of width 4."""
    monkeypatch.setattr(jax_bench, "FEAT_DIM", 4)
    jax_calls, port_calls = [], []
    want = jax_bench._epoch_sim(None, None, _recorder(jax_calls, np.asarray), n_slides=8)
    port_step = _recorder(port_calls, lambda t: t.numpy())
    got = bench.epoch_sim(None, lambda s, b: port_step(s, b), torch.device("cpu"), batch_size=4, feat_dim=4,
                          n_slides=8)
    assert got["len_histogram"] == want["len_histogram"]
    assert sum(got["len_histogram"].values()) == 8
    assert port_calls == jax_calls
    assert len(port_calls) > 8
    assert sorted(map(int, got["first_step_s_per_bucket"])) == sorted(want["compile_s_per_bucket"])
    assert len(got["epoch_rates"]) == len(want["epoch_rates"]) == 3
    assert sorted(got["per_bucket_bags_per_sec"]) == sorted(want["per_bucket_bags_per_sec"])


def test_bench_draws_match_jax():
    """``bench.py``'s features and targets (``default_rng(0)``) and its
    ragged lengths (``default_rng(1)``, ``bench.py:261-262``)."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(4, 64, 16)).astype(np.float32)
    target = rng.integers(0, 2, size=(4,))
    got = bench.dense_batch(4, 64, 16, torch.device("cpu"))
    np.testing.assert_array_equal(got["feats"].numpy(), feats)
    np.testing.assert_array_equal(got["target"].numpy(), target)
    assert bool(got["mask"].all()) and bool(got["bag_valid"].all())
    want = np.random.default_rng(1).integers(jax_bench.BAG_SIZE // 2, jax_bench.BAG_SIZE + 1,
                                             size=(jax_bench.BATCH,))
    np.testing.assert_array_equal(bench.ragged_lengths(jax_bench.BATCH, jax_bench.BAG_SIZE), want)
    assert bench.BAG_SIZE == jax_bench.BAG_SIZE and bench.WARMUP_STEPS == jax_bench.WARMUP_STEPS
    assert (bench.WINDOW_STEPS, bench.N_WINDOWS, bench.STEADY_SPREAD, bench.LATENCY_REPS) == \
        (jax_bench.WINDOW_STEPS, jax_bench.N_WINDOWS, jax_bench.STEADY_SPREAD, jax_bench.LATENCY_REPS)


def test_stress_draws_match_jax():
    """``tools/stress_30k.py``'s batch: the features a bag at a time equal
    its single draw, and at its full shape (2 × 32,768 × 1024) the ragged
    lengths and targets that follow them."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 96, 8)).astype(np.float32)
    lens = rng.integers(96 // 2, 96 + 1, (2, 1))
    got = stress_30k.stress_inputs(2, 96, 8)
    np.testing.assert_array_equal(got["feats"], feats)
    np.testing.assert_array_equal(got["mask"], np.arange(96)[None] < lens)
    b, n, d = stress_30k.BATCH, stress_30k.BAG, 1024
    rng = np.random.default_rng(0)
    for _ in range(b * n // 1024):  # the features, 1,024 rows at a time
        rng.normal(size=(1024, d))
    lens = rng.integers(n // 2, n + 1, (b, 1))
    target = rng.integers(0, 2, size=(b,))
    got = stress_30k.stress_inputs(b, n, d)
    np.testing.assert_array_equal(got["mask"].sum(axis=1), lens[:, 0])
    np.testing.assert_array_equal(got["target"], target)
    assert got["feats"].shape == (b, n, d) and got["feats"].dtype == np.float32
    assert (lens >= 16384).all() and (lens <= 32768).all()


@pytest.fixture
def one_thread():
    """The rehearsals run hundreds of tiny steps: on one thread they take a
    few seconds, where a thread pool per test worker oversubscribes the
    cores and spins."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _last_json(out: str, k: int = 1):
    return [json.loads(line) for line in out.strip().splitlines()[-k:]]


def test_bench_rehearsal(one_thread, capsys, tmp_path):
    path = tmp_path / "detail.json"
    bench.main(TINY + ["--warmup", "2", "--steps", "2", "--reps", "3", "--detail", str(path)])
    detail, last = _last_json(capsys.readouterr().out, 2)
    assert set(last) == {"metric", "value", "unit", "ragged_bags_per_sec", "infer_p50_ms", "mfu", "device"}
    assert last["metric"] == "mhim_train_bags_per_sec_10k" and last["value"] == detail["dense_bags_per_sec"] > 0
    assert last["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "nvidia_smi": None}
    assert last["mfu"] is None and detail["roofline"]["achieved_tflops"] is None
    assert json.loads(path.read_text()) == detail
    assert len(detail["dense_windows"]) == len(detail["ragged_windows"]) in (bench.N_WINDOWS, 2 * bench.N_WINDOWS)
    assert detail["window_steps"] == 2 and detail["infer_reps"] == 3 and detail["batch"] == 4
    assert detail["kernel_gate"]["outcome"] == "skipped" and detail["launches_in_windows"] == {}
    assert all(32 <= n <= 64 for n in detail["ragged_lengths"])
    sim = detail["epoch_sim"]
    assert sum(sim["len_histogram"].values()) == bench.EPOCH_SLIDES and len(sim["epoch_rates"]) == bench.EPOCHS
    assert sorted(sim["per_bucket_bags_per_sec"]) == sorted(sim["first_step_s_per_bucket"])
    assert set(map(int, sim["per_bucket_bags_per_sec"])) <= set(sim["buckets"])
    assert detail["roofline"]["step_flops"] > 0 and detail["infer_p90_ms"] >= detail["infer_p50_ms"] > 0
    roof = detail["roofline"]
    assert set(roof["hbm_gb_s"]) == {"mul_inplace", "sum", "copy"} and roof["hbm_spec_gb_s"] == 3350.0
    assert roof["hbm_probe_bytes"] == 16 << 20 and roof["physical_bytes_ceiling_per_step"] > 0
    dec = detail["decomposition"]
    assert dec["protocol"] == {"warm": 2, "window": 2, "rounds": 3, "profile_steps": 3}
    assert set(dec["components_ms"]) == {"dispatch_floor", "teacher_fwd", "student_fwd", "backward", "optimizer",
                                         "ema_walk"}
    assert set(dec["variant_device_busy_ms"]) == {"full", "null", "no_teacher", "fwd_only", "no_opt_ema", "no_ema"}
    assert dec["bytes_model"]["_geometry"]["N"] == 64 and dec["hbm_gb_s"] == roof["hbm_gb_s"]


def test_stress_rehearsal(one_thread, capsys):
    stress_30k.main(TINY + ["--steps", "2"])
    (res,) = _last_json(capsys.readouterr().out)
    assert res["metric"] == "mhim_stress_32k" and res["device"]["platform"] == "cpu"
    assert (res["batch"], res["bag_size"], res["train_steps_timed"], res["infer_reps"]) == (2, 64, 2, 10)
    assert all(32 <= n <= 64 for n in res["lengths"]) and res["train_peak_memory"] is None
    assert res["train_step_ms"] > 0 and res["train_bags_per_sec"] > 0 and res["infer_ms_per_slide"] > 0
    assert res["train_launches_a_step"].keys() <= {"K3", "K3b"}  # flash_nystrom's calls; no kernel on the CPU


def test_latency_rehearsal(one_thread, capsys):
    latency.main(TINY + ["--models", "abmil,transmil,mhim", "--repeats", "3", "--warmup", "1"])
    (res,) = _last_json(capsys.readouterr().out)
    assert [r["model"] for r in res["rows"]] == ["abmil", "transmil", "mhim"]
    for r in res["rows"]:
        assert r["p90_ms"] >= r["p50_ms"] > 0 and r["repeats"] == 3 and r["gflops_fwd"] > 0
        assert r["compute_dtype"] == "float32" and r["launches_a_call"] == {}
    assert res["device"]["platform"] == "cpu" and res["bag_size"] == 64
    latency.main(TINY + ["--models", "transmil", "--repeats", "3", "--p50_protocol"])
    (res,) = _last_json(capsys.readouterr().out)
    assert {"p50_ms", "p90_ms", "chained_ms", "link_floor_ms", "host_healthy", "north_star_p50_ms"} <= set(res)
    assert res["model"] == "transmil" and res["device"]["kind"] == "cpu"


def test_flops_abmil_by_hand():
    n, d, c, k = 50, 16, 32, 2
    cfg, family, model, _, batch = latency.setup("abmil", n, torch.device("cpu"), ["--input_dim", str(d),
                                                                                    "--inner_dim", str(c)])
    want = 2 * n * d * c + 2 * n * c * 128 + 2 * n * 128 + 2 * n * c + 2 * c * k  # embed, pool, weighted sum, head
    assert latency.forward_flops(cfg, family, model, batch, torch.device("cpu")) == want


def test_flops_transmil_by_hand():
    n, d, c, heads, k, iters = 50, 16, 32, 2, 2, 6
    cfg, family, model, _, batch = latency.setup("transmil", n, torch.device("cpu"), [
        "--input_dim", str(d), "--inner_dim", str(c), "--n_heads", str(heads)])
    t, dh, m = n + 1, c // heads, c // 2
    layer = (2 * t * c * 3 * c  # to_qkv
             + 2 * heads * (t * m * dh + m * m * dh + m * t * dh)  # sim1, sim2, sim3
             + iters * 4 * 2 * heads * m ** 3  # Newton-Schulz
             + 2 * heads * (m * t * dh + m * m * dh + t * m * dh)  # attn3 @ v, pinv @ ., attn1 @ .
             + 2 * heads * t * dh * 33  # the (33, 1) value-residual convolution
             + 2 * t * c * c)  # to_out
    hw = math.ceil(math.sqrt(n))
    want = 2 * n * d * c + 2 * layer + 2 * c * hw * hw * 49 + 2 * c * k  # embed, layers, PPEG, head
    assert latency.forward_flops(cfg, family, model, batch, torch.device("cpu")) == want


def test_plain_twin_materialises_with_the_same_weights():
    cfg, _, model, _, _ = latency.setup("transmil", 8, torch.device("cpu"), ["--input_dim", "8", "--inner_dim", "16"])
    cfg_p, twin = timing.plain_twin(cfg, model, torch.device("cpu"))
    assert cfg_p.use_flash_attn is False
    for (name, p), (_, q) in zip(model.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(p, q), name
    assert twin.layer1.attn.path(10 ** 6, on_cuda=True) == "materialising"


@pytest.mark.parametrize("tool", [bench, stress_30k, latency])
def test_no_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--input_dim", "16"])
