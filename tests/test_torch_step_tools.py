"""The port's in-step breakdown, roofline, split writer and feature-store
converter (``mhim_mil_torch/tools/step_breakdown.py``, ``roofline.py``,
``make_splits.py``, ``convert_features.py``) against the JAX package's
``tools/*.py``: the bytes model on the same geometry and parameter count,
the same split files and stores byte for byte, and rehearsals of the
timing tools on the CPU at tiny shapes."""

from __future__ import annotations

import json
import math
import os
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_torch.tools import bench, convert_features, make_splits, roofline, step_breakdown, timing
from test_torch_train import _port_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--input_dim", "16", "--inner_dim", "32", "--n_heads", "2", "--bag_size", "64"]
COMPONENTS = ("dispatch_floor", "teacher_fwd", "student_fwd", "backward", "optimizer", "ema_walk")
VARIANTS = ("full", "null", "no_teacher", "fwd_only", "no_opt_ema", "no_ema")


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture
def one_thread():
    """The rehearsals run many tiny steps: one thread, as in test_torch_bench_tools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---- the bytes model ----------------------------------------------------------------


@pytest.mark.parametrize("geometry", [(4, 10240, 1024), (2, 32768, 1024), (3, 96, 16)])
def test_bytes_model_matches_jax(geometry):
    """Each component's floor in bytes, exactly (JAX's floor in ms at a rate
    of 1e-6 GB/s is its bytes), and the geometry and parameter bytes, on
    the port's small MHIM and the same weights in JAX's tree."""
    from types import SimpleNamespace

    jsb = _jax_tool("step_breakdown")
    cfg = bench.flagship_config(["--input_dim", "16", "--inner_dim", "32", "--n_heads", "2"])
    jcfg = j_load_config([], **{**bench.FLAGSHIP, "input_dim": 16, "inner_dim": 32, "n_heads": 2})
    model, _ = bench.make_state(cfg, torch.device("cpu"))
    params, _ = _port_flax(model, "selfattn")
    n_params = sum(p.numel() for p in model.parameters())
    measured = {"teacher_fwd": 3.0, "backward": 7.5}
    want = jsb.bytes_model(jcfg, SimpleNamespace(params=params), {"feats": np.zeros(geometry, np.float32)},
                           measured, 1e-6)
    got = step_breakdown.bytes_model(cfg, n_params, geometry, measured, 2e12)
    assert got["_params_bytes"] == want["_params_bytes"] == 4 * n_params
    assert got["_geometry"] == want["_geometry"]
    floors = [k for k in want if not k.startswith("_")]
    assert floors == [k for k in got if not k.startswith("_")]
    for k in floors:
        assert got[k]["floor_bytes"] == int(want[k]["floor_ms_at_measured_hbm"]), k
        assert round(got[k]["floor_mb"], 1) == want[k]["floor_mb"], k
        assert got[k]["floor_ms_at_measured_hbm"] == pytest.approx(got[k]["floor_bytes"] / 2e12 * 1e3)
        assert got[k]["floor_ms_at_spec"] == pytest.approx(got[k]["floor_bytes"] / 3.35e12 * 1e3)
        assert got[k]["measured_ms"] == measured.get(k)
    assert got["_total"]["floor_bytes"] == sum(got[k]["floor_bytes"] for k in floors)
    assert got["backward"]["measured_over_floor"] == pytest.approx(7.5 / got["backward"]["floor_ms_at_measured_hbm"])


# ---- the breakdown -----------------------------------------------------------------


def test_breakdown_on_the_cpu_leaves_full_as_a_lone_run(one_thread):
    """Every component and variant key; the ``full`` state ends as the same
    number of lone full steps leaves a state from the same weights and
    seed, bit for bit (no variant shares its model, teacher, optimizer or
    generator); the other variants' states are fresh ones of their own."""
    cpu = torch.device("cpu")
    cfg = bench.flagship_config(["--input_dim", "16", "--inner_dim", "32", "--n_heads", "2"])
    batch = bench.dense_batch(cfg.batch_size, 48, cfg.input_dim, cpu)
    made = []

    def factory():
        made.append(bench.make_state(cfg, cpu)[1])
        return made[-1]

    kw = dict(warm=1, window=1, rounds=2, profile_steps=1)
    res = step_breakdown.breakdown(cfg, factory, batch, cpu, **kw)
    assert set(res["components_ms"]) == set(COMPONENTS)
    assert set(res["variant_ms"]) == set(res["variant_windows_ms"]) == set(VARIANTS)
    assert set(res["variant_device_busy_ms"]) == set(res["variant_profiled_host_ms"]) == set(VARIANTS)
    assert set(res["range_host_ms"]) == set(VARIANTS) - {"null"}
    assert all(v is None for v in res["variant_device_busy_ms"].values())  # no device on the CPU
    assert res["device_components_ms"] is None
    assert step_breakdown.components(res["variant_ms"]) == res["components_ms"]
    assert all(len(w) == 2 for w in res["variant_windows_ms"].values())
    assert res["sum_check_ms"] == pytest.approx(sum(res["components_ms"].values()))
    assert res["components_ms"]["dispatch_floor"] == res["variant_ms"]["null"] > 0
    assert res["range_host_ms"]["no_teacher"]["mhim.teacher"] == 0.0
    assert res["range_host_ms"]["fwd_only"]["mhim.backward"] == res["range_host_ms"]["no_opt_ema"]["mhim.update"] == 0
    assert len(made) == 5 and len({id(s.model) for s in made}) == 5

    lone = bench.make_state(cfg, cpu)[1]
    step = bench.make_state_and_step(cfg, cpu)[2]
    n = step_breakdown.steps_taken(**kw)
    for _ in range(n):
        step(lone, batch)
    assert made[0].step == lone.step == n
    for (name, p), q in zip(made[0].model.state_dict().items(), lone.model.state_dict().values()):
        assert torch.equal(p, q), name
    for p, q in zip(made[0].teacher.parameters(), lone.teacher.parameters()):
        assert torch.equal(p, q)
    fwd_only = made[VARIANTS.index("fwd_only") - 1]
    assert fwd_only.optimizer.count == 0 and fwd_only.step == n


def test_step_breakdown_rehearsal(one_thread, capsys, tmp_path):
    out = tmp_path / "b.json"
    step_breakdown.main(TINY + ["--warm", "1", "--window", "1", "--rounds", "1", "--json", str(out)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == res
    assert set(res["components_ms"]) == set(COMPONENTS) and res["device"]["platform"] == "cpu"
    bm = res["bytes_model"]
    assert bm["_geometry"]["N"] == 64 and bm["_hbm_bytes_s"] == pytest.approx(res["hbm_gb_s"]["mul_inplace"] * 1e9)
    assert all(bm[k]["measured_ms"] == res["components_ms"][k] for k in COMPONENTS if k in bm)
    assert res["kernel_gate"]["outcome"] == "skipped"


# ---- the roofline ------------------------------------------------------------------


def test_components_are_jax_formulas():
    ms = {"full": 40.0, "null": 0.5, "no_teacher": 31.0, "fwd_only": 20.0, "no_opt_ema": 36.0, "no_ema": 39.0}
    got = step_breakdown.components(ms)
    assert got == {"dispatch_floor": 0.5, "teacher_fwd": 9.0, "student_fwd": 10.5, "backward": 16.0,
                   "optimizer": 3.0, "ema_walk": 1.0}
    assert sum(got.values()) == ms["full"]  # the differences telescope


def test_hbm_probes_on_the_cpu():
    hbm = roofline.measure_hbm_ceiling(torch.device("cpu"), 1 << 20, sweeps=2, blocks=2)
    assert set(hbm["gb_s"]) == {"mul_inplace", "sum", "copy"}
    assert all(math.isfinite(v) and v > 0 for v in hbm["gb_s"].values())
    assert hbm["ceiling_gb_s"] == hbm["gb_s"]["mul_inplace"] and hbm["spec_gb_s"] == 3350.0
    assert hbm["nbytes"] == 1 << 20 and all(len(t) == 2 for t in hbm["block_ms"].values())
    assert roofline.default_hbm_bytes(torch.device("cpu")) < roofline.HBM_BYTES == 1 << 30
    assert timing.PEAK_HBM_BYTES_S == 3.35e12


def test_roofline_rehearsal(one_thread, capsys):
    roofline.main(TINY + ["--warmup", "1", "--steps", "2"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["step_ms"] > 0 and res["bags_per_sec"] > 0 and res["step_flops"] > 0
    assert res["achieved_tflops"] is None and res["mfu"] is None  # a card only
    assert res["bytes_floor_per_step"] > 0 and 0 < res["bandwidth_utilization"]
    assert res["physical_bytes_ceiling_per_step"] == pytest.approx(res["step_ms"] / 1e3 * res["hbm_ceiling_gb_s"] * 1e9)
    assert res["hbm_probe_bytes"] == 16 << 20 and res["hbm_spec_gb_s"] == 3350.0


@pytest.mark.parametrize("tool", [roofline, step_breakdown])
def test_no_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--input_dim", "16"])


# ---- the split writer and the converter --------------------------------------------------


@pytest.mark.parametrize("kw", [dict(cv_fold=3), dict(cv_fold=4, val_ratio=0.2), dict(cv_fold=3, val_ratio=0.2,
                                                                                         val2test=True)])
def test_make_splits_matches_jax(tmp_path, kw):
    """The same ``fold_{k}.csv`` files, byte for byte, as ``tools/make_splits.py``."""
    rng = np.random.default_rng(0)
    ids = [f"sp{i}" for i in range(23)]
    csv = tmp_path / "labels.csv"
    pd.DataFrame({"ID": ids, "Label": rng.integers(0, 2, size=len(ids))}).to_csv(csv, index=False)
    want = _jax_tool("make_splits").make_split_csvs(str(csv), str(tmp_path / "jax"), seed=7, **kw)
    got = make_splits.main(["--csv_path", str(csv), "--out", str(tmp_path / "port"), "--seed", "7"]
                           + [f"--{k}" if v is True else f"--{k}={v}" for k, v in kw.items()])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == kw["cv_fold"]
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read(), g
    if kw.get("val_ratio") and not kw.get("val2test"):
        assert "val" in set(pd.read_csv(got[0])["Split"])


def _store(src, fmt):
    rng = np.random.default_rng(1)
    src.mkdir()
    for i in range(3):
        feats = rng.normal(size=(10 + i, 8)).astype(np.float32)
        if fmt == "npy":
            np.save(src / f"s{i}.npy", feats)
        elif fmt == "pt":
            torch.save(torch.tensor(feats), src / f"s{i}.pt")
        else:
            with h5py.File(src / f"s{i}.h5", "w") as f:
                f.create_dataset("features", data=feats)
                c = f.create_dataset("coords", data=rng.integers(0, 4096, size=(10 + i, 2)))
                c.attrs["patch_size"] = 256
                c.attrs["patch_level"] = 0


@pytest.mark.parametrize("fmt,with_coords", [("h5", True), ("h5", False), ("npy", False), ("pt", False)])
def test_convert_features_matches_jax(tmp_path, monkeypatch, fmt, with_coords):
    """The same ``pt_files`` and ``h5_files``, byte for byte, as the JAX CLI
    ``tools/convert_features.py`` on the same store."""
    src = tmp_path / "src"
    _store(src, fmt)
    flags = ["--src", str(src), "--src_format", fmt] + (["--with_coords"] if with_coords else [])
    jcf = _jax_tool("convert_features")
    monkeypatch.setattr(sys, "argv", ["convert_features.py", "--dst", str(tmp_path / "jax")] + flags)
    jcf.main()
    assert convert_features.main(["--dst", str(tmp_path / "port")] + flags) == ["s0", "s1", "s2"]
    for sub in ("pt_files", "h5_files"):
        want = sorted(os.listdir(tmp_path / "jax" / sub)) if (tmp_path / "jax" / sub).exists() else None
        got = sorted(os.listdir(tmp_path / "port" / sub)) if (tmp_path / "port" / sub).exists() else None
        assert got == want, sub
        for name in got or []:
            assert (tmp_path / "port" / sub / name).read_bytes() == (tmp_path / "jax" / sub / name).read_bytes()
    assert (tmp_path / "port" / "h5_files").exists() == with_coords
    t = torch.load(tmp_path / "port" / "pt_files" / "s2.pt", weights_only=True)
    assert t.shape == (12, 8) and t.dtype == torch.float32
