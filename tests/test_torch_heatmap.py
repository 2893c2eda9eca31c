"""The port's heatmap module and attention-export tool against the JAX package's on the CPU.

Each function of ``mhim_mil_torch/utils/heatmap.py`` against its original in
``mhim_mil_tpu/utils/heatmap.py`` on the same inputs (the grids, the
percentiles, the overlays pixel for pixel, the sampled ROIs, the pyramidal
renderer on a slide that ``mhim_mil_tpu.preprocess.tiff.open_slide`` opens):
equal, floats within 1e-12. Then ``python -m mhim_mil_torch.tools.export_attention``
against ``tools/export_attention.py`` on a small CLAM-layout store, from the
same JAX checkpoint (abmil, and MHIM-selfattn with its Merge buffer) and
from the port's checkpoint of those weights: the same files, grids within
1e-6 and raw scores within 1e-5 (fp32 attention of different frameworks);
then both tools with ``--image_dir`` on a pyramidal TIFF and a PNG: the same
overlays and ROI CSVs.
"""

import importlib.util
import os
import sys
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.utils import heatmap as jheat
from mhim_mil_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from mhim_mil_torch.config import load_config
from mhim_mil_torch.data.readers import FeatureBagStore
from mhim_mil_torch.models import build_model
from mhim_mil_torch.tools import export_attention
from mhim_mil_torch.utils import heatmap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM, DIM = 16, 32


def _scores_coords(seed, n=40, grid=8, ties=False):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=n)
    if ties:
        scores = np.round(scores, 1)
    idx = rng.permutation(grid * grid)[:n]
    return scores, np.stack([idx % grid, idx // grid], -1)


@pytest.mark.parametrize("normalize", ["percentile", "minmax", "none"])
@pytest.mark.parametrize("with_coords", [True, False], ids=["coords", "raster"])
def test_attention_to_grid_matches_jax(normalize, with_coords):
    scores, coords = _scores_coords(0)
    c = coords if with_coords else None
    np.testing.assert_array_equal(heatmap.attention_to_grid(scores, c, normalize),
                                  jheat.attention_to_grid(scores, c, normalize))


@pytest.mark.parametrize("with_coords", [True, False], ids=["coords", "raster"])
def test_export_heatmap_writes_jax_files(tmp_path, with_coords):
    scores, coords = _scores_coords(1)
    c = coords if with_coords else None
    got = heatmap.export_heatmap(str(tmp_path / "port"), "s", scores, c)
    want = jheat.export_heatmap(str(tmp_path / "jax"), "s", scores, c)
    np.testing.assert_array_equal(np.load(got["npy"]), np.load(want["npy"]))
    assert open(got["csv"]).read() == open(want["csv"]).read()


def test_to_percentiles_matches_jax_with_ties():
    scores, _ = _scores_coords(2, n=200, ties=True)
    np.testing.assert_allclose(heatmap.to_percentiles(scores), jheat.to_percentiles(scores), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw", [{}, dict(binarize=True, thresh=0.6), dict(blank_canvas=True, alpha=0.7,
                                                                          cmap="viridis")],
                         ids=["blend", "binarize", "canvas"])
def test_render_heatmap_overlay_matches_jax(kw):
    rng = np.random.default_rng(3)
    image = rng.integers(0, 255, (96, 128, 3)).astype(np.uint8)
    scores, coords = _scores_coords(3, n=30, grid=6)
    px = coords * 20  # overlapping 32-pixel patches
    np.testing.assert_array_equal(heatmap.render_heatmap_overlay(image, px, scores, patch_size=32, **kw),
                                  jheat.render_heatmap_overlay(image, px, scores, patch_size=32, **kw))


@pytest.mark.parametrize("kw", [dict(mode="topk"), dict(mode="reverse_topk", k=3), dict(mode="range_sample", k=4),
                                dict(mode="range_sample", score_start=0.99, score_end=1.0),
                                dict(mode="topk", top_left=(2, 2), bot_right=(6, 6))],
                         ids=["topk", "reverse", "range", "empty-range", "box"])
def test_sample_rois_matches_jax(kw):
    scores, coords = _scores_coords(4)
    got, want = heatmap.sample_rois(scores, coords, **kw), jheat.sample_rois(scores, coords, **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(NotImplementedError):
        heatmap.sample_rois(scores, coords, mode="sideways")


def test_render_heatmap_pyramidal_matches_jax(tmp_path):
    """At level 1 of a pyramidal TIFF opened by the JAX package's reader,
    in bands smaller than the level, with a tissue mask."""
    from mhim_mil_tpu.preprocess.tiff import open_slide, write_pyramidal_tiff

    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (300, 400, 3)).astype(np.uint8)
    path = str(tmp_path / "s.tiff")
    write_pyramidal_tiff(path, img, levels=2, tile=64, compression="raw")
    xs, ys = np.meshgrid(np.arange(0, 400, 48), np.arange(0, 300, 48))
    coords = np.stack([xs.ravel(), ys.ravel()], -1)
    scores = rng.normal(size=len(coords))
    tissue = np.zeros((30, 40), bool)
    tissue[:, :25] = True
    slide = open_slide(path)
    try:
        for kw in ({}, dict(tissue_mask=tissue, binarize=True)):
            got = heatmap.render_heatmap_pyramidal(slide, coords, scores, patch_size=64, vis_level=1,
                                                   band_rows=50, **kw)
            want = jheat.render_heatmap_pyramidal(slide, coords, scores, patch_size=64, vis_level=1,
                                                  band_rows=50, **kw)
            assert got.shape == (150, 200, 3)
            np.testing.assert_array_equal(got, want)
    finally:
        slide.close()


# ---- the export tool ---------------------------------------------------------------


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Six slides of 20-25 instances with h5 coordinates, and their labels."""
    import h5py

    root = tmp_path_factory.mktemp("store")
    (root / "pt_files").mkdir()
    (root / "h5_files").mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        n = 20 + i
        torch.save(torch.tensor(rng.normal(size=(n, IN_DIM)).astype(np.float32)), root / "pt_files" / f"s{i}.pt")
        with h5py.File(root / "h5_files" / f"s{i}.h5", "w") as f:
            cells = rng.permutation(36)[:n]
            d = f.create_dataset("coords", data=np.stack([cells % 6, cells // 6], -1).astype(np.int64) * 256)
            d.attrs["patch_size"] = 256
            d.attrs["downsample"] = [1, 1]
    csv = root / "labels.csv"
    pd.DataFrame({"ID": [f"s{i}" for i in range(6)], "Label": [i % 2 for i in range(6)]}).to_csv(csv, index=False)
    return str(root), str(csv)


def _jax_checkpoint(path, model):
    """A JAX fold checkpoint of random weights (MHIM's made by the training
    pass, so that they hold the Merge module and its ``global_q``)."""
    jm, _ = j_build_model(j_load_config([], model=model, input_dim=IN_DIM, inner_dim=DIM))
    feats, mask = jnp.ones((2, 24, IN_DIM)), jnp.ones((2, 24), bool)
    rngs = {"params": jax.random.PRNGKey(7), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    if model == "mhim":
        variables = jax.jit(partial(jm.init, training=True))(rngs, feats, mask, jnp.zeros(mask.shape))
    else:
        variables = jm.init(rngs, feats, mask)
    state = SimpleNamespace(params=variables["params"], teacher_params=None, opt_state={}, step=0,
                            model_state={k: v for k, v in variables.items() if k != "params"},
                            rng=jax.random.PRNGKey(0))
    j_save_checkpoint(path, state)


def _run_jax_tool(monkeypatch, argv):
    spec = importlib.util.spec_from_file_location("jax_export_attention", os.path.join(REPO, "tools",
                                                                                       "export_attention.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["export_attention.py", *argv])
    tool.main()


def _read(out, sid):
    return np.load(os.path.join(out, f"{sid}_attn.npy")), pd.read_csv(os.path.join(out, f"{sid}_attn.csv"))


def _assert_same_export(got_dir, want_dir):
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) and len(os.listdir(want_dir)) == 12
    for i in range(6):
        (g_grid, g_csv), (w_grid, w_csv) = _read(got_dir, f"s{i}"), _read(want_dir, f"s{i}")
        np.testing.assert_array_equal(np.isnan(g_grid), np.isnan(w_grid))
        np.testing.assert_allclose(g_grid, w_grid, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(g_csv[["x", "y"]].to_numpy(), w_csv[["x", "y"]].to_numpy())
        np.testing.assert_allclose(g_csv["score"].to_numpy(), w_csv["score"].to_numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", ["abmil", "mhim"])
def test_export_cli_writes_the_jax_tools_grids(tmp_path, monkeypatch, store, model):
    """From one JAX checkpoint the port's tool and ``tools/export_attention.py``
    write the same grids; the port's own checkpoint of those weights gives
    them again."""
    root, csv = store
    ckpt = str(tmp_path / "fold_0_model_best.ckpt")
    _jax_checkpoint(ckpt, model)
    args = ["--model", model, "--csv_path", csv, "--dataset_root", root, "--input_dim", str(IN_DIM),
            "--inner_dim", str(DIM)]
    _run_jax_tool(monkeypatch, ["--ckpt", ckpt, "--out", str(tmp_path / "jax"), *args])
    scores = export_attention.main(["--ckpt", ckpt, "--out", str(tmp_path / "port"), "--device", "cpu", *args])
    _assert_same_export(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert sorted(scores) == [f"s{i}" for i in range(6)]
    if model == "abmil":  # softmaxed over each bag (MHIM's cls row leaves out its own column)
        assert all(abs(float(s.sum()) - 1.0) < 1e-5 for s in scores.values())

    cfg = load_config(args)
    port, _ = build_model(cfg, device="cpu")
    export_attention.load_weights(cfg, port, ckpt)
    torch.save({"model": port.state_dict()}, tmp_path / "port.ckpt")
    export_attention.main(["--ckpt", str(tmp_path / "port.ckpt"), "--out", str(tmp_path / "port2"), "--device",
                           "cpu", *args])
    _assert_same_export(str(tmp_path / "port2"), str(tmp_path / "jax"))


def test_export_cli_without_a_csv_or_weights(tmp_path, store):
    """Random weights from the seed, every ``.pt`` of the store: mambamil's
    raw attention over each bag sums to 1 and is the CSV's score column, and
    the grid is its percentile raster at the CSV's positions."""
    root, _ = store
    out = str(tmp_path / "attn")
    scores = export_attention.main(["--out", out, "--device", "cpu", "--dataset_root", root,
                                    "--model", "mambamil", "--input_dim", str(IN_DIM), "--mambamil_dim", str(DIM),
                                    "--mambamil_type", "BiMamba"])
    assert len(os.listdir(out)) == 12
    for sid, s in scores.items():
        grid, csv = _read(out, sid)
        np.testing.assert_array_equal(grid, heatmap.attention_to_grid(s, csv[["x", "y"]].to_numpy()))
        np.testing.assert_allclose(csv["score"].to_numpy(), s, rtol=1e-6, atol=0)
        np.testing.assert_allclose(s.sum(), 1.0, rtol=1e-5)


OVERLAY_PATCH = 64


@pytest.fixture(scope="module")
def slide_store(tmp_path_factory):
    """Two slides with level-0 pixel coordinates on a 64-px grid: ``t0``, a
    two-level pyramidal TIFF (raw tiles), and ``p0``, a PNG; their
    features, labels and images."""
    import h5py
    from PIL import Image

    from mhim_mil_tpu.preprocess.tiff import write_pyramidal_tiff

    root = tmp_path_factory.mktemp("slide_store")
    for d in ("pt_files", "h5_files", "images"):
        (root / d).mkdir()
    rng = np.random.default_rng(9)
    for sid, (h, w) in (("t0", (320, 448)), ("p0", (256, 320))):
        img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        if sid == "t0":
            write_pyramidal_tiff(str(root / "images" / "t0.tiff"), img, levels=2, tile=64, compression="raw")
        else:
            Image.fromarray(img).save(root / "images" / "p0.png")
        xs, ys = np.meshgrid(np.arange(0, w - 32, 48), np.arange(0, h - 32, 48))  # overlapping patches
        coords = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int64)
        torch.save(torch.tensor(rng.normal(size=(len(coords), IN_DIM)).astype(np.float32)),
                   root / "pt_files" / f"{sid}.pt")
        with h5py.File(root / "h5_files" / f"{sid}.h5", "w") as f:
            d = f.create_dataset("coords", data=coords)
            d.attrs["patch_size"] = 48
            d.attrs["downsample"] = [1, 1]
    csv = root / "labels.csv"
    pd.DataFrame({"ID": ["t0", "p0"], "Label": [0, 1]}).to_csv(csv, index=False)
    return str(root), str(csv)


@pytest.mark.parametrize("vis_level", [1, -1], ids=["level1", "thumbnail"])
def test_export_cli_image_dir_overlays_match_jax(tmp_path, monkeypatch, slide_store, vis_level):
    """Both tools with ``--image_dir`` over a pyramidal TIFF and a PNG, at
    ``--vis_level 1`` (the banded renderer on the TIFF's level 1; the PNG has
    no level 1 and takes the thumbnail path) and ``-1`` (the thumbnail path
    for both), with ``--sample_rois topk``: the same files; the overlays
    equal pixel for pixel, except that a pixel may differ where a patch
    covering it has another percentile in the two exports (their scores
    differ by fp32 rounding, which can swap near ties); the ROI CSVs the same
    patches with scores within 1e-5."""
    from PIL import Image

    root, csv = slide_store
    ckpt = str(tmp_path / "fold_0_model_best.ckpt")
    _jax_checkpoint(ckpt, "abmil")
    args = ["--model", "abmil", "--csv_path", csv, "--dataset_root", root, "--input_dim", str(IN_DIM),
            "--inner_dim", str(DIM), "--image_dir", os.path.join(root, "images"), "--patch_size",
            str(OVERLAY_PATCH), "--vis_level", str(vis_level), "--sample_rois", "topk", "--roi_k", "4"]
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    _run_jax_tool(monkeypatch, ["--ckpt", ckpt, "--out", want_dir, *args])
    scores = export_attention.main(["--ckpt", ckpt, "--out", got_dir, "--device", "cpu", *args])
    files = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == files
    assert files == sorted(f"{sid}_{k}" for sid in ("t0", "p0") for k in ("attn.npy", "attn.csv", "overlay.png",
                                                                           "rois.csv"))
    store = FeatureBagStore(root)
    # the TIFF's thumbnail is its level 1 too: both paths render at half scale
    shapes = {"t0": (160, 224, 3), "p0": (256, 320, 3)}
    for sid, shape in shapes.items():
        got = np.asarray(Image.open(os.path.join(got_dir, f"{sid}_overlay.png")))
        want = np.asarray(Image.open(os.path.join(want_dir, f"{sid}_overlay.png")))
        assert got.shape == want.shape == shape
        jax_scores = pd.read_csv(os.path.join(want_dir, f"{sid}_attn.csv"))["score"].to_numpy()
        changed = heatmap.to_percentiles(scores[sid]) != heatmap.to_percentiles(jax_scores)
        scale = 2 if sid == "t0" else 1
        allowed = np.zeros(shape[:2], bool)
        for x, y in store.pixel_coords(f"{sid}.pt")[changed] // scale:
            allowed[y:y + OVERLAY_PATCH // scale, x:x + OVERLAY_PATCH // scale] = True
        differs = (got != want).any(-1)
        assert not (differs & ~allowed).any(), f"{sid}: pixels differ outside the patches whose percentile differs"
        g_rois, w_rois = (pd.read_csv(os.path.join(d, f"{sid}_rois.csv")) for d in (got_dir, want_dir))
        assert len(g_rois) == len(w_rois) == 4
        np.testing.assert_array_equal(g_rois[["x", "y"]].to_numpy(), w_rois[["x", "y"]].to_numpy())
        np.testing.assert_allclose(g_rois["score"].to_numpy(), w_rois["score"].to_numpy(), rtol=0, atol=1e-5)
