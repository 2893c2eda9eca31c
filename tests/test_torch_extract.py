"""The port's extraction layer against the JAX package's on the CPU:
``crop_patches`` and ``extract_features`` (``mhim_mil_torch/preprocess/extract.py``),
the tissue segmentation and patch grid (``preprocess/segment.py``, bit for
bit), the raster slide and ``open_slide``'s routing of each slide extension
(``preprocess/tiff.py``) and the CLI
``python -m mhim_mil_torch.tools.extract_features`` against
``tools/extract_features.py`` on a directory of PNGs, and of PNGs with an
Aperio ``.svs``, features within 1e-4."""

from __future__ import annotations

import csv
import io
import os
import re
import sys
from contextlib import redirect_stdout
from functools import partial

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mhim_mil_tpu.preprocess import encoders as J
from mhim_mil_tpu.preprocess import extract as JX
from mhim_mil_tpu.preprocess import segment as JS
from mhim_mil_tpu.preprocess import tiff as JT
from mhim_mil_torch.data.readers import FeatureBagStore
from mhim_mil_torch.preprocess import encoders as P
from mhim_mil_torch.preprocess import extract as PX
from mhim_mil_torch.preprocess import segment as PS
from mhim_mil_torch.preprocess import tiff as PT
from mhim_mil_torch.tools import extract_features as port_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_cli():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__("extract_features")
    finally:
        sys.path.pop(0)


def _tissue_image(h, w, seed):
    """White background with saturated pink blobs and a small speck (below
    the area filter), noisy like a scanned slide."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 240, np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for cy, cx, ry, rx in ((0.35, 0.3, 0.25, 0.2), (0.6, 0.7, 0.3, 0.22), (0.8, 0.25, 0.12, 0.15)):
        inside = ((yy / h - cy) / ry) ** 2 + ((xx / w - cx) / rx) ** 2 < 1
        img[inside] = (200, 110, 160)
    img[h // 10, w - w // 10] = (200, 110, 160)
    return np.clip(img.astype(int) + rng.integers(-12, 12, img.shape), 0, 255).astype(np.uint8)


def _r18(seed=0):
    return P.random_init_(P.ResNetTrunc((2, 2, 2), "basic"), torch.Generator().manual_seed(seed)).eval()


def _jax_r18(port):
    model = J.ResNetTrunc(depths=(2, 2, 2), block="basic")
    variables = jax.tree.map(jnp.asarray, J.import_resnet_trunc(port.state_dict(), (2, 2, 2), "basic"))
    return jax.jit(partial(model.apply, variables))


def test_crop_patches_at_the_edges():
    img = _tissue_image(50, 70, 0)
    coords = np.array([[0, 0], [60, 0], [0, 40], [60, 40], [69, 49], [30, 20]])
    got = PX.crop_patches(img, coords, 16)
    np.testing.assert_array_equal(got, JX.crop_patches(img, coords, 16))
    assert (got[3, 10:] == 0).all() and (got[3, :, 10:] == 0).all()  # zero beyond the raster


@pytest.mark.parametrize("source", ["array", "slide"])
def test_extract_features_short_batch_matches_jax(source, tmp_path):
    """Seven patches at batch 3: the last batch is short, padded and cut;
    the same r18 weights on both sides. ``slide``: the patches come from
    each package's ``slide_patch_reader`` over its raster slide."""
    img = _tissue_image(96, 128, 1)
    coords = np.array([[0, 0], [32, 0], [64, 0], [96, 0], [0, 32], [96, 64], [100, 80]])
    port = _r18(2)
    if source == "slide":
        path = str(tmp_path / "s.png")
        Image.fromarray(img).save(path)
        src_p, src_j = PX.slide_patch_reader(PT.open_slide(path), 32), JX.slide_patch_reader(JT.open_slide(path), 32)
    else:
        src_p = src_j = img
    got = PX.extract_features(port, src_p, coords, patch_size=32, batch_size=3, norm="imagenet")
    want = JX.extract_features(_jax_r18(port), src_j, coords, patch_size=32, batch_size=3, norm="imagenet")
    assert got.shape == (7, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **FEATURE_TOL)
    # one patch alone, unpadded, through the module gives the same row (to
    # fp32 rounding: the CPU's convolutions sum in another order at batch 1)
    x = torch.from_numpy(PX.crop_patches(img, coords[-1:], 32)).float() / 255.0
    mean, std = (torch.tensor(c) for c in PX.NORM_CONSTANTS["imagenet"])
    with torch.no_grad():
        one = port(((x - mean) / std).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got[-1:], one, atol=1e-5, rtol=1e-5)
    assert PX.extract_features(port, img, coords[:0], 32).shape == (0, 0)


def test_segmentation_is_jax_bit_for_bit():
    img = _tissue_image(120, 160, 2)
    s = PS.rgb_to_saturation(img)
    np.testing.assert_array_equal(s, JS.rgb_to_saturation(img))
    blurred = PS.median_blur(s, 7)
    np.testing.assert_array_equal(blurred, JS.median_blur(s, 7))
    assert PS.otsu_threshold(blurred) == JS.otsu_threshold(blurred)
    mask = blurred > PS.otsu_threshold(blurred)
    np.testing.assert_array_equal(PS._connected_components(mask), JS._connected_components(mask))
    for sthresh in (0, 20):
        got, want = PS.segment_tissue(img, sthresh=sthresh), JS.segment_tissue(img, sthresh=sthresh)
        np.testing.assert_array_equal(got, want)
        assert got.any() and not got.all()
    for ps, step, cov in ((32, 32, 0.5), (64, 48, 0.25), (100, 100, 0.9)):
        got = PS.generate_patch_coords(mask, (480, 640), ps, step, cov)
        want = JS.generate_patch_coords(mask, (480, 640), ps, step, cov)
        assert got.keys() == want.keys() and got["patch_size"] == want["patch_size"]
        np.testing.assert_array_equal(got["coords"], want["coords"])
        np.testing.assert_array_equal(got["downsample"], want["downsample"])
        assert got["coords"].dtype == want["coords"].dtype and len(got["coords"])


def test_raster_slide_matches_jax(tmp_path):
    img = _tissue_image(90, 200, 3)
    path = str(tmp_path / "r.png")
    Image.fromarray(img).save(path)
    got, want = PT.open_slide(path), JT.open_slide(path)
    assert got.dimensions == want.dimensions == (200, 90)
    assert got.level_dimensions == want.level_dimensions and got.level_count == want.level_count
    for loc in ((0, 0), (190, 80), (300, 10)):
        np.testing.assert_array_equal(got.read_region(loc, 0, (32, 32)), want.read_region(loc, 0, (32, 32)))
    for size in (2048, 64, 50):
        np.testing.assert_array_equal(got.get_thumbnail(size), want.get_thumbnail(size))


def _write_slide(path, ext):
    """A small slide in the format of ``ext``, written by the JAX package's
    writer; ``.vmu`` and ``.isyntax`` have none (both packages name them
    and refuse them)."""
    from mhim_mil_tpu.preprocess import mirax, ndpi, vendor_tiff, vms

    img = _tissue_image(192, 256, 5)
    low = ext.lower()
    if low == ".svs":
        JT.write_aperio_svs(path, img, levels=2, tile=64)
    elif low == ".ndpi":
        ndpi.write_ndpi(path, img, levels=2)
    elif low == ".tif":
        JT.write_pyramidal_tiff(path, img, levels=2, tile=64, compression="deflate")
    elif low == ".tiff":  # Philips content inside a .tiff: routed by content
        vendor_tiff.write_philips_tiff(path, img, levels=2, tile=64)
    elif low == ".mrxs":
        mirax.write_mirax(path, img, levels=2, tile=64, overlap=16)
    elif low == ".vms":
        vms.write_vms(path, img, cols=2, rows=1)
    elif low == ".scn":
        vendor_tiff.write_leica_scn(path, img, levels=2, tile=64)
    elif low == ".bif":
        vendor_tiff.write_ventana_bif(path, img, levels=2, tile=64)
    else:
        open(path, "wb").write(b"\x00" * 64)


def _open_like_jax(path):
    """Both packages' ``open_slide`` on ``path``: the same reader class and
    level-0 reads, or the same error class and message. Returns the class
    name of what JAX's returned or raised."""
    try:
        want = JT.open_slide(path)
    except Exception as e:  # noqa: BLE001 - the error is what is compared
        with pytest.raises(Exception) as got:
            PT.open_slide(path)
        assert (type(got.value).__name__, str(got.value)) == (type(e).__name__, str(e))
        return type(e).__name__
    got = PT.open_slide(path)
    try:
        assert type(got).__name__ == type(want).__name__
        assert got.level_dimensions == want.level_dimensions and got.properties == want.properties
        np.testing.assert_array_equal(got.read_region((40, 30), 0, (64, 48)), want.read_region((40, 30), 0, (64, 48)))
        return type(want).__name__
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize("ext", [".svs", ".ndpi", ".tif", ".tiff", ".mrxs", ".vms", ".scn", ".bif", ".vmu",
                                 ".isyntax", ".SVS"])
def test_pyramidal_and_vendor_paths_raise(ext, tmp_path):
    """The port's ``open_slide`` routes each extension as JAX's does: a file
    of that format opens with the same reader, the two vendor formats
    neither reads raise the same named error, and the four bytes of a bare
    TIFF header raise the same error in both or fall back alike."""
    readers = {".svs": "PyramidalTiff", ".ndpi": "NdpiSlide", ".tif": "PyramidalTiff", ".tiff": "PhilipsTiff",
               ".mrxs": "MiraxSlide", ".vms": "VmsSlide", ".scn": "LeicaScn", ".bif": "VentanaBif",
               ".vmu": "UnsupportedVendorFormatError", ".isyntax": "UnsupportedVendorFormatError"}
    path = str(tmp_path / f"slide{ext}")
    _write_slide(path, ext)
    assert _open_like_jax(path) == readers[ext.lower()]
    bare = tmp_path / f"bare{ext}"
    bare.write_bytes(b"II*\x00")
    _open_like_jax(str(bare))


def _make_pngs(root):
    os.makedirs(root, exist_ok=True)
    for i, (h, w) in enumerate(((128, 128), (96, 160), (128, 128), (128, 96))):
        Image.fromarray(_tissue_image(h, w, 10 + i)).save(os.path.join(root, f"slide_{i}.png"))


def _run_cli(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return [re.sub(r"\([0-9.]+s\)$", "(s)", line) for line in out.getvalue().splitlines()]


def test_cli_matches_jax(tmp_path):
    """Both CLIs on the same PNGs and r18 checkpoint, with a preset, a
    process list (one slide with overrides, one with ``process=0``, one
    not listed and so filtered, one plain) and stitches: the same printed
    lines but the seconds, slide ids, coordinates and ``h5`` attributes,
    features within 1e-4, stitch images equal; the port's store reads back
    through its ``FeatureBagStore``."""
    src = tmp_path / "imgs"
    _make_pngs(str(src))
    ckpt = tmp_path / "r18.pt"
    torch.save(_r18(4).state_dict(), ckpt)
    preset = tmp_path / "preset.csv"
    with open(preset, "w", newline="") as f:
        w = csv.DictWriter(f, ["coverage", "sthresh"])
        w.writeheader()
        w.writerow({"coverage": "0.4", "sthresh": ""})
    plist = tmp_path / "plist.csv"
    with open(plist, "w", newline="") as f:
        w = csv.DictWriter(f, ["slide_id", "process", "patch_size", "step_size"])
        w.writeheader()
        w.writerow({"slide_id": "slide_0", "process": "1", "patch_size": "48", "step_size": "40"})
        w.writerow({"slide_id": "slide_1", "process": "0"})
        w.writerow({"slide_id": "slide_3", "process": "1"})
    common = ["--source", str(src), "--encoder", "r18", "--ckpt_path", str(ckpt), "--patch_size", "32",
              "--step_size", "32", "--batch_size", "5", "--preset", str(preset), "--process_list", str(plist),
              "--stitch"]
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    lines_j = _run_cli(_jax_cli().main, common + ["--save_dir", str(out_j)])
    lines_p = _run_cli(port_cli.main, common + ["--save_dir", str(out_p), "--device", "cpu"])
    assert lines_p == [line.replace(str(out_j), str(out_p)) for line in lines_j]
    assert any("process=0, skipped" in line for line in lines_p)

    ids = sorted(os.listdir(out_p / "pt_files"))
    assert ids == sorted(os.listdir(out_j / "pt_files")) == ["slide_0.pt", "slide_3.pt"]
    store = FeatureBagStore(str(out_p))
    assert store.files == ids
    for fname in ids:
        sid = fname[:-3]
        with h5py.File(out_p / "h5_files" / f"{sid}.h5") as fp, h5py.File(out_j / "h5_files" / f"{sid}.h5") as fj:
            np.testing.assert_array_equal(fp["coords"][:], fj["coords"][:])
            assert fp["coords"].dtype == fj["coords"].dtype
            assert sorted(fp["coords"].attrs) == sorted(fj["coords"].attrs) == ["downsample", "level_dim", "patch_size"]
            for k in fj["coords"].attrs:
                np.testing.assert_array_equal(fp["coords"].attrs[k], fj["coords"].attrs[k])
            np.testing.assert_allclose(fp["features"][:], fj["features"][:], **FEATURE_TOL)
            np.testing.assert_array_equal(store.load(fname), fp["features"][:])
        assert store.load(fname).shape[1] == 256
        np.testing.assert_array_equal(np.asarray(Image.open(out_p / "stitches" / f"{sid}_stitch.jpg")),
                                      np.asarray(Image.open(out_j / "stitches" / f"{sid}_stitch.jpg")))
    with h5py.File(out_p / "h5_files" / "slide_0.h5") as f:
        assert f["coords"].attrs["patch_size"] == 48  # the process list's override


def test_cli_refuses_a_pyramidal_slide(tmp_path):
    """PNGs and an Aperio ``.svs`` written by JAX's writer through both
    CLIs: the same slides and coordinates, features within 1e-4."""
    src = tmp_path / "imgs"
    _make_pngs(str(src))
    JT.write_aperio_svs(str(src / "slide_9.svs"), _tissue_image(192, 256, 20), levels=2, tile=64)
    ckpt = tmp_path / "r18.pt"
    torch.save(_r18(5).state_dict(), ckpt)
    common = ["--source", str(src), "--encoder", "r18", "--ckpt_path", str(ckpt), "--patch_size", "32",
              "--step_size", "32", "--batch_size", "8"]
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    lines_j = _run_cli(_jax_cli().main, common + ["--save_dir", str(out_j)])
    lines_p = _run_cli(port_cli.main, common + ["--save_dir", str(out_p), "--device", "cpu"])
    assert lines_p == [line.replace(str(out_j), str(out_p)) for line in lines_j]
    ids = sorted(os.listdir(out_p / "pt_files"))
    assert ids == sorted(os.listdir(out_j / "pt_files")) and "slide_9.pt" in ids and len(ids) == 5
    for fname in ids:
        sid = fname[:-3]
        with h5py.File(out_p / "h5_files" / f"{sid}.h5") as fp, h5py.File(out_j / "h5_files" / f"{sid}.h5") as fj:
            np.testing.assert_array_equal(fp["coords"][:], fj["coords"][:])
            for k in fj["coords"].attrs:
                np.testing.assert_array_equal(fp["coords"].attrs[k], fj["coords"].attrs[k])
            np.testing.assert_allclose(fp["features"][:], fj["features"][:], **FEATURE_TOL)
    with h5py.File(out_p / "h5_files" / "slide_9.h5") as f:
        assert list(f["coords"].attrs["level_dim"]) == [256, 192] and len(f["coords"]) > 0
