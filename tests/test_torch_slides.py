"""The port's slide readers against the JAX package's on the CPU.

Each case writes its files with the JAX package's writers at
``tests/test_tiff.py``'s sizes and opens the same files with
``mhim_mil_tpu.preprocess`` and ``mhim_mil_torch.preprocess``: the reader
class, ``level_*``, ``properties``, ``associated_images``, ``read_region``
at every level (interior, off-tile, edge and out-of-bounds locations) and
``get_thumbnail`` are equal bit for bit, and every error has the same class
name and message. The port's writers, given the same input, write the same
bytes as JAX's. The native LZW and PackBits codec of the port
(``mhim_mil_torch/native``) is held against the Python decoders and JAX's.
The last cases pin four behaviours the port keeps because the JAX package
has them (ROADMAP.md, Queue 3, kept on purpose).
"""

from __future__ import annotations

import io
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from mhim_mil_tpu import native as JN
from mhim_mil_tpu.preprocess import mirax as JM
from mhim_mil_tpu.preprocess import ndpi as JD
from mhim_mil_tpu.preprocess import tiff as JT
from mhim_mil_tpu.preprocess import vendor_tiff as JV
from mhim_mil_tpu.preprocess import vms as JS
from mhim_mil_torch import native as PN
from mhim_mil_torch.preprocess import mirax as PM
from mhim_mil_torch.preprocess import ndpi as PD
from mhim_mil_torch.preprocess import tiff as PT
from mhim_mil_torch.preprocess import vendor_tiff as PV
from mhim_mil_torch.preprocess import vms as PS


def _smooth_img(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 0.19) % 256, (yy * 0.23) % 256, ((xx + yy) * 0.11) % 256], -1).astype(np.uint8)


def _noise_img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _locations(dims, seed, n=12):
    """Level-0 locations for ``read_region``: the origin, seeded interior
    and off-tile offsets, the right and bottom edges, a corner half outside
    and one wholly outside the slide."""
    w0, h0 = dims
    rng = np.random.default_rng(seed)
    locs = [(0, 0), (w0 - 20, h0 - 15), (w0 - 1, 0), (0, h0 - 1), (w0 + 5, h0 + 5)]
    locs += [tuple(int(v) for v in rng.integers(0, (w0, h0))) for _ in range(n)]
    return locs


def assert_same_slide(got, want, seed=0, sizes=((67, 53), (130, 9)), thumbs=(2048, 100, 33)):
    """``got`` (the port's reader) and ``want`` (JAX's) on the same file are
    equal bit for bit in everything a caller reads."""
    assert type(got).__name__ == type(want).__name__
    assert got.level_count == want.level_count
    assert tuple(got.dimensions) == tuple(want.dimensions)
    assert [tuple(d) for d in got.level_dimensions] == [tuple(d) for d in want.level_dimensions]
    assert list(got.level_downsamples) == list(want.level_downsamples)
    assert got.properties == want.properties
    g_assoc, w_assoc = got.associated_images, want.associated_images
    assert sorted(g_assoc) == sorted(w_assoc)
    for name in w_assoc:
        np.testing.assert_array_equal(g_assoc[name], w_assoc[name])
    for level in range(want.level_count):
        for loc in _locations(want.dimensions, seed + level):
            for size in sizes:
                g, w = got.read_region(loc, level, size), want.read_region(loc, level, size)
                assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape == (size[1], size[0], 3)
                np.testing.assert_array_equal(g, w, err_msg=f"level {level} at {loc}, size {size}")
    for m in thumbs:
        np.testing.assert_array_equal(got.get_thumbnail(m), want.get_thumbnail(m))


def open_both(path):
    return PT.open_slide(path), JT.open_slide(path)


def compare_files(path):
    got, want = open_both(path)
    try:
        assert_same_slide(got, want)
    finally:
        got.close()
        want.close()
    return type(want).__name__


def same_error(call_port, call_jax):
    """Both calls raise; the errors have the same class name and message."""
    with pytest.raises(Exception) as ej:
        call_jax()
    with pytest.raises(Exception) as ep:
        call_port()
    assert type(ep.value).__name__ == type(ej.value).__name__
    assert str(ep.value) == str(ej.value)
    return ep.value


def write_both(tmp_path, name, write_port, write_jax, *args, **kw):
    """Each package's writer on the same input into a directory of its own;
    every file either writes (the slide and its companions) has the same
    bytes. Returns the path of JAX's slide."""
    dirs = {}
    for side, write in (("port", write_port), ("jax", write_jax)):
        dirs[side] = tmp_path / side
        dirs[side].mkdir(exist_ok=True)
        write(str(dirs[side] / name), *args, **kw)

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)

    assert tree(dirs["port"]) == tree(dirs["jax"])
    for rel in tree(dirs["jax"]):
        assert (dirs["port"] / rel).read_bytes() == (dirs["jax"] / rel).read_bytes(), rel
    return str(dirs["jax"] / name)


# ---- pyramidal TIFF, BigTIFF, Aperio .svs -------------------------------------------


@pytest.mark.parametrize("comp", ["raw", "deflate", "jpeg", "lzw"])
def test_pyramidal_tiff_matches_jax(tmp_path, comp):
    img = _smooth_img(700, 900)
    path = write_both(tmp_path, f"s_{comp}.tiff", PT.write_pyramidal_tiff, JT.write_pyramidal_tiff, img, levels=3,
                      tile=128, compression=comp)
    assert compare_files(path) == "PyramidalTiff"
    if comp != "jpeg":
        s = PT.open_slide(path)
        np.testing.assert_array_equal(s.read_region((200, 150), 0, (300, 256)), img[150:406, 200:500])
        s.close()


@pytest.mark.parametrize("comp", ["tiff_lzw", "tiff_adobe_deflate", "packbits"])
def test_pil_written_strips_match_jax(tmp_path, comp):
    """Striped LZW, deflate and PackBits pages from an independent writer."""
    img = _smooth_img(260, 300)
    path = str(tmp_path / f"pil_{comp}.tiff")
    Image.fromarray(img).save(path, compression=comp)
    assert compare_files(path) == "PyramidalTiff"
    s = PT.PyramidalTiff(path)
    np.testing.assert_array_equal(s.read_region((0, 0), 0, (300, 260)), img)
    s.close()


def test_bigtiff_matches_jax(tmp_path):
    img = _smooth_img(500, 600)
    path = write_both(tmp_path, "big.tiff", PT.write_pyramidal_tiff, JT.write_pyramidal_tiff, img, levels=2, tile=128,
                      bigtiff=True)
    assert open(path, "rb").read(4) == b"II+\x00"
    assert compare_files(path) == "PyramidalTiff"


def test_thumbnail_streams_like_jax(tmp_path):
    """A one-level TIFF's thumbnail decimates tile-row bands: equal to
    JAX's and to the decimated image."""
    img = _smooth_img(530, 710)
    path = write_both(tmp_path, "one_level.tiff", PT.write_pyramidal_tiff, JT.write_pyramidal_tiff, img, levels=1,
                      tile=128)
    assert compare_files(path) == "PyramidalTiff"
    s = PT.PyramidalTiff(path)
    np.testing.assert_array_equal(s.get_thumbnail(100), img[::8, ::8])
    s.close()


@pytest.mark.parametrize("comp", ["jpeg", "j2k-rgb", "j2k-ycbcr"])
def test_svs_matches_jax(tmp_path, comp):
    """Aperio layout: tiled pyramid, striped thumbnail/label/macro pages as
    associated images, the description's metadata in ``properties``."""
    img = _smooth_img(520, 700)
    path = write_both(tmp_path, f"fixture_{comp}.svs", PT.write_aperio_svs, JT.write_aperio_svs, img, levels=2,
                      tile=128, compression=comp)
    assert compare_files(path) == "PyramidalTiff"
    s = PT.open_slide(path)
    assert s.level_count == 2 and set(s.associated_images) == {"thumbnail", "label", "macro"}
    assert s.properties["openslide.vendor"] == "aperio"
    s.close()


def test_non_tiff_named_tiff_falls_back_like_jax(tmp_path):
    """A PNG named ``.tiff`` opens as a flat raster in both."""
    img = _smooth_img(64, 80)
    path = str(tmp_path / "bogus.tiff")
    Image.fromarray(img).save(path, format="PNG")
    assert compare_files(path) == "RasterSlide"


@pytest.mark.parametrize("ext", [".vmu", ".isyntax", ".svslide"])
def test_vendor_format_errors_match_jax(tmp_path, ext):
    path = tmp_path / f"slide{ext}"
    path.write_bytes(b"\x00" * 64)
    err = same_error(lambda: PT.open_slide(str(path)), lambda: JT.open_slide(str(path)))
    assert isinstance(err, PT.UnsupportedVendorFormatError) and "pyramid" in str(err)


def test_content_detection_matches_jax():
    """The routing signals on raw IFD tags: NDPI, Philips, Leica and Ventana
    content, and a plain TIFF that routes nowhere."""
    base = {PT._W: (64,), PT._H: (64,)}
    cases = (
        ({**base, PT._NDPI_PRIVATE: (1,)}, "_NdpiContent"),
        ({**base, PT._MAKE: (b"Hamamatsu",)}, "_NdpiContent"),
        ({**base, PT._SOFTWARE: (b"Philips DP v1.0",)}, "_PhilipsContent"),
        ({**base, PT._DESC: (b'<scn xmlns="http://www.leica...">',)}, "_ScnContent"),
        ({**base, PT._XMP: (b"<iScan Magnification='20'/>",)}, "_VentanaContent"),
    )
    for tags, name in cases:
        err = same_error(lambda: PT._detect_vendor_tiff([tags]), lambda: JT._detect_vendor_tiff([tags]))
        assert type(err).__name__ == name
    assert PT._detect_vendor_tiff([base]) is None and JT._detect_vendor_tiff([base]) is None


# ---- the native codec ---------------------------------------------------------------


def _payloads():
    rng = np.random.default_rng(7)
    return [
        rng.integers(0, 256, 40000, dtype=np.uint8).tobytes(),  # incompressible
        (rng.integers(0, 4, 60000, dtype=np.uint8) * 63).tobytes(),  # runs
        bytes(np.tile(np.arange(256, dtype=np.uint8), 40)),  # cyclic
        b"",
    ]


def test_native_codec_matches_python_and_jax():
    """The port's C codec, built into ``build/native/`` by the host's
    compiler, against the Python decoders and JAX's codec, with the
    truncating ``cap``; the port's LZW encoder writes JAX's bytes."""
    if shutil.which("cc") or shutil.which("gcc"):
        assert PN.have_native()
        assert PN.library_path().exists() and PN.library_path().parent.name == "native"
        assert PN.library_path().parent.parent.name == "build"
    for data in _payloads():
        enc = PT._lzw_encode(data)
        assert enc == JT._lzw_encode(data)
        assert PT._lzw_decode_py(enc) == data
        for cap in (len(data), len(data) // 2):
            assert PN.lzw_decode(enc, cap) == JN.lzw_decode(enc, cap) == data[:cap]
        packed = _packbits(data)
        for cap in (len(data), len(data) // 3):
            assert PN.packbits_decode(packed, cap) == JN.packbits_decode(packed, cap) == data[:cap]
            assert PN._packbits_decode_py(packed, cap) == data[:cap]


def test_python_fallback_gives_the_same_bytes(tmp_path, monkeypatch):
    """Without the C library the port's decoders and an LZW slide read the
    same bytes."""
    img = _noise_img(200, 260, 3)
    path = write_both(tmp_path, "lzw.tiff", PT.write_pyramidal_tiff, JT.write_pyramidal_tiff, img, levels=2, tile=64,
                      compression="lzw")
    native = PT.open_slide(path).read_region((10, 20), 0, (150, 130))
    monkeypatch.setattr(PN, "_load", lambda: None)
    assert not PN.have_native()
    for data in _payloads():
        enc = PT._lzw_encode(data)
        assert PN.lzw_decode(enc, len(data)) == data
        assert PN.packbits_decode(_packbits(data), len(data)) == data
    s = PT.open_slide(path)
    np.testing.assert_array_equal(s.read_region((10, 20), 0, (150, 130)), native)
    np.testing.assert_array_equal(native, img[20:150, 10:160])
    s.close()


def _packbits(data: bytes) -> bytes:
    """PackBits through PIL's TIFF writer: the strip bytes of a one-row
    grayscale image."""
    if not data:
        return b""
    buf = io.BytesIO()
    Image.frombytes("L", (len(data), 1), data).save(buf, "TIFF", compression="packbits")
    from mhim_mil_tpu.preprocess.tiff import _read_ifd

    buf.seek(0)
    raw = buf.getvalue()
    bo = "<" if raw[:2] == b"II" else ">"
    off = int.from_bytes(raw[4:8], "little" if bo == "<" else "big")
    tags, _ = _read_ifd(buf, off, bo)
    start, count = tags[273][0], tags[279][0]
    return raw[start:start + count]


# ---- Hamamatsu NDPI -------------------------------------------------------------------


@pytest.mark.parametrize("restart_rows", [1, 2])
def test_ndpi_band_decode_matches_jax(tmp_path, restart_rows):
    img = _smooth_img(320, 480)
    path = write_both(tmp_path, "fix.ndpi", PD.write_ndpi, JD.write_ndpi, img, levels=3, mpp=0.5, lens=40.0,
                      restart_rows=restart_rows)
    assert compare_files(path) == "NdpiSlide"
    s = PT.open_slide(path)
    s.read_region((37, 53), 0, (100, 150))
    info = s._index(s._levels[0])
    assert info.rows_per_unit == restart_rows and info.mcu_h == 16 and not s._pages_whole
    s.close()


def test_ndpi_band_splicer_matches_jax():
    """Restart intervals shorter than an MCU row: the spliced band equals
    JAX's and PIL's whole decode."""
    img = _smooth_img(160, 480)
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", quality=90, restart_marker_blocks=15)
    data = b.getvalue()
    got, want = PD._JpegIndex(data), JD._JpegIndex(data)
    assert (got.rows_per_unit, got.segs_per_unit, got.mcu_h) == (want.rows_per_unit, want.segs_per_unit, want.mcu_h)
    full = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    for u0, u1 in ((3, 7), (0, 1), (9, 10)):
        band, y0 = got.band_jpeg(data, u0, u1)
        assert (band, y0) == want.band_jpeg(data, u0, u1)
        arr = np.asarray(Image.open(io.BytesIO(band)).convert("RGB"))
        np.testing.assert_array_equal(arr, full[y0:y0 + arr.shape[0]])


def test_ndpi_monolithic_fallback_and_guard_match_jax(tmp_path, monkeypatch):
    img = _smooth_img(160, 240)
    path = write_both(tmp_path, "mono.ndpi", PD.write_ndpi, JD.write_ndpi, img, levels=1, restart_rows=0, macro=False)
    assert compare_files(path) == "NdpiSlide"
    monkeypatch.setattr(PD, "_WHOLE_PAGE_MAX_PIXELS", 1000)
    monkeypatch.setattr(JD, "_WHOLE_PAGE_MAX_PIXELS", 1000)
    got, want = open_both(path)
    err = same_error(lambda: got.read_region((0, 0), 0, (32, 32)), lambda: want.read_region((0, 0), 0, (32, 32)))
    assert isinstance(err, PT.UnsupportedVendorFormatError) and "restart" in str(err)
    got.close()
    want.close()


def test_ndpi_content_in_a_tif_routes_like_jax(tmp_path):
    img = _smooth_img(96, 128)
    path = write_both(tmp_path, "hidden.tif", PD.write_ndpi, JD.write_ndpi, img, levels=2)
    assert compare_files(path) == "NdpiSlide"


# ---- Philips TIFF, Leica SCN, Ventana BIF ---------------------------------------------


def test_philips_matches_jax(tmp_path):
    """Absent background tiles render white in both."""
    img = _smooth_img(256, 384)
    path = write_both(tmp_path, "philips.tiff", PV.write_philips_tiff, JV.write_philips_tiff, img, levels=2, tile=128,
                      mpp=0.25, sparse={(0, 0), (1, 2)})
    assert compare_files(path) == "PhilipsTiff"
    s = PT.open_slide(path)
    assert (s.read_region((0, 0), 0, (64, 64)) == 255).all()
    s.close()


@pytest.mark.parametrize("name", ["slide.scn", "hidden_scn.tif"])
def test_scn_matches_jax(tmp_path, name):
    """By extension and by content inside a ``.tif``."""
    img = _smooth_img(260, 420)
    path = write_both(tmp_path, name, PV.write_leica_scn, JV.write_leica_scn, img, levels=2, tile=128, mpp=0.5,
                      objective=40)
    assert compare_files(path) == "LeicaScn"


def test_scn_multi_region_error_matches_jax(tmp_path):
    img = _smooth_img(260, 420)
    path = write_both(tmp_path, "tworegions.scn", PV.write_leica_scn, JV.write_leica_scn, img, levels=1, tile=128,
                      regions=2)
    err = same_error(lambda: PT.open_slide(path), lambda: JT.open_slide(path))
    assert isinstance(err, PT.UnsupportedVendorFormatError) and "region" in str(err)


@pytest.mark.parametrize("name", ["slide.bif", "hidden_bif.tif"])
def test_bif_matches_jax(tmp_path, name):
    img = _smooth_img(256, 384)
    path = write_both(tmp_path, name, PV.write_ventana_bif, JV.write_ventana_bif, img, levels=2, tile=128, mpp=0.465,
                      magnification=20)
    assert compare_files(path) == "VentanaBif"


def test_bif_multi_aoi_error_matches_jax(tmp_path):
    img = _smooth_img(128, 128)
    path = write_both(tmp_path, "twoaoi.bif", PV.write_ventana_bif, JV.write_ventana_bif, img, levels=1, tile=128,
                      aois=2)
    err = same_error(lambda: PT.open_slide(path), lambda: JT.open_slide(path))
    assert isinstance(err, PT.UnsupportedVendorFormatError) and "interest" in str(err)


# ---- MIRAX -------------------------------------------------------------------------------


def test_mirax_layout_matches_jax(tmp_path):
    img = _smooth_img(300, 460)
    path = write_both(tmp_path, "slide.mrxs", PM.write_mirax, JM.write_mirax, img, levels=3, tile=64, overlap=16,
                      mpp=0.2325, objective=20)
    assert compare_files(path) == "MiraxSlide"


@pytest.mark.parametrize("kw", [dict(levels=2, position="stitching", jitter=8), dict(levels=1, position=None),
                                dict(levels=1, absent={(0, 0)})], ids=["jitter", "no-buffer", "absent"])
def test_mirax_positions_and_fallbacks_match_jax(tmp_path, kw):
    """The recorded camera positions (zlib stitching buffer, jittered), the
    nominal grid without a buffer, and an absent camera; PNG cameras, so the
    reads are also exact against the source."""
    img = _noise_img(160, 230, 7)
    path = write_both(tmp_path, "m.mrxs", PM.write_mirax, JM.write_mirax, img, tile=64, overlap=16, fmt="PNG", **kw)
    assert compare_files(path) == "MiraxSlide"
    s = PT.open_slide(path)
    np.testing.assert_array_equal(s.read_region((64, 64), 0, (40, 40)), img[64:104, 64:104])
    s.close()


@pytest.mark.parametrize("case", ["orphan", "divisions", "bad-index"])
def test_mirax_errors_match_jax(tmp_path, case):
    img = _smooth_img(96, 128)
    if case == "orphan":
        path = str(tmp_path / "orphan.mrxs")
        open(path, "wb").write(b"\xff\xd8\xff\xe0" + b"\x00" * 60)
    elif case == "divisions":
        path = write_both(tmp_path, "div.mrxs", PM.write_mirax, JM.write_mirax, img, levels=1, tile=64, overlap=16,
                          divisions=2)
    else:
        path = write_both(tmp_path, "badidx.mrxs", PM.write_mirax, JM.write_mirax, img, levels=1, tile=64, overlap=16)
        idx = tmp_path / "jax" / "badidx" / "Index.dat"
        raw = bytearray(idx.read_bytes())
        raw[:3] = b"XXX"
        idx.write_bytes(bytes(raw))
    err = same_error(lambda: PT.open_slide(path), lambda: JT.open_slide(path))
    assert isinstance(err, PT.UnsupportedVendorFormatError)


# ---- Hamamatsu VMS ---------------------------------------------------------------------


def test_vms_layout_matches_jax(tmp_path):
    """A 2 × 2 JPEG mosaic and its DCT-scaled levels 1/2/4/8."""
    img = _smooth_img(288, 392)
    path = write_both(tmp_path, "slide.vms", PS.write_vms, JS.write_vms, img, cols=2, rows=2, mpp=0.23, lens=40)
    assert compare_files(path) == "VmsSlide"


def test_vms_whole_cell_fallback_matches_jax(tmp_path):
    img = _smooth_img(160, 240)
    path = write_both(tmp_path, "mono.vms", PS.write_vms, JS.write_vms, img, cols=1, rows=1, restart_rows=0)
    assert compare_files(path) == "VmsSlide"


@pytest.mark.parametrize("case", ["layers", "missing", "unaligned"])
def test_vms_errors_match_jax(tmp_path, case):
    img = _smooth_img(96, 128)
    if case == "layers":
        path = write_both(tmp_path, "layers.vms", PS.write_vms, JS.write_vms, img, no_layers=3)
    elif case == "missing":
        path = write_both(tmp_path, "missing.vms", PS.write_vms, JS.write_vms, img, cols=2)
        os.remove(tmp_path / "jax" / "missing_x1_y0.jpg")
    else:
        Image.fromarray(img[:, :100]).save(tmp_path / "ua_a.jpg", quality=90)
        Image.fromarray(img[:, 100:]).save(tmp_path / "ua_b.jpg", quality=90)
        path = str(tmp_path / "unaligned.vms")
        open(path, "w").write("[Virtual Microscope Specimen]\nNoLayers=1\nNoJpegColumns=2\nNoJpegRows=1\n"
                              "ImageFile=ua_a.jpg\nImageFile(1,0)=ua_b.jpg\n")
    err = same_error(lambda: PT.open_slide(path), lambda: JT.open_slide(path))
    assert isinstance(err, PT.UnsupportedVendorFormatError)


# ---- behaviours kept because the JAX package has them ------------------------------------


def test_kept_ndpi_thumbnail_fallback_reads_the_top_rows(tmp_path, monkeypatch):
    """Above the whole-page guard, ``NdpiSlide.get_thumbnail`` decimates only
    the top ``max_size`` rows of the smallest level (``ndpi.py:382``)."""
    img = _smooth_img(320, 480)
    path = write_both(tmp_path, "t.ndpi", PD.write_ndpi, JD.write_ndpi, img, levels=1, macro=False)
    monkeypatch.setattr(PD, "_WHOLE_PAGE_MAX_PIXELS", 1000)
    monkeypatch.setattr(JD, "_WHOLE_PAGE_MAX_PIXELS", 1000)
    got, want = open_both(path)
    th = got.get_thumbnail(64)
    np.testing.assert_array_equal(th, want.get_thumbnail(64))
    assert th.shape == (8, 60, 3)  # 64 of 320 rows, every 8th: the lower 256 rows are missing
    got.close()
    want.close()


def test_kept_ndpi_page_bytes_reread_on_every_band_miss(tmp_path):
    """``NdpiSlide`` reads the page's whole JPEG stream again for each band
    that misses its cache (``ndpi.py:306``)."""
    img = _smooth_img(320, 480)
    path = write_both(tmp_path, "r.ndpi", PD.write_ndpi, JD.write_ndpi, img, levels=1, macro=False)
    reads = {}
    for side, s in zip(("port", "jax"), open_both(path)):
        page_bytes, reads[side] = s._page_bytes, []
        s._page_bytes = lambda p, f=page_bytes, r=reads[side]: r.append(p.count) or f(p)
        for y in (0, 100, 200, 0, 300):  # four bands, the fifth read a cache hit
            s.read_region((0, y), 0, (16, 16))
        s.close()
    assert reads["port"] == reads["jax"] and len(reads["port"]) == 1 + 4  # the index, then one a band miss
    assert len(set(reads["port"])) == 1  # the whole page each time


def test_kept_content_routed_reader_error_escapes_open_slide(tmp_path):
    """A striped plain TIFF whose Make names Hamamatsu routes to
    ``NdpiSlide``, which finds no NDPI marker: its ``UnsupportedTiffError``
    leaves ``open_slide`` instead of a raster fallback (``tiff.py:781``)."""
    path = str(tmp_path / "hamamatsu_make.tif")
    Image.fromarray(_smooth_img(64, 80)).save(path, tiffinfo={271: "Hamamatsu"})
    err = same_error(lambda: PT.open_slide(path), lambda: JT.open_slide(path))
    assert type(err).__name__ == "UnsupportedTiffError" and "65420" in str(err)


def test_kept_scn_macro_ifd_is_not_checked(tmp_path):
    """A macro image whose dimension names a directory past the file's last
    raises ``IndexError`` from ``LeicaScn``, not a named error
    (``vendor_tiff.py:263``)."""
    img = _smooth_img(260, 420)
    path = write_both(tmp_path, "badmacro.scn", PV.write_leica_scn, JV.write_leica_scn, img, levels=1, tile=128)
    raw = open(path, "rb").read()
    macro = raw.index(b'r="0" ifd="0"')
    assert raw.count(b'r="0" ifd="0"') == 1
    open(path, "wb").write(raw[:macro] + b'r="0" ifd="9"' + raw[macro + 13:])
    err = same_error(lambda: PT.open_slide(path), lambda: JT.open_slide(path))
    assert type(err).__name__ == "IndexError"
