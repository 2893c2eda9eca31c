"""MIRAX (3DHISTECH ``.mrxs``) reader — multi-file, pure Python.

A copy of ``mhim_mil_tpu/preprocess/mirax.py``.

The reference opens MIRAX slides through OpenSlide's ``mirax`` driver
(`CLAM/wsi_core/WholeSlideImage.py:22-90` calls ``openslide.open_slide``
unconditionally). MIRAX is not a TIFF: a ``Slide.mrxs`` file (itself just
a raster preview) sits next to a directory of the same basename holding
``Slidedat.ini`` (key/value metadata), an index file (default
``Index.dat``) and numbered ``Data*.dat`` payload files. This module
implements the single-plane subset OpenSlide documents
(openslide.org "MIRAX format"):

  * ``Slidedat.ini``: ``[GENERAL]`` (slide version/id, camera grid
    ``IMAGENUMBER_X/Y``, objective magnification), ``[HIERARCHICAL]``
    (the hierarchy/value tables that give every stored payload a
    flattened record number in the index file — the ``Slide zoom level``
    hierarchy lists the pyramid levels, nonhierarchical values carry the
    camera-position buffer and the associated images), ``[DATAFILE]``
    (the ``Data*.dat`` names), and one section per zoom level
    (``IMAGE_FORMAT``, stored-image ``DIGITIZER_WIDTH/HEIGHT``,
    ``IMAGE_CONCAT_FACTOR`` = cameras per stored-image side = the
    level's downsample, camera ``OVERLAP_X/Y``, ``IMAGE_FILL_COLOR_BGR``,
    ``MICROMETER_PER_PIXEL_X/Y``).
  * the index file: the slide-version and slide-id strings, then two
    little-endian int32 offsets — the hierarchical and nonhierarchical
    root tables. Each root is an int32 pointer per flattened value
    (0 = absent); each pointer leads to an int32 page pointer; each page
    is ``{int32 n_entries, int32 next_page}`` followed by 4-int32
    entries — ``(image_index, offset, length, fileno)`` for hierarchical
    (tile) records, ``(pad, offset, length, fileno)`` for
    nonhierarchical records.
  * the camera-position buffer (nonhier value ``VIMSLIDE_POSITION_BUFFER``
    raw, or ``StitchingIntensityLevel`` zlib-compressed): 9-byte records
    ``uint8 flag, int32 x, int32 y`` per camera in row-major grid order —
    the level-0 pixel position of every camera image, which is what makes
    the overlapping-camera mosaic renderable. Slides without a buffer use
    the nominal grid (``(digitizer - overlap)`` spacing), like OpenSlide.
  * zoom level ``L`` stores one image per ``c x c`` camera block
    (``c = IMAGE_CONCAT_FACTOR``); its ``image_index`` is row-major over
    the ``ceil(images_x / c)``-wide tile grid and it is drawn at the
    top-left covered camera's position divided by ``c``. Overlapping
    tiles simply paint over each other (identical content in real
    scans — OpenSlide renders the same way); uncovered canvas is the
    level's fill color.
  * associated images are nonhier values ``ScanDataLayer_SlideThumbnail``
    (-> ``thumbnail``), ``ScanDataLayer_SlidePreview`` (-> ``macro``) and
    ``ScanDataLayer_SlideBarcode`` (-> ``label``), stored as ordinary
    JPEG/PNG/BMP payloads in the data files.

Out of scope, raised as named ``UnsupportedVendorFormatError`` with a
conversion recipe (never a generic parse error): ``.mrxs`` files missing
their data directory, ``CameraImageDivisionsPerSide != 1`` (sub-divided
camera tiles), and stored-image formats other than JPEG/PNG/BMP.
"""

from __future__ import annotations

import configparser
import io
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .tiff import UnsupportedVendorFormatError, _CONVERT_HINT

_SLIDEDAT = "Slidedat.ini"
_ZOOM_HIER_NAME = "Slide zoom level"
_POSITION_VALS = {
    "VIMSLIDE_POSITION_BUFFER": "raw",
    "StitchingIntensityLevel": "zlib",
}
_ASSOC_VALS = {
    "ScanDataLayer_SlideThumbnail": "thumbnail",
    "ScanDataLayer_SlidePreview": "macro",
    "ScanDataLayer_SlideBarcode": "label",
}
_FORMATS = {"JPEG", "PNG", "BMP24", "BMP"}


def _mirax_error(msg: str) -> UnsupportedVendorFormatError:
    return UnsupportedVendorFormatError(f"MIRAX: {msg}; {_CONVERT_HINT}")


class _MiraxLevel:
    """One zoom level: stored-image geometry + the (sparse) tile table."""

    def __init__(self, sect: configparser.SectionProxy):
        self.fmt = sect.get("IMAGE_FORMAT", "JPEG").strip()
        if self.fmt not in _FORMATS:
            raise _mirax_error(f"stored-image format {self.fmt!r} is not supported")
        self.tile_w = sect.getint("DIGITIZER_WIDTH")
        self.tile_h = sect.getint("DIGITIZER_HEIGHT")
        self.concat = sect.getint("IMAGE_CONCAT_FACTOR", fallback=1) or 1
        self.overlap_x = sect.getfloat("OVERLAP_X", fallback=0.0)
        self.overlap_y = sect.getfloat("OVERLAP_Y", fallback=0.0)
        # Windows COLORREF: R in the low byte, B in the high ("BGR" read
        # from the most significant byte down). White (the usual value)
        # is unaffected by the convention.
        fill = sect.getint("IMAGE_FILL_COLOR_BGR", fallback=0xFFFFFF)
        self.fill_rgb = (fill & 0xFF, (fill >> 8) & 0xFF, (fill >> 16) & 0xFF)
        self.mpp_x = sect.getfloat("MICROMETER_PER_PIXEL_X", fallback=0.0)
        self.mpp_y = sect.getfloat("MICROMETER_PER_PIXEL_Y", fallback=0.0)
        # filled from the index file: image_index -> (offset, length, fileno)
        self.tiles: Dict[int, Tuple[int, int, int]] = {}
        # filled once the camera grid is known
        self.tiles_across = 0
        self.width = 0
        self.height = 0


class MiraxSlide:
    """OpenSlide-like random access over a MIRAX ``.mrxs`` slide.

    Same API surface as :class:`~mhim_mil_torch.preprocess.tiff.PyramidalTiff`
    (``level_count`` / ``dimensions`` / ``level_dimensions`` /
    ``level_downsamples`` / ``read_region`` with level-0 location /
    ``get_thumbnail`` / ``properties`` / ``associated_images``), which is
    the surface the reference consumes through openslide
    (CLAM/dataset_modules/dataset_h5.py:79-84).
    """

    def __init__(self, path: str, tile_cache: int = 64):
        base, _ = os.path.splitext(path)
        if os.path.isdir(path):  # accept the data directory itself
            base = path
        self._dir = base
        ini_path = os.path.join(base, _SLIDEDAT)
        if not os.path.isfile(ini_path):
            raise _mirax_error(
                f"{os.path.basename(path)} has no data directory "
                f"({os.path.join(os.path.basename(base), _SLIDEDAT)} not found) "
                "— a .mrxs slide is the directory next to the file"
            )
        ini = configparser.ConfigParser(interpolation=None, strict=False)
        ini.optionxform = str  # MIRAX keys are case-sensitive
        with open(ini_path, "r", encoding="utf-8-sig", errors="replace") as f:
            ini.read_string(f.read())
        self._files: List[object] = []
        try:
            self._parse(ini)
        except UnsupportedVendorFormatError:
            self.close()
            raise
        except (KeyError, ValueError, OSError, struct.error,
                configparser.Error) as e:
            self.close()
            raise _mirax_error(f"malformed Slidedat/index ({e})")
        except Exception:
            self.close()
            raise
        self._tile_cache_max = tile_cache
        self._tiles: Dict[Tuple[int, int], np.ndarray] = {}
        self._tile_order: List[Tuple[int, int]] = []
        self._assoc_cache: Dict[str, np.ndarray] = {}

    # -- metadata ----------------------------------------------------------

    def _parse(self, ini: configparser.ConfigParser) -> None:
        gen = ini["GENERAL"]
        version = gen.get("SLIDE_VERSION", "").strip()
        slide_id = gen.get("SLIDE_ID", "").strip()
        self._images_x = gen.getint("IMAGENUMBER_X")
        self._images_y = gen.getint("IMAGENUMBER_Y")
        divisions = gen.getint("CameraImageDivisionsPerSide", fallback=1) or 1
        if divisions != 1:
            raise _mirax_error(
                f"CameraImageDivisionsPerSide={divisions} (sub-divided camera "
                "tiles) is not supported"
            )

        hier = ini["HIERARCHICAL"]
        datafiles = ini["DATAFILE"]
        self._datafile_names = [
            datafiles[f"FILE_{i}"].strip()
            for i in range(datafiles.getint("FILE_COUNT"))
        ]
        self._files = [None] * len(self._datafile_names)

        # Flattened record numbering: hier values in (hier, value) order,
        # nonhier values likewise — the order the index roots use.
        zoom_sections: List[str] = []
        zoom_record0 = -1
        rec = 0
        for i in range(hier.getint("HIER_COUNT")):
            cnt = hier.getint(f"HIER_{i}_COUNT")
            if hier.get(f"HIER_{i}_NAME", "").strip() == _ZOOM_HIER_NAME:
                zoom_record0 = rec
                zoom_sections = [
                    hier[f"HIER_{i}_VAL_{j}_SECTION"].strip() for j in range(cnt)
                ]
            rec += cnt
        if not zoom_sections:
            raise _mirax_error(f"no {_ZOOM_HIER_NAME!r} hierarchy in Slidedat.ini")

        position_rec = -1
        position_enc = "raw"
        assoc_recs: Dict[str, int] = {}
        rec = 0
        for i in range(hier.getint("NONHIER_COUNT")):
            for j in range(hier.getint(f"NONHIER_{i}_COUNT")):
                val = hier.get(f"NONHIER_{i}_VAL_{j}", "").strip()
                if val in _POSITION_VALS:
                    position_rec, position_enc = rec, _POSITION_VALS[val]
                elif val in _ASSOC_VALS:
                    assoc_recs[_ASSOC_VALS[val]] = rec
                rec += 1
        n_nonhier = rec

        self._levels = [_MiraxLevel(ini[s]) for s in zoom_sections]

        # -- index file: roots -> per-record data pages --------------------
        index_name = hier.get("INDEXFILE", "Index.dat").strip()
        with open(os.path.join(self._dir, index_name), "rb") as f:
            idx = f.read()
        pos = len(version) + len(slide_id)
        if idx[: len(version)].decode("ascii", "replace") != version:
            raise _mirax_error("index file version does not match Slidedat.ini")
        if idx[len(version) : pos].decode("ascii", "replace") != slide_id:
            raise _mirax_error("index file slide id does not match Slidedat.ini")
        hier_root, nonhier_root = struct.unpack_from("<ii", idx, pos)

        def record_entries(root: int, record: int) -> List[Tuple[int, ...]]:
            (ptr,) = struct.unpack_from("<i", idx, root + 4 * record)
            if not ptr:
                return []
            (page,) = struct.unpack_from("<i", idx, ptr)
            out: List[Tuple[int, ...]] = []
            while page:
                n, nxt = struct.unpack_from("<ii", idx, page)
                for k in range(n):
                    out.append(struct.unpack_from("<4i", idx, page + 8 + 16 * k))
                page = nxt
            return out

        for lv_i, lv in enumerate(self._levels):
            for image_index, offset, length, fileno in record_entries(
                hier_root, zoom_record0 + lv_i
            ):
                lv.tiles[image_index] = (offset, length, fileno)

        self._assoc_payloads: Dict[str, Tuple[int, int, int]] = {}
        for name, r in assoc_recs.items():
            if 0 <= r < n_nonhier:
                ents = record_entries(nonhier_root, r)
                if ents:
                    _, offset, length, fileno = ents[0]
                    self._assoc_payloads[name] = (offset, length, fileno)

        # -- camera positions ---------------------------------------------
        n_cam = self._images_x * self._images_y
        lv0 = self._levels[0]
        step_x = lv0.tile_w - lv0.overlap_x
        step_y = lv0.tile_h - lv0.overlap_y
        pos_xy = np.empty((n_cam, 2), np.int64)
        grid = np.arange(n_cam)
        pos_xy[:, 0] = np.round((grid % self._images_x) * step_x)
        pos_xy[:, 1] = np.round((grid // self._images_x) * step_y)
        self._camera_present = np.ones(n_cam, bool)
        if position_rec >= 0:
            ents = record_entries(nonhier_root, position_rec)
            if ents:
                _, offset, length, fileno = ents[0]
                buf = self._payload(offset, length, fileno)
                if position_enc == "zlib":
                    buf = zlib.decompress(buf)
                n = min(n_cam, len(buf) // 9)
                rec_arr = np.frombuffer(buf[: n * 9], np.uint8).reshape(n, 9)
                self._camera_present[:n] = rec_arr[:, 0] != 0
                pos_xy[:n] = rec_arr[:, 1:].copy().view("<i4").reshape(n, 2)
        self._positions = pos_xy

        # -- level geometry ------------------------------------------------
        w0 = int(pos_xy[:, 0].max()) + lv0.tile_w
        h0 = int(pos_xy[:, 1].max()) + lv0.tile_h
        for lv in self._levels:
            c = lv.concat
            lv.tiles_across = -(-self._images_x // c)
            lv.width = -(-w0 // c)
            lv.height = -(-h0 // c)

        self.level_count = len(self._levels)
        self.level_dimensions = [(lv.width, lv.height) for lv in self._levels]
        self.dimensions = self.level_dimensions[0]
        self.level_downsamples = [float(lv.concat) for lv in self._levels]

        self.properties: Dict[str, str] = {"openslide.vendor": "mirax"}
        if lv0.mpp_x:
            self.properties["openslide.mpp-x"] = f"{lv0.mpp_x:.6f}"
            self.properties["openslide.mpp-y"] = f"{lv0.mpp_y or lv0.mpp_x:.6f}"
        mag = gen.get("OBJECTIVE_MAGNIFICATION", "").strip()
        if mag:
            self.properties["openslide.objective-power"] = mag
        for key in ("SLIDE_VERSION", "SLIDE_ID", "IMAGENUMBER_X", "IMAGENUMBER_Y"):
            if gen.get(key):
                self.properties[f"mirax.GENERAL.{key}"] = gen.get(key).strip()

    # -- payload access ----------------------------------------------------

    def _payload(self, offset: int, length: int, fileno: int) -> bytes:
        if not 0 <= fileno < len(self._files):
            raise _mirax_error(f"record points at data file {fileno} of "
                               f"{len(self._files)}")
        f = self._files[fileno]
        if f is None:
            f = open(os.path.join(self._dir, self._datafile_names[fileno]), "rb")
            self._files[fileno] = f
        f.seek(offset)
        return f.read(length)

    def _tile(self, level: int, idx: int) -> Optional[np.ndarray]:
        key = (level, idx)
        if key in self._tiles:
            return self._tiles[key]
        rec = self._levels[level].tiles.get(idx)
        if rec is None:
            return None
        from PIL import Image

        arr = np.asarray(
            Image.open(io.BytesIO(self._payload(*rec))).convert("RGB")
        )
        if len(self._tile_order) >= self._tile_cache_max:
            self._tiles.pop(self._tile_order.pop(0), None)
        self._tiles[key] = arr
        self._tile_order.append(key)
        return arr

    # -- region access -----------------------------------------------------

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        """RGB uint8 ``[h, w, 3]``; ``location`` in LEVEL-0 pixels, ``size``
        in LEVEL pixels (OpenSlide semantics). Canvas not covered by any
        stored tile is the level's fill color."""
        lv = self._levels[level]
        c = lv.concat
        x0 = int(location[0] // c)
        y0 = int(location[1] // c)
        w, h = size
        out = np.empty((h, w, 3), np.uint8)
        out[:] = lv.fill_rgb

        # Tiles sit at irregular (camera-position) offsets: intersect the
        # request against every stored tile of the level, vectorized over
        # the tile table (thousands of entries at most per level).
        if not lv.tiles:
            return out
        idxs = np.fromiter(lv.tiles.keys(), np.int64, len(lv.tiles))
        tx = idxs % lv.tiles_across
        ty = idxs // lv.tiles_across
        cam = np.minimum(ty * c, self._images_y - 1) * self._images_x + \
            np.minimum(tx * c, self._images_x - 1)
        px = self._positions[cam, 0] // c
        py = self._positions[cam, 1] // c
        hit = (px < x0 + w) & (px + lv.tile_w > x0) & \
              (py < y0 + h) & (py + lv.tile_h > y0)
        # draw in index order: deterministic painter's order for overlaps
        order = np.argsort(idxs[hit])
        for i, pxx, pyy in zip(idxs[hit][order], px[hit][order], py[hit][order]):
            arr = self._tile(level, int(i))
            if arr is None:
                continue
            sx0 = max(x0 - pxx, 0)
            sy0 = max(y0 - pyy, 0)
            sx1 = min(x0 + w - pxx, arr.shape[1])
            sy1 = min(y0 + h - pyy, arr.shape[0])
            if sx1 <= sx0 or sy1 <= sy0:
                continue
            dx, dy = pxx + sx0 - x0, pyy + sy0 - y0
            out[dy : dy + (sy1 - sy0), dx : dx + (sx1 - sx0)] = \
                arr[sy0:sy1, sx0:sx1]
        return out

    def get_thumbnail(self, max_size: int = 2048) -> np.ndarray:
        lv = self.level_count - 1
        w, h = self.level_dimensions[lv]
        arr = self.read_region((0, 0), lv, (w, h))
        step = max(1, int(np.ceil(max(arr.shape[:2]) / max_size)))
        return arr[::step, ::step]

    @property
    def associated_images(self) -> Dict[str, np.ndarray]:
        """Decoded thumbnail / macro / label payloads (the names OpenSlide
        exposes for mirax slides). Decoded lazily, cached."""
        from PIL import Image

        for name, rec in self._assoc_payloads.items():
            if name not in self._assoc_cache:
                self._assoc_cache[name] = np.asarray(
                    Image.open(io.BytesIO(self._payload(*rec))).convert("RGB")
                )
        return dict(self._assoc_cache)

    def close(self):
        for f in self._files:
            if f is not None:
                f.close()
        self._files = []


# ---- fixture writer ------------------------------------------------------


def write_mirax(
    path: str,
    level0: np.ndarray,
    levels: int = 2,
    tile: int = 64,
    overlap: int = 16,
    mpp: float = 0.2325,
    objective: int = 20,
    fmt: str = "JPEG",
    position: Optional[str] = "vimslide",
    jitter: int = 0,
    absent: Optional[set] = None,
    divisions: int = 1,
    quality: int = 92,
) -> None:
    """Write an RGB image as a MIRAX slide (fixture twin of what OpenSlide's
    mirax driver reads): the ``.mrxs`` preview file plus the data directory
    with ``Slidedat.ini``, ``Index.dat`` (roots -> pointer -> chained data
    pages) and two ``Data*.dat`` payload files (tiles in file 0, the
    position buffer and associated images in file 1, exercising fileno
    routing). Cameras overlap by ``overlap`` px; ``position`` selects the
    camera-position buffer flavor (``"vimslide"`` raw /
    ``"stitching"`` zlib / ``None`` for the nominal-grid fallback);
    ``jitter`` shifts odd columns right by that many px (recorded in the
    buffer AND used for the crops, so reads only reproduce the content if
    the reader honors the buffer); ``absent`` marks ``(cx, cy)`` cameras
    as missing (flag 0, no tile record, fill-color content). Tile pages
    are split in two to exercise index-page chaining."""
    from PIL import Image

    assert level0.ndim == 3 and level0.shape[2] == 3 and level0.dtype == np.uint8
    assert 0 <= jitter < overlap, "jitter must stay under the overlap"
    absent = absent or set()
    h0, w0 = level0.shape[:2]
    step = tile - overlap
    images_x = max(1, -(-(w0 - overlap) // step))
    images_y = max(1, -(-(h0 - overlap) // step))
    fill = (255, 255, 255)

    def cam_pos(cx: int, cy: int) -> Tuple[int, int]:
        return cx * step + (jitter if cx % 2 else 0), cy * step

    # content canvas: the source padded with fill to the camera extent,
    # absent cameras painted over with fill
    ext_w = cam_pos(images_x - 1, 0)[0] + tile
    ext_h = cam_pos(0, images_y - 1)[1] + tile
    canvas = np.empty((ext_h, ext_w, 3), np.uint8)
    canvas[:] = fill
    canvas[:h0, :w0] = level0
    for cx, cy in absent:
        x, y = cam_pos(cx, cy)
        canvas[y : y + tile, x : x + tile] = fill

    def encode(img: np.ndarray) -> bytes:
        b = io.BytesIO()
        pil_fmt = {"JPEG": "JPEG", "PNG": "PNG", "BMP24": "BMP", "BMP": "BMP"}[fmt]
        kw = {"quality": quality} if pil_fmt == "JPEG" else {}
        Image.fromarray(img).save(b, pil_fmt, **kw)
        return b.getvalue()

    # -- per-level stored images ------------------------------------------
    # level L: concat c = 2**L; one stored image per c x c camera block =
    # the union crop (spacing*(c-1) + tile wide) box-downsampled by c.
    level_tiles: List[Dict[int, bytes]] = []
    level_geo: List[Tuple[int, int, int]] = []  # (tile_w, tile_h, concat)
    for lv in range(levels):
        c = 2 ** lv
        tiles_across = -(-images_x // c)
        tiles_down = -(-images_y // c)
        uw, uh = step * (c - 1) + tile, step * (c - 1) + tile
        uw_p, uh_p = -(-uw // c) * c, -(-uh // c) * c
        tiles: Dict[int, bytes] = {}
        for ty in range(tiles_down):
            for tx in range(tiles_across):
                cams = [
                    (cx, cy)
                    for cy in range(ty * c, min((ty + 1) * c, images_y))
                    for cx in range(tx * c, min((tx + 1) * c, images_x))
                ]
                if all(cc in absent for cc in cams):
                    continue
                x, y = cam_pos(tx * c, ty * c)
                u = np.empty((uh_p, uw_p, 3), np.uint8)
                u[:] = fill
                part = canvas[y : y + uh, x : x + uw]
                u[: part.shape[0], : part.shape[1]] = part
                if c > 1:
                    u = (
                        u.reshape(uh_p // c, c, uw_p // c, c, 3)
                        .mean((1, 3))
                        .astype(np.uint8)
                    )
                tiles[ty * tiles_across + tx] = encode(u)
        level_tiles.append(tiles)
        level_geo.append((uw_p // c, uh_p // c, c))

    # -- data files --------------------------------------------------------
    base, _ = os.path.splitext(path)
    os.makedirs(base, exist_ok=True)
    data0 = io.BytesIO()
    tile_recs: List[Dict[int, Tuple[int, int, int]]] = []
    for tiles in level_tiles:
        recs: Dict[int, Tuple[int, int, int]] = {}
        for idx, payload in tiles.items():
            recs[idx] = (data0.tell(), len(payload), 0)
            data0.write(payload)
        tile_recs.append(recs)

    data1 = io.BytesIO()
    n_cam = images_x * images_y
    pos_buf = bytearray()
    for cy in range(images_y):
        for cx in range(images_x):
            x, y = cam_pos(cx, cy)
            pos_buf += struct.pack(
                "<Bii", 0 if (cx, cy) in absent else 1, x, y
            )
    if position == "stitching":
        pos_payload = zlib.compress(bytes(pos_buf))
    else:
        pos_payload = bytes(pos_buf)
    pos_rec = (data1.tell(), len(pos_payload), 1)
    data1.write(pos_payload)

    assoc_recs: Dict[str, Tuple[int, int, int]] = {}
    sstep = max(1, w0 // 64)
    for name in ("thumbnail", "macro", "label"):
        b = io.BytesIO()
        Image.fromarray(level0[::sstep, ::sstep]).save(b, "JPEG", quality=85)
        payload = b.getvalue()
        assoc_recs[name] = (data1.tell(), len(payload), 1)
        data1.write(payload)

    with open(os.path.join(base, "Data0000.dat"), "wb") as f:
        f.write(data0.getvalue())
    with open(os.path.join(base, "Data0001.dat"), "wb") as f:
        f.write(data1.getvalue())

    # -- Slidedat.ini ------------------------------------------------------
    version, slide_id = "1.9", "FIXTURE-0001"
    nonhier: List[Tuple[str, List[str]]] = [
        ("Scan data layer", [
            "ScanDataLayer_SlideThumbnail",
            "ScanDataLayer_SlidePreview",
            "ScanDataLayer_SlideBarcode",
        ]),
    ]
    if position == "vimslide":
        nonhier.append(("VIMSLIDE_POSITION_BUFFER",
                        ["VIMSLIDE_POSITION_BUFFER"]))
    elif position == "stitching":
        nonhier.append(("StitchingIntensityLayer",
                        ["StitchingIntensityLevel"]))

    lines = [
        "[GENERAL]",
        f"SLIDE_VERSION = {version}",
        f"SLIDE_ID = {slide_id}",
        f"IMAGENUMBER_X = {images_x}",
        f"IMAGENUMBER_Y = {images_y}",
        f"OBJECTIVE_MAGNIFICATION = {objective}",
        f"CameraImageDivisionsPerSide = {divisions}",
        "",
        "[HIERARCHICAL]",
        "HIER_COUNT = 1",
        f"NONHIER_COUNT = {len(nonhier)}",
        "INDEXFILE = Index.dat",
        f"HIER_0_NAME = {_ZOOM_HIER_NAME}",
        f"HIER_0_COUNT = {levels}",
    ]
    for lv in range(levels):
        lines += [
            f"HIER_0_VAL_{lv} = ZoomLevel_{lv}",
            f"HIER_0_VAL_{lv}_SECTION = LAYER_0_LEVEL_{lv}_SECTION",
        ]
    for i, (name, vals) in enumerate(nonhier):
        lines += [f"NONHIER_{i}_NAME = {name}", f"NONHIER_{i}_COUNT = {len(vals)}"]
        lines += [f"NONHIER_{i}_VAL_{j} = {v}" for j, v in enumerate(vals)]
    lines += [
        "",
        "[DATAFILE]",
        "FILE_COUNT = 2",
        "FILE_0 = Data0000.dat",
        "FILE_1 = Data0001.dat",
    ]
    for lv in range(levels):
        tw, th, c = level_geo[lv]
        lines += [
            "",
            f"[LAYER_0_LEVEL_{lv}_SECTION]",
            f"IMAGE_FORMAT = {fmt}",
            f"DIGITIZER_WIDTH = {tw}",
            f"DIGITIZER_HEIGHT = {th}",
            f"IMAGE_CONCAT_FACTOR = {c}",
            f"OVERLAP_X = {overlap / c:g}",
            f"OVERLAP_Y = {overlap / c:g}",
            "IMAGE_FILL_COLOR_BGR = 16777215",
            f"MICROMETER_PER_PIXEL_X = {mpp * c:g}",
            f"MICROMETER_PER_PIXEL_Y = {mpp * c:g}",
        ]
    with open(os.path.join(base, _SLIDEDAT), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")

    # -- Index.dat ---------------------------------------------------------
    n_hier_vals = levels
    n_nonhier_vals = sum(len(v) for _, v in nonhier)
    out = io.BytesIO()
    out.write(version.encode("ascii"))
    out.write(slide_id.encode("ascii"))
    roots_at = out.tell()
    out.write(struct.pack("<ii", 0, 0))  # patched below
    hier_root = out.tell()
    out.write(b"\x00" * 4 * n_hier_vals)
    nonhier_root = out.tell()
    out.write(b"\x00" * 4 * n_nonhier_vals)

    def write_pages(entries: List[Tuple[int, int, int, int]]) -> int:
        """Chained data pages (two pages when >1 entry, to exercise the
        next-page pointer); returns the pointer-to-page-pointer offset."""
        ptr_at = out.tell()
        out.write(struct.pack("<i", 0))
        halves = [entries]
        if len(entries) > 1:
            halves = [entries[: len(entries) // 2], entries[len(entries) // 2 :]]
        page_ptrs = []
        for half in halves:
            page_ptrs.append(out.tell())
            out.write(struct.pack("<ii", len(half), 0))
            for e in half:
                out.write(struct.pack("<4i", *e))
        buf = out.getbuffer()
        struct.pack_into("<i", buf, ptr_at, page_ptrs[0])
        for a, b in zip(page_ptrs, page_ptrs[1:]):
            struct.pack_into("<i", buf, a + 4, b)
        del buf
        return ptr_at

    buf_patch: List[Tuple[int, int]] = []
    for lv in range(levels):
        ents = [
            (idx, off, ln, fn)
            for idx, (off, ln, fn) in sorted(tile_recs[lv].items())
        ]
        buf_patch.append((hier_root + 4 * lv, write_pages(ents)))
    rec = 0
    for _, vals in nonhier:
        for v in vals:
            if v in _ASSOC_VALS:
                r = assoc_recs[_ASSOC_VALS[v]]
                ptr = write_pages([(0, r[0], r[1], r[2])])
            else:
                ptr = write_pages([(0, pos_rec[0], pos_rec[1], pos_rec[2])])
            buf_patch.append((nonhier_root + 4 * rec, ptr))
            rec += 1
    data = bytearray(out.getvalue())
    struct.pack_into("<ii", data, roots_at, hier_root, nonhier_root)
    for at, ptr in buf_patch:
        struct.pack_into("<i", data, at, ptr)
    with open(os.path.join(base, "Index.dat"), "wb") as f:
        f.write(data)

    # the .mrxs file itself is just a raster preview of the slide
    Image.fromarray(level0[::sstep, ::sstep]).save(path, "JPEG", quality=85)
