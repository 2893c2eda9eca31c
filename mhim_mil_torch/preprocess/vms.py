"""Hamamatsu VMS reader — multi-file JPEG mosaic, pure Python.

A copy of ``mhim_mil_tpu/preprocess/vms.py``.

The reference opens VMS slides through OpenSlide's ``hamamatsu`` driver
(`CLAM/wsi_core/WholeSlideImage.py:22-90` calls ``openslide.open_slide``
unconditionally). A ``.vms`` file is a Windows-INI key/value listing
(section ``[Virtual Microscope Specimen]``) that references sibling
files: a grid of ``NoJpegColumns x NoJpegRows`` whole-scan JPEGs
(``ImageFile`` / ``ImageFile(col,row)``), a low-resolution ``MapFile``,
a ``MacroImage`` photo, and an ``OptimisationFile`` of precomputed
restart-marker offsets. This module implements the single-focal-plane
subset OpenSlide documents:

  * level 0 is the column-major mosaic of the grid JPEGs (cells in one
    column share a width, cells in one row share a height); random
    region access uses the same restart-marker band decode as the NDPI
    reader (:class:`~mhim_mil_torch.preprocess.ndpi._JpegIndex` — the
    optimisation file is redundant with self-indexing the entropy
    stream, so it is ignored);
  * levels 1/2/3 are the libjpeg DCT scale denominators 2/4/8 applied
    to the same JPEGs (what OpenSlide exposes for VMS slides) — decoded
    through PIL's ``draft`` mode on the synthesized band JPEGs;
  * ``PhysicalWidth`` / ``PhysicalHeight`` are the specimen size in
    nanometres → ``openslide.mpp-x/y``; all scalar INI keys are kept
    under ``hamamatsu.<Key>``; the map and macro images are the
    ``map`` / ``macro`` associated images.

Alignment subset: interior grid-cell widths and heights must be
multiples of 8 px so the DCT-scaled cells tile exactly (real scanners
emit MCU-aligned cells). Out of scope, raised as named
``UnsupportedVendorFormatError`` with a conversion recipe: ``NoLayers``
!= 1 (multiple focal planes), unaligned mosaics, missing referenced
files, and the raw-NGR ``.vmu`` sibling format (stays named-unsupported
in ``tiff.open_slide``).
"""

from __future__ import annotations

import configparser
import io
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ndpi import _WHOLE_PAGE_MAX_PIXELS, _JpegIndex
from .tiff import UnsupportedTiffError, UnsupportedVendorFormatError, _CONVERT_HINT

_SECTION = "Virtual Microscope Specimen"
_DOWNSAMPLES = (1, 2, 4, 8)  # libjpeg scale denominators, as OpenSlide exposes


def _vms_error(msg: str) -> UnsupportedVendorFormatError:
    return UnsupportedVendorFormatError(f"Hamamatsu VMS: {msg}; {_CONVERT_HINT}")


class _Cell:
    """One grid JPEG: lazy bytes + restart-marker index."""

    def __init__(self, path: str):
        self.path = path
        self._data: Optional[bytes] = None
        self._jpeg: Optional[_JpegIndex] = None
        self.width = 0
        self.height = 0

    def data(self) -> bytes:
        if self._data is None:
            with open(self.path, "rb") as f:
                self._data = f.read()
        return self._data

    def index(self) -> _JpegIndex:
        if self._jpeg is None:
            try:
                self._jpeg = _JpegIndex(self.data())
            except UnsupportedTiffError as e:
                raise _vms_error(f"{os.path.basename(self.path)}: {e}")
            self.width, self.height = self._jpeg.w, self._jpeg.h
        return self._jpeg


class VmsSlide:
    """OpenSlide-like random access over a Hamamatsu ``.vms`` slide.

    Same API surface as :class:`~mhim_mil_torch.preprocess.tiff.PyramidalTiff`
    (``level_count`` / ``dimensions`` / ``level_dimensions`` /
    ``level_downsamples`` / ``read_region`` with level-0 location /
    ``get_thumbnail`` / ``properties`` / ``associated_images``), which is
    the surface the reference consumes through openslide
    (CLAM/dataset_modules/dataset_h5.py:79-84).
    """

    def __init__(self, path: str, band_cache: int = 8):
        ini = configparser.ConfigParser(interpolation=None, strict=False)
        ini.optionxform = str
        with open(path, "r", encoding="utf-8-sig", errors="replace") as f:
            ini.read_string(f.read())
        if _SECTION not in ini:
            raise _vms_error(f"no [{_SECTION}] section in the .vms file")
        sect = ini[_SECTION]
        base = os.path.dirname(os.path.abspath(path))

        layers = sect.getint("NoLayers", fallback=1)
        if layers != 1:
            raise _vms_error(
                f"NoLayers={layers} (multiple focal planes) is not supported"
            )
        self._cols = sect.getint("NoJpegColumns", fallback=1)
        self._rows = sect.getint("NoJpegRows", fallback=1)

        def resolve(name: str) -> str:
            p = os.path.join(base, name.strip())
            if not os.path.isfile(p):
                raise _vms_error(f"referenced file {name.strip()!r} is missing")
            return p

        self._grid: List[List[_Cell]] = [
            [None] * self._cols for _ in range(self._rows)  # type: ignore
        ]
        for key, val in sect.items():
            m = re.fullmatch(r"ImageFile(?:\((\d+),(\d+)\))?", key)
            if not m:
                continue
            c = int(m.group(1)) if m.group(1) else 0
            r = int(m.group(2)) if m.group(2) else 0
            if not (0 <= c < self._cols and 0 <= r < self._rows):
                raise _vms_error(f"{key} outside the {self._cols}x{self._rows} grid")
            self._grid[r][c] = _Cell(resolve(val))
        for r in range(self._rows):
            for c in range(self._cols):
                if self._grid[r][c] is None:
                    raise _vms_error(f"grid cell ({c},{r}) has no ImageFile entry")

        self._assoc_paths: Dict[str, str] = {}
        if sect.get("MacroImage"):
            self._assoc_paths["macro"] = resolve(sect["MacroImage"])
        if sect.get("MapFile"):
            self._assoc_paths["map"] = resolve(sect["MapFile"])

        # mosaic geometry (reads each cell's JPEG header once)
        col_w = [self._grid[0][c].index().w for c in range(self._cols)]
        row_h = [self._grid[r][0].index().h for r in range(self._rows)]
        for r in range(self._rows):
            for c in range(self._cols):
                info = self._grid[r][c].index()
                if info.w != col_w[c] or info.h != row_h[r]:
                    raise _vms_error(
                        f"grid cell ({c},{r}) is {info.w}x{info.h}, its "
                        f"column/row is {col_w[c]}x{row_h[r]}"
                    )
        if any(w % 8 for w in col_w[:-1]) or any(h % 8 for h in row_h[:-1]):
            raise _vms_error(
                "interior mosaic cells are not 8-px aligned, the DCT-scaled "
                "levels cannot tile exactly"
            )
        self._col_x = np.concatenate([[0], np.cumsum(col_w)])
        self._row_y = np.concatenate([[0], np.cumsum(row_h)])
        w0, h0 = int(self._col_x[-1]), int(self._row_y[-1])

        self.level_count = len(_DOWNSAMPLES)
        self.level_downsamples = [float(d) for d in _DOWNSAMPLES]
        self.level_dimensions = [
            (-(-w0 // d), -(-h0 // d)) for d in _DOWNSAMPLES
        ]
        self.dimensions = (w0, h0)

        self.properties: Dict[str, str] = {"openslide.vendor": "hamamatsu"}
        pw = sect.getfloat("PhysicalWidth", fallback=0.0)  # nanometres
        ph = sect.getfloat("PhysicalHeight", fallback=0.0)
        if pw and ph:
            self.properties["openslide.mpp-x"] = f"{pw / 1000.0 / w0:.6f}"
            self.properties["openslide.mpp-y"] = f"{ph / 1000.0 / h0:.6f}"
        if sect.get("SourceLens"):
            self.properties["openslide.objective-power"] = sect["SourceLens"].strip()
        for key, val in sect.items():
            if key != "OptimisationFile" and not key.startswith("ImageFile"):
                self.properties.setdefault(f"hamamatsu.{key}", val.strip())

        self._band_cache_max = band_cache
        self._bands: Dict[Tuple[int, int, int, int, int], np.ndarray] = {}
        self._band_order: List[Tuple[int, int, int, int, int]] = []
        self._assoc_cache: Dict[str, np.ndarray] = {}

    # -- scaled band decode ------------------------------------------------

    def _decode_scaled(self, data: bytes, d: int, w: int, h: int) -> np.ndarray:
        """Decode a JPEG at 1/d via libjpeg DCT scaling (PIL draft mode);
        the result is exactly ``ceil(w/d) x ceil(h/d)``."""
        from PIL import Image

        im = Image.open(io.BytesIO(data))
        want = (-(-w // d), -(-h // d))
        if d > 1:
            # request FLOOR sizes: PIL's draft picks the largest denominator
            # whose floor-scaled size still covers the request, so asking for
            # the ceil would silently fall back to a smaller scale whenever
            # d does not divide the dimension; the decoded size is the ceil.
            im.draft("RGB", (max(1, w // d), max(1, h // d)))
        arr = np.asarray(im.convert("RGB"))
        if arr.shape[:2] != (want[1], want[0]):
            raise _vms_error(
                f"DCT-scaled decode returned {arr.shape[1]}x{arr.shape[0]}, "
                f"expected {want[0]}x{want[1]}"
            )
        return arr

    def _cell_band(self, r: int, c: int, u0: int, u1: int, d: int) -> Tuple[np.ndarray, int]:
        """Scaled pixels of cell (c,r) band units [u0,u1); returns
        (array, band y-origin in cell-level pixels)."""
        cell = self._grid[r][c]
        info = cell.index()
        if not info.rows_per_unit:
            # no usable restart alignment: whole-cell decode under a guard
            if info.w * info.h > _WHOLE_PAGE_MAX_PIXELS:
                raise _vms_error(
                    f"cell ({c},{r}) is {info.w}x{info.h} with no MCU-row-"
                    "aligned restart markers, too large to decode whole"
                )
            key = (r, c, -1, -1, d)
            if key not in self._bands:
                self._put_band(key, self._decode_scaled(cell.data(), d, info.w, info.h))
            return self._bands[key], 0
        unit_px = info.rows_per_unit * info.mcu_h
        key = (r, c, u0, u1, d)
        if key not in self._bands:
            jpeg, y0 = info.band_jpeg(cell.data(), u0, u1)
            band_h = min(info.h - y0, (u1 - u0) * unit_px)
            self._put_band(key, self._decode_scaled(jpeg, d, info.w, band_h))
        return self._bands[key], (u0 * unit_px) // d

    def _put_band(self, key, arr: np.ndarray) -> None:
        if len(self._band_order) >= self._band_cache_max:
            self._bands.pop(self._band_order.pop(0), None)
        self._bands[key] = arr
        self._band_order.append(key)

    # -- region access -----------------------------------------------------

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        """RGB uint8 ``[h, w, 3]``; ``location`` in LEVEL-0 pixels, ``size``
        in LEVEL pixels (OpenSlide semantics). Out-of-bounds is zero-filled."""
        d = _DOWNSAMPLES[level]
        x0, y0 = int(location[0] // d), int(location[1] // d)
        w, h = size
        out = np.zeros((h, w, 3), np.uint8)
        lw, lh = self.level_dimensions[level]
        x1, y1 = min(x0 + w, lw), min(y0 + h, lh)
        if x0 >= lw or y0 >= lh or x1 <= 0 or y1 <= 0:
            return out
        cx0, cy0 = max(x0, 0), max(y0, 0)

        # interior cell edges are 8-px aligned, so level-space edges are exact
        col_x = self._col_x // d
        row_y = self._row_y // d
        # clamp to the grid: when d does not divide the mosaic size, the
        # level's last (ceil) pixel lands past the floor-scaled final edge
        c0 = int(np.searchsorted(col_x, cx0, "right")) - 1
        c1 = min(int(np.searchsorted(col_x, x1 - 1, "right")) - 1, self._cols - 1)
        r0 = int(np.searchsorted(row_y, cy0, "right")) - 1
        r1 = min(int(np.searchsorted(row_y, y1 - 1, "right")) - 1, self._rows - 1)
        for r in range(r0, r1 + 1):
            for c in range(c0, c1 + 1):
                info = self._grid[r][c].index()
                # request window in cell-level coordinates
                ax0 = max(cx0 - int(col_x[c]), 0)
                ay0 = max(cy0 - int(row_y[r]), 0)
                ax1 = min(x1 - int(col_x[c]), -(-info.w // d))
                ay1 = min(y1 - int(row_y[r]), -(-info.h // d))
                if ax1 <= ax0 or ay1 <= ay0:
                    continue
                if info.rows_per_unit:
                    unit_px_l = info.rows_per_unit * info.mcu_h // d
                    u0 = ay0 // unit_px_l if unit_px_l else 0
                    u1 = (ay1 - 1) // unit_px_l + 1 if unit_px_l else 1
                else:
                    u0 = u1 = 0
                band, by0 = self._cell_band(r, c, u0, u1, d)
                src = band[ay0 - by0 : ay1 - by0, ax0:ax1]
                dy = int(row_y[r]) + ay0 - y0
                dx = int(col_x[c]) + ax0 - x0
                out[dy : dy + src.shape[0], dx : dx + src.shape[1]] = src
        return out

    def get_thumbnail(self, max_size: int = 2048) -> np.ndarray:
        lv = self.level_count - 1
        w, h = self.level_dimensions[lv]
        arr = self.read_region((0, 0), lv, (w, h))
        step = max(1, int(np.ceil(max(arr.shape[:2]) / max_size)))
        return arr[::step, ::step]

    @property
    def associated_images(self) -> Dict[str, np.ndarray]:
        """Decoded macro / map photos (the names OpenSlide exposes for
        hamamatsu slides). Decoded lazily, cached."""
        from PIL import Image

        for name, p in self._assoc_paths.items():
            if name not in self._assoc_cache:
                self._assoc_cache[name] = np.asarray(
                    Image.open(p).convert("RGB")
                )
        return dict(self._assoc_cache)

    def close(self):
        pass  # all file handles are opened per read


# ---- fixture writer ------------------------------------------------------


def write_vms(
    path: str,
    level0: np.ndarray,
    cols: int = 1,
    rows: int = 1,
    mpp: float = 0.23,
    lens: float = 40.0,
    quality: int = 92,
    restart_rows: int = 1,
    no_layers: int = 1,
) -> None:
    """Write an RGB image as a Hamamatsu VMS slide (fixture twin of what
    OpenSlide's hamamatsu driver reads): the ``.vms`` INI plus sibling
    grid JPEGs (restart markers every ``restart_rows`` MCU rows, 4:4:4 so
    the band decoder sees 8-px MCUs), a 1/8 map image and a macro photo.
    Interior cell edges are cut at multiples of 8 px (the alignment the
    reader requires). ``restart_rows=0`` writes monolithic entropy
    streams to exercise the whole-cell fallback."""
    from PIL import Image

    assert level0.ndim == 3 and level0.shape[2] == 3 and level0.dtype == np.uint8
    h0, w0 = level0.shape[:2]
    base = os.path.dirname(os.path.abspath(path))
    stem = os.path.splitext(os.path.basename(path))[0]

    col_w = [(w0 // cols) // 8 * 8] * (cols - 1)
    col_w.append(w0 - sum(col_w))
    row_h = [(h0 // rows) // 8 * 8] * (rows - 1)
    row_h.append(h0 - sum(row_h))
    assert all(col_w) and all(row_h), "image too small for the grid"

    def save_jpeg(img: np.ndarray, name: str, restarts: bool) -> str:
        kw = {"quality": quality, "subsampling": 0}
        if restarts and restart_rows:
            kw["restart_marker_rows"] = restart_rows
        Image.fromarray(img).save(os.path.join(base, name), "JPEG", **kw)
        return name

    lines = [f"[{_SECTION}]", f"NoLayers={no_layers}",
             f"NoJpegColumns={cols}", f"NoJpegRows={rows}"]
    y = 0
    for r in range(rows):
        x = 0
        for c in range(cols):
            cell = level0[y : y + row_h[r], x : x + col_w[c]]
            name = save_jpeg(cell, f"{stem}_x{c}_y{r}.jpg", True)
            key = "ImageFile" if (c, r) == (0, 0) else f"ImageFile({c},{r})"
            lines.append(f"{key}={name}")
            x += col_w[c]
        y += row_h[r]

    lines.append("MapFile=" + save_jpeg(level0[::8, ::8], f"{stem}_map.jpg", False))
    lines.append(
        "MacroImage=" + save_jpeg(level0[:: max(1, h0 // 48), :: max(1, w0 // 64)],
                                  f"{stem}_macro.jpg", False)
    )
    lines += [
        f"PhysicalWidth={int(round(w0 * mpp * 1000))}",   # nanometres
        f"PhysicalHeight={int(round(h0 * mpp * 1000))}",
        f"SourceLens={lens:g}",
        "AuthCode=FIXTURE",
    ]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
