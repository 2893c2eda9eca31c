"""Hamamatsu NDPI reader — TIFF-with-quirks, pure Python.

A copy of ``mhim_mil_tpu/preprocess/ndpi.py``.

The reference opens NDPI slides through OpenSlide's `hamamatsu` driver
(`CLAM/wsi_core/WholeSlideImage.py:22-90` calls ``openslide.open_slide``
unconditionally). NDPI is a classic little-endian TIFF container that
violates the spec in scanner-specific ways; this module implements the
subset OpenSlide documents for single-file ``.ndpi``:

  * every IFD carries the private marker tag 65420; tag 65421
    (``SourceLens``) identifies what the page is — a positive value is a
    pyramid magnification, ``-1`` is the macro photo and ``-2`` the slide
    map. Pages with nonzero Z offset (tag 65424) are extra focal planes
    and are skipped, exactly like OpenSlide's default plane selection.
  * pages are NOT tiled: each page is one whole-page JPEG stream stored
    as a single strip (``RowsPerStrip == ImageLength``). Random region
    access therefore needs partial JPEG decode: NDPI scanners emit
    restart markers (DRI) aligned to MCU rows, and this reader indexes
    the entropy stream's RSTn boundaries once per page, then synthesizes
    a minimal valid JPEG for just the MCU-row band a ``read_region``
    touches (patched SOF height + renumbered restart markers). Bands are
    LRU-cached. Pages without usable restart alignment fall back to a
    whole-page decode below a memory guard.
  * ``XResolution`` is pixels/cm → ``openslide.mpp-x/y``; the largest
    ``SourceLens`` → ``openslide.objective-power``.

Out of scope, raised as named ``UnsupportedVendorFormatError`` with a
conversion recipe (never a generic parse error): files > 4 GiB (NDPI
keeps 32-bit IFD offsets and lets them wrap — recovering the high bits
needs OpenSlide's heuristics), progressive-JPEG pages, and monolithic
pages too large to decode whole when restart alignment is absent.
Multi-file Hamamatsu formats (.vms/.vmu) stay named-unsupported in
``tiff.open_slide``.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .tiff import (
    UnsupportedTiffError,
    UnsupportedVendorFormatError,
    _CONVERT_HINT,
    _COMP,
    _H,
    _PHOTO,
    _ROWS_PER_STRIP,
    _SPP,
    _STRIP_CNT,
    _STRIP_OFF,
    _TYPE_FMT,
    _TYPE_SIZE,
    _W,
    _read_ifd,
)

# NDPI private tags (ids documented by OpenSlide's hamamatsu driver and
# tifffile's NDPI notes).
_NDPI_MARKER = 65420  # present in every NDPI IFD (format version)
_SOURCE_LENS = 65421  # magnification; -1 = macro photo, -2 = slide map
_X_OFFSET = 65422  # nm from slide centre (kept as a property)
_Y_OFFSET = 65423
_Z_OFFSET = 65424  # focal plane; pyramid lives at z == 0
_XRES, _YRES, _RESUNIT = 282, 283, 296
_BITS = 258


def _num(tags: Dict[int, tuple], tag: int, default: Optional[float] = None) -> Optional[float]:
    """First value of a tag as float, across the numeric TIFF types
    (NDPI writes SourceLens as FLOAT on some scanner generations and
    SRATIONAL on others)."""
    v = tags.get(tag)
    if not v:
        return default
    x = v[0]
    if isinstance(x, (int, float)):
        return float(x)
    return default


class _NdpiPage:
    def __init__(self, tags: Dict[int, tuple], file_size: int):
        self.width = tags[_W][0]
        self.height = tags[_H][0]
        self.comp = tags.get(_COMP, (1,))[0]
        self.lens = _num(tags, _SOURCE_LENS, 0.0)
        self.z = _num(tags, _Z_OFFSET, 0.0)
        offs = tags.get(_STRIP_OFF, ())
        cnts = tags.get(_STRIP_CNT, ())
        if not offs:
            raise UnsupportedTiffError("NDPI page without strip offsets")
        # NDPI stores the whole page as ONE JPEG strip; some writers leave
        # StripByteCounts zero — the stream then runs to the next strip or
        # EOF (OpenSlide tolerates the same).
        self.offset = offs[0]
        self.count = cnts[0] if cnts and cnts[0] else file_size - offs[0]
        self.tags = tags
        # lazy JPEG structure index (restart-marker band table)
        self._jpeg: Optional[_JpegIndex] = None


class _JpegIndex:
    """Structure of one whole-page JPEG: header span, SOF geometry, and —
    when the restart interval aligns with MCU rows — the byte ranges of
    each restart segment so row bands can be decoded independently."""

    def __init__(self, data: bytes):
        self.progressive = False
        self.dri = 0
        self.sof_off = -1
        n = len(data)
        if n < 4 or data[:2] != b"\xff\xd8":
            raise UnsupportedTiffError("NDPI strip is not a JPEG stream")
        pos = 2
        entropy = -1
        while pos < n - 1:
            if data[pos] != 0xFF:
                raise UnsupportedTiffError("malformed JPEG marker stream")
            m = data[pos + 1]
            if m == 0xD8 or m == 0x01 or 0xD0 <= m <= 0xD7:
                pos += 2
                continue
            (seg_len,) = struct.unpack(">H", data[pos + 2 : pos + 4])
            if m in (0xC0, 0xC1, 0xC2):
                self.progressive = m == 0xC2
                self.sof_off = pos
                self.h, self.w = struct.unpack(">HH", data[pos + 5 : pos + 9])
                nc = data[pos + 9]
                hs = [data[pos + 10 + 3 * c + 1] >> 4 for c in range(nc)]
                vs = [data[pos + 10 + 3 * c + 1] & 0xF for c in range(nc)]
                self.mcu_w = 8 * max(hs)
                self.mcu_h = 8 * max(vs)
            elif m == 0xDD:
                (self.dri,) = struct.unpack(">H", data[pos + 4 : pos + 6])
            elif m == 0xDA:
                entropy = pos + 2 + seg_len
                break
            pos += 2 + seg_len
        if entropy < 0 or self.sof_off < 0:
            raise UnsupportedTiffError("JPEG stream without SOS/SOF")
        self.header_end = entropy
        # index restart segments: pure-entropy (start, end) ranges
        segs: List[Tuple[int, int]] = []
        start = entropy
        pos = entropy
        while pos < n - 1:
            if data[pos] == 0xFF:
                m = data[pos + 1]
                if 0xD0 <= m <= 0xD7:
                    segs.append((start, pos))
                    start = pos + 2
                    pos += 2
                    continue
                if m == 0xD9:
                    segs.append((start, pos))
                    break
            pos += 1
        else:
            segs.append((start, n))
        self.segments = segs
        # band geometry: decodable row-band unit, if restart alignment holds
        self.mcus_x = -(-self.w // self.mcu_w) if self.w else 0
        self.mcu_rows = -(-self.h // self.mcu_h) if self.h else 0
        self.rows_per_unit = 0  # 0 → no band decode
        self.segs_per_unit = 0
        if self.progressive or not self.dri or not self.mcus_x:
            return
        if self.mcus_x % self.dri == 0:
            # one MCU row spans an integer number of restart segments
            self.rows_per_unit = 1
            self.segs_per_unit = self.mcus_x // self.dri
        elif self.dri % self.mcus_x == 0:
            # one restart segment spans an integer number of MCU rows
            self.rows_per_unit = self.dri // self.mcus_x
            self.segs_per_unit = 1
        n_units = -(-self.mcu_rows // self.rows_per_unit) if self.rows_per_unit else 0
        if n_units and len(segs) != n_units * self.segs_per_unit:
            self.rows_per_unit = 0  # truncated/odd stream: fall back

    def band_jpeg(self, data: bytes, unit0: int, unit1: int) -> Tuple[bytes, int]:
        """Synthesize a standalone JPEG for units [unit0, unit1): header
        with SOF height patched to the band, entropy segments re-joined
        with renumbered RSTn, EOI appended. Returns (jpeg, y_origin_px)."""
        assert self.rows_per_unit
        r0 = unit0 * self.rows_per_unit
        r1 = min(unit1 * self.rows_per_unit, self.mcu_rows)
        band_h = min(self.h - r0 * self.mcu_h, (r1 - r0) * self.mcu_h)
        head = bytearray(data[: self.header_end])
        head[self.sof_off + 5 : self.sof_off + 7] = struct.pack(">H", band_h)
        s0 = unit0 * self.segs_per_unit
        s1 = min(unit1 * self.segs_per_unit, len(self.segments))
        parts = [bytes(head)]
        for k, (a, b) in enumerate(self.segments[s0:s1]):
            if k:
                parts.append(bytes((0xFF, 0xD0 + ((k - 1) & 7))))
            parts.append(data[a:b])
        parts.append(b"\xff\xd9")
        return b"".join(parts), r0 * self.mcu_h


# Whole-page decode guard: above this many pixels a page without restart
# alignment is refused with a conversion hint instead of silently eating
# gigabytes (also stays under PIL's decompression-bomb threshold).
_WHOLE_PAGE_MAX_PIXELS = 64 << 20


class NdpiSlide:
    """OpenSlide-like random access over a Hamamatsu ``.ndpi`` file.

    Same API surface as :class:`~mhim_mil_torch.preprocess.tiff.PyramidalTiff`
    (``level_count`` / ``dimensions`` / ``level_dimensions`` /
    ``level_downsamples`` / ``read_region`` with level-0 location /
    ``get_thumbnail`` / ``properties`` / ``associated_images``), which is
    the surface the reference consumes through openslide
    (CLAM/dataset_modules/dataset_h5.py:79-84).
    """

    def __init__(self, path: str, band_cache: int = 8):
        self._f = open(path, "rb")
        try:
            self._parse(path)
        except Exception:
            self._f.close()
            raise
        self._band_cache_max = band_cache
        self._bands: Dict[Tuple[int, int, int], Tuple[np.ndarray, int]] = {}
        self._band_order: List[Tuple[int, int, int]] = []
        self._pages_whole: Dict[int, np.ndarray] = {}
        self._assoc_cache: Dict[str, np.ndarray] = {}

    def _parse(self, path: str) -> None:
        size = os.fstat(self._f.fileno()).st_size
        if size > 0xFFFFFFFF:
            raise UnsupportedVendorFormatError(
                "Hamamatsu NDPI over 4 GiB: the format wraps its 32-bit IFD "
                "offsets past 4 GiB and recovering them needs OpenSlide's "
                f"scan heuristics; {_CONVERT_HINT}"
            )
        head = self._f.read(4)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            raise UnsupportedTiffError("not a TIFF/NDPI file")
        (magic,) = struct.unpack(bo + "H", head[2:4])
        if magic != 42:
            raise UnsupportedTiffError("NDPI is always classic TIFF (magic 42)")
        (off,) = struct.unpack(bo + "I", self._f.read(4))
        raw: List[Dict[int, tuple]] = []
        while off:
            tags, off = _read_ifd(self._f, off, bo)
            if _W in tags and _H in tags:
                raw.append(tags)
        if not raw or not any(_NDPI_MARKER in t for t in raw):
            raise UnsupportedTiffError("no NDPI marker tag (65420) present")

        pages = [_NdpiPage(t, size) for t in raw]
        levels = [p for p in pages if p.lens and p.lens > 0 and p.z == 0]
        if not levels:
            raise UnsupportedTiffError("NDPI without pyramid pages at z=0")
        levels.sort(key=lambda p: -p.width)
        self._levels = levels
        self._assoc_pages: Dict[str, _NdpiPage] = {}
        for p in pages:
            if p.lens == -1.0:
                self._assoc_pages.setdefault("macro", p)
            elif p.lens == -2.0:
                self._assoc_pages.setdefault("map", p)

        self.level_count = len(levels)
        self.level_dimensions = [(p.width, p.height) for p in levels]
        self.dimensions = self.level_dimensions[0]
        w0 = levels[0].width
        self.level_downsamples = [w0 / p.width for p in levels]

        self.properties: Dict[str, str] = {"openslide.vendor": "hamamatsu"}
        base = levels[0]
        lens = max(p.lens for p in levels)
        self.properties["openslide.objective-power"] = (
            f"{lens:g}" if lens else ""
        )
        xres = _num(base.tags, _XRES)
        unit = base.tags.get(_RESUNIT, (2,))[0]
        if xres:
            # NDPI writes pixels/cm (ResolutionUnit 3); inches (2) converted
            per_cm = xres if unit == 3 else xres / 2.54
            mpp = 10000.0 / per_cm
            self.properties["openslide.mpp-x"] = f"{mpp:.6f}"
            yres = _num(base.tags, _YRES) or xres
            per_cm_y = yres if unit == 3 else yres / 2.54
            self.properties["openslide.mpp-y"] = f"{10000.0 / per_cm_y:.6f}"
        for key, tag in (("XOffsetFromSlideCentre", _X_OFFSET),
                         ("YOffsetFromSlideCentre", _Y_OFFSET)):
            v = _num(base.tags, tag)
            if v is not None:
                self.properties[f"hamamatsu.{key}"] = f"{v:g}"
        self.properties["hamamatsu.SourceLens"] = f"{base.lens:g}"

    # -- page data -------------------------------------------------------

    def _page_bytes(self, p: _NdpiPage) -> bytes:
        self._f.seek(p.offset)
        return self._f.read(p.count)

    def _index(self, p: _NdpiPage) -> _JpegIndex:
        if p._jpeg is None:
            if p.comp != 7:
                raise UnsupportedTiffError(
                    f"NDPI page compression {p.comp} (only JPEG pages occur)"
                )
            p._jpeg = _JpegIndex(self._page_bytes(p))
        return p._jpeg

    def _decode_whole(self, level: int, p: _NdpiPage) -> np.ndarray:
        if level in self._pages_whole:
            return self._pages_whole[level]
        if p.width * p.height > _WHOLE_PAGE_MAX_PIXELS:
            raise UnsupportedVendorFormatError(
                f"NDPI page {p.width}x{p.height} has no MCU-row-aligned "
                "restart markers, and is too large to decode whole; "
                f"{_CONVERT_HINT}"
            )
        from PIL import Image

        arr = np.asarray(Image.open(io.BytesIO(self._page_bytes(p))).convert("RGB"))
        self._pages_whole[level] = arr
        return arr

    def _band(self, level: int, p: _NdpiPage, u0: int, u1: int) -> Tuple[np.ndarray, int]:
        key = (level, u0, u1)
        if key in self._bands:
            return self._bands[key]
        from PIL import Image

        info = self._index(p)
        jpeg, y0 = info.band_jpeg(self._page_bytes(p), u0, u1)
        arr = np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))
        if len(self._band_order) >= self._band_cache_max:
            self._bands.pop(self._band_order.pop(0), None)
        self._bands[key] = (arr, y0)
        self._band_order.append(key)
        return arr, y0

    # -- region access -----------------------------------------------------

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]) -> np.ndarray:
        """RGB uint8 ``[h, w, 3]``; ``location`` in LEVEL-0 pixels, ``size``
        in LEVEL pixels (OpenSlide semantics). Out-of-bounds is zero-filled."""
        ds = self.level_downsamples[level]
        x0 = int(location[0] / ds)
        y0 = int(location[1] / ds)
        p = self._levels[level]
        w, h = size
        out = np.zeros((h, w, 3), np.uint8)
        x1, y1 = min(x0 + w, p.width), min(y0 + h, p.height)
        if x0 >= p.width or y0 >= p.height or x1 <= 0 or y1 <= 0:
            return out
        cx0, cy0 = max(x0, 0), max(y0, 0)
        info = self._index(p)
        if info.rows_per_unit:
            unit_px = info.rows_per_unit * info.mcu_h
            u0 = cy0 // unit_px
            u1 = (y1 - 1) // unit_px + 1
            band, by0 = self._band(level, p, u0, u1)
            src = band[cy0 - by0 : y1 - by0, cx0:x1]
        else:
            whole = self._decode_whole(level, p)
            src = whole[cy0:y1, cx0:x1]
        out[cy0 - y0 : cy0 - y0 + src.shape[0],
            cx0 - x0 : cx0 - x0 + src.shape[1]] = src
        return out

    def get_thumbnail(self, max_size: int = 2048) -> np.ndarray:
        lv = self.level_count - 1
        p = self._levels[lv]
        arr = self._decode_whole(lv, p) if p.width * p.height <= _WHOLE_PAGE_MAX_PIXELS \
            else self.read_region((0, 0), lv, (p.width, min(p.height, max_size)))
        step = max(1, int(np.ceil(max(arr.shape[:2]) / max_size)))
        return arr[::step, ::step]

    @property
    def associated_images(self) -> Dict[str, np.ndarray]:
        """Decoded macro / map photos (OpenSlide exposes the same names for
        hamamatsu slides). Decoded lazily, cached."""
        from PIL import Image

        for name, p in self._assoc_pages.items():
            if name not in self._assoc_cache:
                self._assoc_cache[name] = np.asarray(
                    Image.open(io.BytesIO(self._page_bytes(p))).convert("RGB")
                )
        return dict(self._assoc_cache)

    def close(self):
        self._f.close()


# ---- fixture writer ------------------------------------------------------


def write_ndpi(
    path: str,
    level0: np.ndarray,
    levels: int = 2,
    mpp: float = 0.4419,
    lens: float = 20.0,
    quality: int = 90,
    restart_rows: int = 1,
    macro: bool = True,
) -> None:
    """Write an RGB image in the Hamamatsu NDPI layout (fixture twin of what
    OpenSlide's hamamatsu driver reads): classic little-endian TIFF, every
    IFD carrying the NDPI marker tag, each page ONE whole-page JPEG strip
    (``RowsPerStrip == height``), ``SourceLens`` per page (halving per
    level, ``-1`` for the trailing macro photo), pixels/cm resolution.
    ``restart_rows > 0`` emits MCU-row-aligned restart markers (what real
    scanners do and what the band decoder keys on); ``restart_rows = 0``
    writes a monolithic entropy stream to exercise the whole-page fallback.
    """
    from PIL import Image

    assert level0.ndim == 3 and level0.shape[2] == 3 and level0.dtype == np.uint8
    imgs = [level0]
    for _ in range(1, levels):
        prev = imgs[-1]
        h, w = prev.shape[:2]
        h2, w2 = h // 2 * 2, w // 2 * 2
        ds = prev[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, 3).mean((1, 3))
        imgs.append(ds.astype(np.uint8))

    # (img, source_lens)
    pages = [(img, lens / (2.0 ** i)) for i, img in enumerate(imgs)]
    if macro:
        step = max(1, level0.shape[1] // 64)
        pages.append((level0[::step, ::step], -1.0))

    bo = "<"
    out = io.BytesIO()
    out.write(b"II*\x00")
    out.write(struct.pack(bo + "I", 0))  # first-IFD offset patched below
    ifd_offsets: List[int] = []
    per_cm = int(round(10000.0 / mpp))

    for img, src_lens in pages:
        h, w = img.shape[:2]
        b = io.BytesIO()
        kw = {"quality": quality}
        if restart_rows and src_lens > 0:
            kw["restart_marker_rows"] = restart_rows
        Image.fromarray(img).save(b, "JPEG", **kw)
        data = b.getvalue()
        strip_off = out.tell()
        out.write(data)
        if out.tell() % 2:
            out.write(b"\x00")

        # (tag, type, values[, raw_bytes]) — type 5 rationals packed below
        tags = [
            (_W, 4, [w]), (_H, 4, [h]), (_BITS, 3, [8, 8, 8]),
            (_COMP, 3, [7]), (_PHOTO, 3, [6]), (_SPP, 3, [3]),
            (_ROWS_PER_STRIP, 4, [h]),
            (_STRIP_OFF, 4, [strip_off]), (_STRIP_CNT, 4, [len(data)]),
            (_XRES, 5, [(per_cm, 1)]), (_YRES, 5, [(per_cm, 1)]),
            (_RESUNIT, 3, [3]),
            (_NDPI_MARKER, 4, [1]),
            (_SOURCE_LENS, 11, [src_lens]),
            (_Z_OFFSET, 9, [0]),
        ]
        entries = []
        for tag, typ, vals in sorted(tags):
            if typ == 5:
                packed = b"".join(struct.pack(bo + "II", n, d) for n, d in vals)
                cnt = len(vals)
            else:
                packed = struct.pack(bo + _TYPE_FMT[typ] * len(vals), *vals)
                cnt = len(vals)
            size = _TYPE_SIZE[typ] * cnt
            head = struct.pack(bo + "HHI", tag, typ, cnt)
            if size > 4:
                voff = out.tell()
                out.write(packed)
                if out.tell() % 2:
                    out.write(b"\x00")
                entries.append(head + struct.pack(bo + "I", voff))
            else:
                entries.append(head + packed.ljust(4, b"\x00"))
        ifd_offsets.append(out.tell())
        out.write(struct.pack(bo + "H", len(entries)))
        for e in entries:
            out.write(e)
        out.write(struct.pack(bo + "I", 0))  # next-IFD patched below

    buf = bytearray(out.getvalue())
    buf[4:8] = struct.pack(bo + "I", ifd_offsets[0])
    for i in range(len(ifd_offsets) - 1):
        ifd = ifd_offsets[i]
        (n,) = struct.unpack(bo + "H", bytes(buf[ifd : ifd + 2]))
        ptr = ifd + 2 + n * 12
        buf[ptr : ptr + 4] = struct.pack(bo + "I", ifd_offsets[i + 1])
    with open(path, "wb") as f:
        f.write(buf)
