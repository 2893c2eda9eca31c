"""Pyramidal / tiled TIFF reader (and fixture writer) — pure Python.

A copy of ``mhim_mil_tpu/preprocess/tiff.py``, which imports no JAX; the
port keeps its own so that it imports nothing of the JAX package.

This environment has no OpenSlide, so the L0 pipeline gets a native reader
for the common WSI container: a multi-page TIFF whose pages are successive
resolutions of one slide, each stored as independently-decodable tiles.
The reader struct-parses the IFD chain and decodes tiles on demand, giving
OpenSlide-like random region access without ever materializing a gigapixel
level (reference slide handling: CLAM/wsi_core/WholeSlideImage.py:22-90
wraps `openslide.open_slide`; `read_region` semantics match OpenSlide's —
level-0 location, level-sized region).

Supported subset (honestly documented, tested):
  * classic TIFF (magic 42) and BigTIFF (magic 43 — what real >4 GB WSIs
    like CAMELYON16 .tif use), little- or big-endian
  * tiled pages (TileWidth/TileLength/TileOffsets) and striped pages
    (RowsPerStrip/StripOffsets) — thumbnails are often striped
  * compression: 1 (none), 5 (LZW, with horizontal predictor), 7 (JPEG,
    with or without a shared JPEGTables segment), 8/32946 (deflate),
    32773 (PackBits), 33003/33005 (Aperio JPEG2000 raw codestreams, via
    PIL/openjpeg; 33003 is YCbCr-coded and converted); LZW and PackBits
    decode through the native C codec (``mhim_mil_torch.native``, built on
    demand, pure-Python fallback)
  * photometric: RGB, YCbCr (JPEG), grayscale (expanded to RGB)
  * pages sorted by width into a pyramid; ``read_region`` takes level-0
    coordinates like OpenSlide
  * Aperio ``.svs`` page layout (the dominant TCGA container, which the
    reference opens via OpenSlide — CLAM/wsi_core/WholeSlideImage.py:22-90):
    tiled pages form the pyramid; striped pages are ASSOCIATED images
    (thumbnail / label / macro, exposed like OpenSlide's
    ``associated_images``); ``ImageDescription`` metadata (AppMag, MPP)
    lands in ``properties`` under the openslide key names.

TIFF-contained vendor layouts are read by sibling modules and routed by
``open_slide`` (by extension or by content signature inside a ``.tif``):
Hamamatsu NDPI by :mod:`mhim_mil_torch.preprocess.ndpi`; Philips TIFF and
Leica SCN by :mod:`mhim_mil_torch.preprocess.vendor_tiff` (both reuse this
module's page/tile machinery via ``PyramidalTiff._build_layout``).

Out of scope: planar configuration 2, palette images. Files outside the
subset raise ``UnsupportedTiffError`` so callers can fall back to plain
raster loading — EXCEPT recognized vendor WSI formats we do NOT decode
(Hamamatsu VMU raw-NGR, Philips iSyntax, Sakura .svslide),
which raise ``UnsupportedVendorFormatError`` naming the format
and the conversion path (vips/OpenSlide re-tiling to pyramidal TIFF), so
a sweep over a mixed archive fails actionably instead of with a generic
TIFF parse error.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np


class UnsupportedTiffError(ValueError):
    pass


class UnsupportedVendorFormatError(UnsupportedTiffError):
    """A *recognized* vendor WSI format this reader does not decode.

    The reference opens any format OpenSlide ships a driver for
    (CLAM/wsi_core/WholeSlideImage.py:22-90); this reader covers the
    TIFF-family containers (classic/BigTIFF/Aperio .svs). Other vendor
    files get a named error with a conversion recipe instead of a generic
    TIFF parse failure — and ``open_slide`` re-raises it rather than
    silently falling back to flat-raster loading.
    """


# Vendor formats recognized by extension: name + how to get them into the
# supported subset (any OpenSlide/vips host can do the conversion offline).
_VENDOR_EXTS = {
    ".vmu": "Hamamatsu VMU",
    ".isyntax": "Philips iSyntax",
    ".svslide": "Sakura",
}
_CONVERT_HINT = (
    "convert it to a pyramidal TIFF on any machine with vips/OpenSlide "
    "(e.g. `vips copy in.{ext} out.tif[tile,pyramid,compression=jpeg,Q=90]`) "
    "and point the pipeline at the .tif"
)


def _vendor_error(name: str) -> UnsupportedVendorFormatError:
    return UnsupportedVendorFormatError(
        f"{name} slides are not supported by this reader "
        "(supported: classic TIFF, BigTIFF, Aperio .svs, Hamamatsu "
        ".ndpi/.vms, MIRAX .mrxs, Philips TIFF, Leica .scn, Ventana .bif); "
        f"{_CONVERT_HINT}"
    )


# TIFF tag ids
_W, _H = 256, 257
_BITS, _COMP, _PHOTO = 258, 259, 262
_DESC = 270
_MAKE, _SOFTWARE = 271, 305
_STRIP_OFF, _SPP, _ROWS_PER_STRIP, _STRIP_CNT = 273, 277, 278, 279
_PLANAR, _PREDICTOR = 284, 317
_TILE_W, _TILE_H, _TILE_OFF, _TILE_CNT = 322, 323, 324, 325
_JPEG_TABLES = 347
_XMP = 700  # XMP packet (Ventana BIF keeps its iScan metadata here)
_NDPI_PRIVATE = 65420  # Hamamatsu NDPI marker tag (what OpenSlide keys on)

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


def _read_ifd(f, off: int, bo: str, big: bool = False) -> Tuple[Dict[int, tuple], int]:
    """One IFD. ``big``: BigTIFF layout (u64 entry count / 20-byte entries /
    8-byte inline values / u64 next pointer) — what real >4 GB WSIs use."""
    f.seek(off)
    if big:
        (n,) = struct.unpack(bo + "Q", f.read(8))
        esz, inline, ofmt = 20, 8, "Q"
    else:
        (n,) = struct.unpack(bo + "H", f.read(2))
        esz, inline, ofmt = 12, 4, "I"
    tags: Dict[int, tuple] = {}
    entries = f.read(n * esz)
    (next_off,) = struct.unpack(bo + ofmt, f.read(struct.calcsize(ofmt)))
    for i in range(n):
        if big:
            tag, typ, cnt = struct.unpack(
                bo + "HHQ", entries[i * esz : i * esz + 12]
            )
        else:
            tag, typ, cnt = struct.unpack(
                bo + "HHI", entries[i * esz : i * esz + 8]
            )
        size = _TYPE_SIZE.get(typ, 1) * cnt
        raw = entries[i * esz + esz - inline : i * esz + esz]
        if size > inline:
            (voff,) = struct.unpack(bo + ofmt, raw)
            here = f.tell()
            f.seek(voff)
            raw = f.read(size)
            f.seek(here)
        else:
            raw = raw[:size]
        if typ in _TYPE_FMT:
            vals = struct.unpack(bo + _TYPE_FMT[typ] * cnt, raw)
        elif typ == 5:  # rational
            parts = struct.unpack(bo + "II" * cnt, raw)
            vals = tuple(a / max(b, 1) for a, b in zip(parts[::2], parts[1::2]))
        elif typ == 10:  # signed rational (NDPI SourceLens on some scanners)
            parts = struct.unpack(bo + "ii" * cnt, raw)
            vals = tuple(a / (b if b else 1) for a, b in zip(parts[::2], parts[1::2]))
        else:
            vals = (raw,)
        tags[tag] = vals
    return tags, next_off


def _lzw_decode_py(data: bytes) -> bytes:
    """TIFF-flavour LZW (MSB-first codes, early code-size change) — the
    pure-Python reference implementation; the hot path routes through the
    C decoder in ``mhim_mil_torch.native`` when a compiler is available."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    width = 9
    buf = 0
    nbits = 0
    prev = None
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (buf >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == CLEAR:
                reset()
                width = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            # TIFF uses "early change": bump width one code early
            if len(table) + 1 >= (1 << width) and width < 12:
                width += 1
    return bytes(out)


def _lzw_encode(data: bytes) -> bytes:
    """TIFF-flavour LZW encoder (writer-side twin of the decoder: MSB-first
    codes, early width change after the insert, conservative CLEAR before
    the 12-bit table boundary). Only used by ``write_pyramidal_tiff`` — real
    ingestion never encodes — so clarity wins over ratio."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    buf = nbits = 0
    width = 9

    def emit(code):
        nonlocal buf, nbits
        buf = (buf << width) | code
        nbits += width
        while nbits >= 8:
            out.append((buf >> (nbits - 8)) & 0xFF)
            nbits -= 8
        buf &= (1 << nbits) - 1

    def fresh():
        return {bytes([j]): j for j in range(256)}

    table = fresh()
    next_code = 258
    emit(CLEAR)
    w = b""
    for i in range(len(data)):
        c = data[i : i + 1]
        wc = w + c
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = next_code
        next_code += 1
        # early change: the decoder bumps its read width after installing
        # entry (1<<width)-2, so the encoder bumps after the same insert
        if next_code >= (1 << width) and width < 12:
            width += 1
        w = c
        if next_code >= 4093:  # clear well before any 13-bit code is needed
            emit(table[w])
            emit(CLEAR)
            table = fresh()
            next_code = 258
            width = 9
            w = b""
    if w:
        emit(table[w])
    emit(EOI)
    if nbits:
        out.append((buf << (8 - nbits)) & 0xFF)
    return bytes(out)


def _undo_predictor(arr: np.ndarray) -> np.ndarray:
    return np.cumsum(arr.astype(np.uint32), axis=1).astype(np.uint8)


def _ycbcr_to_rgb(arr: np.ndarray) -> np.ndarray:
    """Full-range BT.601 YCbCr → RGB (Aperio 33003 J2K codestreams carry
    YCbCr planes without declaring a colour space; OpenSlide's Aperio
    driver applies the same conversion)."""
    y = arr[..., 0].astype(np.float32)
    cb = arr[..., 1].astype(np.float32) - 128.0
    cr = arr[..., 2].astype(np.float32) - 128.0
    rgb = np.stack(
        [y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb],
        axis=-1,
    )
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _rgb_to_ycbcr(arr: np.ndarray) -> np.ndarray:
    """Writer-side twin of :func:`_ycbcr_to_rgb` (fixtures for the 33003
    decode path)."""
    r = arr[..., 0].astype(np.float32)
    g = arr[..., 1].astype(np.float32)
    b = arr[..., 2].astype(np.float32)
    ycc = np.stack(
        [
            0.299 * r + 0.587 * g + 0.114 * b,
            128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b,
            128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b,
        ],
        axis=-1,
    )
    return np.clip(np.round(ycc), 0, 255).astype(np.uint8)


def _tag_text(tags: Dict[int, tuple], tag_id: int) -> str:
    v = tags.get(tag_id, (b"",))[0]
    if isinstance(v, tuple):
        v = v[0] if v else b""
    if isinstance(v, bytes):
        return v.split(b"\x00", 1)[0].decode("latin-1", "replace")
    return str(v)


def _tag_bytes(tags: Dict[int, tuple], tag_id: int) -> bytes:
    """Raw bytes of a tag whether stored as UNDEFINED (one bytes blob) or
    as a BYTE array (tuple of ints) — XMP packets occur as both."""
    v = tags.get(tag_id, ())
    if len(v) == 1 and isinstance(v[0], bytes):
        return v[0]
    if v and all(isinstance(x, int) for x in v):
        return bytes(v)
    return b""


class _NdpiContent(Exception):
    """Internal routing signal: a .tif-named file is NDPI inside —
    ``open_slide`` re-opens it through :class:`~.ndpi.NdpiSlide` instead of
    the generic pyramid parser (never surfaced to callers)."""


class _PhilipsContent(Exception):
    """Routing signal: Philips TIFF layout — handled by
    :class:`~mhim_mil_torch.preprocess.vendor_tiff.PhilipsTiff`."""


class _ScnContent(Exception):
    """Routing signal: Leica SCN layout — handled by
    :class:`~mhim_mil_torch.preprocess.vendor_tiff.LeicaScn`."""


class _VentanaContent(Exception):
    """Routing signal: Ventana BIF layout (iScan XMP) — handled by
    :class:`~mhim_mil_torch.preprocess.vendor_tiff.VentanaBif`."""


def _detect_vendor_tiff(raw_pages: List[Dict[int, tuple]]) -> None:
    """Route TIFF-contained vendor layouts to their dedicated readers
    (NDPI / Philips TIFF / Leica SCN / Ventana BIF — routing signals
    caught by ``open_slide``, never surfaced to callers)."""
    first = raw_pages[0]
    if any(_NDPI_PRIVATE in tags for tags in raw_pages):
        raise _NdpiContent
    make = _tag_text(first, _MAKE).lower()
    soft = _tag_text(first, _SOFTWARE).lower()
    desc = _tag_text(first, _DESC)
    if "hamamatsu" in make and not any(_TILE_OFF in t for t in raw_pages):
        raise _NdpiContent
    if (
        "philips" in soft
        or 'ObjectType="DPUfsImport"' in desc
        or (desc.lstrip().startswith("<?xml") and "philips" in desc.lower())
    ):
        raise _PhilipsContent
    if "<scn" in desc[:256] or (
        "leica" in make and desc.lstrip().startswith("<")
    ):
        raise _ScnContent
    # Ventana keys on the iScan XMP packet, not on tag presence: generic
    # TIFFs carry XMP (tag 700) too
    if any(b"iScan" in _tag_bytes(t, _XMP) for t in raw_pages):
        raise _VentanaContent


class _Page:
    def __init__(self, tags: Dict[int, tuple]):
        self.tags = tags
        # Philips TIFF leaves background tiles out of the file (offset and
        # byte count 0); the vendor layout sets this to the fill value
        # (255 = white, what OpenSlide's philips driver renders them as).
        self.sparse_fill: int | None = None
        self.width = tags[_W][0]
        self.height = tags[_H][0]
        self.comp = tags.get(_COMP, (1,))[0]
        self.photo = tags.get(_PHOTO, (2,))[0]
        self.spp = tags.get(_SPP, (1,))[0]
        self.predictor = tags.get(_PREDICTOR, (1,))[0]
        self.jpeg_tables = tags.get(_JPEG_TABLES, (None,))[0]
        desc = tags.get(_DESC, (b"",))[0]
        if isinstance(desc, tuple):
            desc = desc[0] if desc else b""
        self.description = (
            desc.split(b"\x00", 1)[0].decode("latin-1") if isinstance(desc, bytes)
            else str(desc)
        )
        self.tiled = _TILE_OFF in tags
        if self.tiled:
            self.tw = tags[_TILE_W][0]
            self.th = tags[_TILE_H][0]
            self.offsets = tags[_TILE_OFF]
            self.counts = tags[_TILE_CNT]
            self.tiles_x = -(-self.width // self.tw)
        else:
            if _STRIP_OFF not in tags:
                raise UnsupportedTiffError("page is neither tiled nor striped")
            self.tw = self.width
            self.th = tags.get(_ROWS_PER_STRIP, (self.height,))[0]
            self.offsets = tags[_STRIP_OFF]
            self.counts = tags[_STRIP_CNT]
            self.tiles_x = 1
        if tags.get(_PLANAR, (1,))[0] != 1:
            raise UnsupportedTiffError("planar configuration 2 not supported")
        if self.comp not in (1, 5, 7, 8, 32773, 32946, 33003, 33005):
            raise UnsupportedTiffError(
                f"compression {self.comp} not supported"
            )
        if self.comp in (33003, 33005):
            from PIL import features

            if not features.check("jpg_2000"):
                raise UnsupportedTiffError(
                    "JPEG2000 .svs page (Aperio compression "
                    f"{self.comp}) but PIL lacks openjpeg support"
                )


class PyramidalTiff:
    """OpenSlide-like random access over a tiled/pyramidal TIFF.

    API mirror of the reference's slide object (openslide.OpenSlide):
    ``level_count``, ``dimensions``, ``level_dimensions``,
    ``level_downsamples``, ``read_region((x0, y0), level, (w, h))`` with
    level-0 location and level-space size, ``get_thumbnail(max_size)``.
    """

    def __init__(self, path: str, tile_cache: int = 256):
        self._f = open(path, "rb")
        try:
            raw = self._read_ifd_chain()
            self._build_layout(raw)
            self._finalize(tile_cache)
        except Exception:
            # open_slide swallows UnsupportedTiffError to fall back to
            # RasterSlide — without this, every unsupported TIFF in a sweep
            # would leak one OS file handle until GC.
            self._f.close()
            raise

    def _read_ifd_chain(self) -> List[Dict[int, tuple]]:
        """Header + IFD walk: the raw tag dicts of every image page, in
        chain order (vendor layouts key on chain position, e.g. Leica SCN's
        ``dimension ifd=`` indices)."""
        head = self._f.read(4)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            raise UnsupportedTiffError("not a TIFF file")
        (magic,) = struct.unpack(bo + "H", head[2:4])
        big = magic == 43
        if magic not in (42, 43):
            raise UnsupportedTiffError("not a TIFF file")
        self._bo = bo
        if big:
            osz, zero = struct.unpack(bo + "HH", self._f.read(4))
            if osz != 8 or zero != 0:
                raise UnsupportedTiffError("malformed BigTIFF header")
            (off,) = struct.unpack(bo + "Q", self._f.read(8))
        else:
            (off,) = struct.unpack(bo + "I", self._f.read(4))
        raw = []
        while off:
            tags, off = _read_ifd(self._f, off, bo, big)
            if _W in tags and _H in tags:
                raw.append(tags)
        if not raw:
            raise UnsupportedTiffError("no image pages")
        return raw

    def _build_layout(self, raw: List[Dict[int, tuple]]) -> None:
        """Generic + Aperio layout: sets ``_pages`` (pyramid, width-sorted),
        ``properties`` and ``_assoc_pages``. Vendor subclasses
        (:mod:`~mhim_mil_torch.preprocess.vendor_tiff`) override this."""
        # Recognize TIFF-contained vendor formats BEFORE page construction,
        # so e.g. an NDPI routes to its reader, not a generic parse error
        # (the reference reads these through OpenSlide's vendor drivers,
        # CLAM/wsi_core/WholeSlideImage.py:22-90).
        _detect_vendor_tiff(raw)
        pages = [_Page(tags) for tags in raw]

        self.properties: Dict[str, str] = {}
        self._assoc_pages: Dict[str, _Page] = {}
        if any(p.description.startswith("Aperio") for p in pages):
            # Aperio .svs layout (what OpenSlide's Aperio driver implements,
            # reference reaches it via openslide.open_slide,
            # CLAM/wsi_core/WholeSlideImage.py:32): TILED pages form the
            # pyramid; STRIPED pages are associated images — the first one
            # is the thumbnail, later ones are named 'label' / 'macro' in
            # their ImageDescription.
            self.properties.update(_parse_aperio_description(
                pages[0].description
            ))
            self.properties["openslide.vendor"] = "aperio"
            levels = [p for p in pages if p.tiled]
            for p in pages:
                if p.tiled:
                    continue
                d = p.description.lower()
                if "label" in d:
                    name = "label"
                elif "macro" in d:
                    name = "macro"
                else:
                    name = "thumbnail"
                self._assoc_pages.setdefault(name, p)
            if not levels:
                raise UnsupportedTiffError(".svs has no tiled pyramid pages")
            pages = levels

        pages.sort(key=lambda p: -p.width)
        self._pages = pages

    def _finalize(self, tile_cache: int) -> None:
        pages = self._pages
        self.level_count = len(pages)
        self.level_dimensions = [(p.width, p.height) for p in pages]
        self.dimensions = self.level_dimensions[0]
        w0 = pages[0].width
        self.level_downsamples = [w0 / p.width for p in pages]
        self._cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._cache_order: List[Tuple[int, int]] = []
        self._cache_max = tile_cache
        self._assoc_cache: Dict[str, np.ndarray] = {}

    @property
    def associated_images(self) -> Dict[str, np.ndarray]:
        """Decoded associated images (OpenSlide API: ``thumbnail`` / ``label``
        / ``macro``). Decoded lazily on first access, then cached."""
        for name, p in self._assoc_pages.items():
            if name not in self._assoc_cache:
                self._assoc_cache[name] = _decode_whole_page(self, p)
        return dict(self._assoc_cache)

    # -- tile decode ---------------------------------------------------------

    def _decode(self, level: int, idx: int) -> np.ndarray:
        key = (level, idx)
        if key in self._cache:
            return self._cache[key]
        arr = _decode_tile(self._f, self._pages[level], idx)
        if len(self._cache_order) >= self._cache_max:
            old = self._cache_order.pop(0)
            self._cache.pop(old, None)
        self._cache[key] = arr
        self._cache_order.append(key)
        return arr


    # -- region access -------------------------------------------------------


    def read_region(self, location: Tuple[int, int], level: int, size: Tuple[int, int]) -> np.ndarray:
        """RGB uint8 ``[h, w, 3]``. ``location`` is (x, y) in LEVEL-0 pixels,
        ``size`` is (w, h) in LEVEL pixels (OpenSlide semantics; reference
        consumes it the same way in Whole_Slide_Bag_FP,
        CLAM/dataset_modules/dataset_h5.py:79-84). Out-of-bounds area is
        zero-filled."""
        ds = self.level_downsamples[level]
        return self._read_level(
            int(location[0] / ds), int(location[1] / ds), level, size
        )

    def _read_level(self, x0: int, y0: int, level: int, size: Tuple[int, int]) -> np.ndarray:
        """``read_region`` with the origin already in LEVEL coordinates
        (avoids the level-0 float round-trip for internal callers)."""
        p = self._pages[level]
        w, h = size
        out = np.zeros((h, w, 3), np.uint8)
        x1, y1 = min(x0 + w, p.width), min(y0 + h, p.height)
        if x0 >= p.width or y0 >= p.height or x1 <= 0 or y1 <= 0:
            return out
        ty0, ty1 = max(y0, 0) // p.th, (y1 - 1) // p.th
        tx0, tx1 = max(x0, 0) // p.tw, (x1 - 1) // p.tw
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                tile = self._decode(level, ty * p.tiles_x + tx)
                gx, gy = tx * p.tw, ty * p.th  # tile origin in level coords
                sx0, sy0 = max(x0, gx), max(y0, gy)
                sx1 = min(x1, gx + tile.shape[1])
                sy1 = min(y1, gy + tile.shape[0])
                if sx1 <= sx0 or sy1 <= sy0:
                    continue
                out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = tile[
                    sy0 - gy : sy1 - gy, sx0 - gx : sx1 - gx
                ]
        return out

    def get_thumbnail(self, max_size: int = 2048) -> np.ndarray:
        """Whole-slide RGB thumbnail from the smallest pyramid level,
        decimated to ``max_size`` (the reference segments at a low
        `seg_level` the same way, WholeSlideImage.py:144)."""
        lv = self.level_count - 1
        w, h = self.level_dimensions[lv]
        step = max(1, int(np.ceil(max(w, h) / max_size)))
        # Stream one band of tile rows at a time: a shallow pyramid (the
        # levels=1 converter output) would otherwise materialize its full
        # level 0 (e.g. ~30 GB at 100k x 100k) just to make a 2k thumbnail.
        p = self._pages[lv]
        ys = np.arange(0, h, step)
        xs = np.arange(0, w, step)
        out = np.empty((len(ys), len(xs), 3), np.uint8)
        for ty in range((h + p.th - 1) // p.th):
            yy0, yy1 = ty * p.th, min((ty + 1) * p.th, h)
            sel = (ys >= yy0) & (ys < yy1)
            if not sel.any():
                continue
            band = self._read_level(0, yy0, lv, (w, yy1 - yy0))
            out[np.flatnonzero(sel)] = band[ys[sel] - yy0][:, xs]
        return out

    def close(self):
        self._f.close()


def _decode_tile(f, p: _Page, idx: int) -> np.ndarray:
    if p.offsets[idx] == 0 or p.counts[idx] == 0:
        # Tile data absent from the file. Philips TIFF does this for
        # background tiles (rendered as the fill color, like OpenSlide's
        # philips driver); anywhere else it is a malformed file.
        if p.sparse_fill is None:
            raise UnsupportedTiffError(f"tile {idx} has no data in the file")
        return np.full((p.th, p.tw, 3), p.sparse_fill, np.uint8)
    f.seek(p.offsets[idx])
    data = f.read(p.counts[idx])
    if p.comp == 7:
        from PIL import Image

        if p.jpeg_tables:
            # merge the shared tables segment into the tile's stream:
            # tables end with EOI (ffd9), tile starts with SOI (ffd8)
            tables = p.jpeg_tables
            data = tables[:-2] + data[2:]
        arr = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    elif p.comp in (33003, 33005):
        # Aperio JPEG2000: tiles are raw J2K codestreams (SOC ff4fff51),
        # decoded via PIL/openjpeg. 33003 carries YCbCr planes (openjpeg
        # hands them back untouched), 33005 is RGB.
        from PIL import Image

        arr = np.asarray(Image.open(io.BytesIO(data)))
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        arr = arr[..., :3]
        if p.comp == 33003:
            arr = _ycbcr_to_rgb(arr)
    else:
        # strip height may exceed the remaining rows on the last strip
        rows = min(p.th, p.height - (idx // p.tiles_x) * p.th) if not p.tiled else p.th
        want = p.tw * rows * p.spp
        if p.comp in (8, 32946):
            data = zlib.decompress(data)
        elif p.comp == 5:
            from ..native import lzw_decode

            data = lzw_decode(data, want)
        elif p.comp == 32773:
            from ..native import packbits_decode

            data = packbits_decode(data, want)
        arr = np.frombuffer(data[:want], np.uint8).reshape(rows, p.tw, p.spp)
        if p.predictor == 2:
            arr = _undo_predictor(
                arr.reshape(rows, p.tw * p.spp).view(np.uint8)
                .reshape(rows, p.tw, p.spp)
            )
        if p.spp == 1:
            arr = np.repeat(arr, 3, axis=-1)
        arr = arr[..., :3]
    return arr


def _decode_whole_page(slide: "PyramidalTiff", p: _Page) -> np.ndarray:
    """Assemble a full (small) page from its strips/tiles — used for the
    associated thumbnail/label/macro images of an .svs."""
    out = np.zeros((p.height, p.width, 3), np.uint8)
    n_ty = -(-p.height // p.th)
    n_tx = p.tiles_x if p.tiled else 1
    for ty in range(n_ty):
        for tx in range(n_tx):
            tile = _decode_tile(slide._f, p, ty * n_tx + tx)
            y0, x0 = ty * p.th, tx * p.tw
            hh = min(tile.shape[0], p.height - y0)
            ww = min(tile.shape[1], p.width - x0)
            out[y0 : y0 + hh, x0 : x0 + ww] = tile[:hh, :ww]
    return out


def _parse_aperio_description(desc: str) -> Dict[str, str]:
    """Pull the pipe-delimited ``Key = Value`` metadata out of an Aperio
    ImageDescription into openslide-style property keys (MPP →
    ``openslide.mpp-x/y``, AppMag → ``openslide.objective-power``; every raw
    field is kept under ``aperio.<Key>``)."""
    props: Dict[str, str] = {}
    for part in desc.split("|")[1:]:
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        k, v = k.strip(), v.strip()
        props[f"aperio.{k}"] = v
    if "aperio.MPP" in props:
        props["openslide.mpp-x"] = props["aperio.MPP"]
        props["openslide.mpp-y"] = props["aperio.MPP"]
    if "aperio.AppMag" in props:
        props["openslide.objective-power"] = props["aperio.AppMag"]
    return props


class RasterSlide:
    """Single-level fallback wrapping a plain raster image with the same API
    (PNG/JPEG level-0 exports)."""

    def __init__(self, path: str):
        from PIL import Image

        self._img = np.asarray(Image.open(path).convert("RGB"))
        h, w = self._img.shape[:2]
        # API uniformity with PyramidalTiff (flat rasters carry no scanner
        # metadata or associated pages).
        self.properties: Dict[str, str] = {}
        self.associated_images: Dict[str, np.ndarray] = {}
        self.level_count = 1
        self.dimensions = (w, h)
        self.level_dimensions = [(w, h)]
        self.level_downsamples = [1.0]

    def read_region(self, location, level, size):
        x, y = location
        w, h = size
        out = np.zeros((h, w, 3), np.uint8)
        ih, iw = self._img.shape[:2]
        x1, y1 = min(x + w, iw), min(y + h, ih)
        if x < iw and y < ih:
            out[: y1 - y, : x1 - x] = self._img[y:y1, x:x1]
        return out

    def get_thumbnail(self, max_size: int = 2048) -> np.ndarray:
        step = max(1, max(self._img.shape[:2]) // max_size)
        return self._img[::step, ::step]

    def close(self):
        pass


def open_slide(path: str):
    """Open ``path`` as a pyramidal TIFF / Aperio .svs / Hamamatsu .ndpi /
    MIRAX .mrxs / Philips TIFF / Leica .scn when possible, else as a flat
    raster image (the reference calls openslide.open_slide unconditionally,
    WholeSlideImage.py:32). Vendor layouts route by extension or by
    content signature inside a ``.tif``: NDPI to
    :class:`~mhim_mil_torch.preprocess.ndpi.NdpiSlide`, MIRAX to
    :class:`~mhim_mil_torch.preprocess.mirax.MiraxSlide`, Philips/SCN to
    :mod:`~mhim_mil_torch.preprocess.vendor_tiff`. Recognized vendor formats
    outside the supported subset (iSyntax/VMS/BIF/...) raise
    :class:`UnsupportedVendorFormatError` with a conversion recipe instead
    of a generic parse error or a silent raster fallback."""
    lower = path.lower()
    for ext, name in _VENDOR_EXTS.items():
        if lower.endswith(ext):
            raise _vendor_error(name)
    if lower.endswith(".ndpi"):
        from .ndpi import NdpiSlide

        return NdpiSlide(path)
    if lower.endswith(".mrxs"):
        from .mirax import MiraxSlide

        return MiraxSlide(path)
    if lower.endswith(".vms"):
        from .vms import VmsSlide

        return VmsSlide(path)
    if lower.endswith(".scn"):
        from .vendor_tiff import LeicaScn

        return LeicaScn(path)
    if lower.endswith(".bif"):
        from .vendor_tiff import VentanaBif

        return VentanaBif(path)
    if lower.endswith((".tif", ".tiff", ".svs")):
        try:
            return PyramidalTiff(path)
        except _NdpiContent:
            from .ndpi import NdpiSlide

            return NdpiSlide(path)
        except _PhilipsContent:
            from .vendor_tiff import PhilipsTiff

            return PhilipsTiff(path)
        except _ScnContent:
            from .vendor_tiff import LeicaScn

            return LeicaScn(path)
        except _VentanaContent:
            from .vendor_tiff import VentanaBif

            return VentanaBif(path)
        except UnsupportedVendorFormatError:
            raise
        except UnsupportedTiffError:
            pass
    return RasterSlide(path)


# ---- writer (fixtures / exports) ---------------------------------------------


def write_pyramidal_tiff(
    path: str,
    level0: np.ndarray,
    levels: int = 2,
    tile: int = 256,
    compression: str = "raw",
    quality: int = 90,
    bigtiff: bool = False,
) -> None:
    """Write an RGB image as a tiled pyramidal TIFF (each level a 2x
    box-downsample of the previous). ``compression``: 'raw' | 'jpeg' |
    'deflate'; ``bigtiff`` emits the 8-byte-offset BigTIFF layout that real
    >4 GB WSIs (e.g. CAMELYON16 .tif) use. Used by the L0 tests as the
    synthetic-WSI fixture and usable as a converter target for level-0
    exports."""
    assert level0.ndim == 3 and level0.shape[2] == 3 and level0.dtype == np.uint8
    imgs = [level0]
    for _ in range(1, levels):
        prev = imgs[-1]
        h, w = prev.shape[:2]
        h2, w2 = h // 2 * 2, w // 2 * 2
        ds = prev[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, 3).mean((1, 3))
        imgs.append(ds.astype(np.uint8))

    bo = "<"
    out = io.BytesIO()
    if bigtiff:
        out.write(b"II+\x00")
        out.write(struct.pack(bo + "HH", 8, 0))
        out.write(struct.pack(bo + "Q", 0))  # first-IFD offset patched later
        ofmt, inline, entry_hdr = "Q", 8, "HHQ"
    else:
        out.write(b"II*\x00")
        out.write(struct.pack(bo + "I", 0))  # first-IFD offset patched later
        ofmt, inline, entry_hdr = "I", 4, "HHI"
    ifd_offsets = []

    def _tile_bytes(img, ty, tx):
        th = tw = tile
        t = np.zeros((th, tw, 3), np.uint8)
        sy, sx = ty * th, tx * tw
        part = img[sy : sy + th, sx : sx + tw]
        t[: part.shape[0], : part.shape[1]] = part
        if compression == "jpeg":
            from PIL import Image

            b = io.BytesIO()
            Image.fromarray(t).save(b, "JPEG", quality=quality)
            return b.getvalue()
        if compression == "deflate":
            return zlib.compress(t.tobytes())
        if compression == "lzw":
            return _lzw_encode(t.tobytes())
        return t.tobytes()

    for img in imgs:
        h, w = img.shape[:2]
        ntx, nty = -(-w // tile), -(-h // tile)
        offs, cnts = [], []
        for ty in range(nty):
            for tx in range(ntx):
                data = _tile_bytes(img, ty, tx)
                offs.append(out.tell())
                cnts.append(len(data))
                out.write(data)
                if out.tell() % 2:
                    out.write(b"\x00")

        comp_code = {"raw": 1, "jpeg": 7, "deflate": 8, "lzw": 5}[compression]
        photo = 6 if compression == "jpeg" else 2
        off_type = 16 if bigtiff else 4  # LONG8 offsets for >4 GB files
        tags = [
            (_W, 4, [w]), (_H, 4, [h]), (_BITS, 3, [8, 8, 8]),
            (_COMP, 3, [comp_code]), (_PHOTO, 3, [photo]),
            (_SPP, 3, [3]), (_PLANAR, 3, [1]),
            (_TILE_W, 3, [tile]), (_TILE_H, 3, [tile]),
            (_TILE_OFF, off_type, offs), (_TILE_CNT, 4, cnts),
        ]
        # out-of-line values first
        tag_entries = []
        for tag, typ, vals in sorted(tags):
            fmt = _TYPE_FMT[typ]
            size = _TYPE_SIZE[typ] * len(vals)
            packed = struct.pack(bo + fmt * len(vals), *vals)
            head = struct.pack(bo + entry_hdr, tag, typ, len(vals))
            if size > inline:
                voff = out.tell()
                out.write(packed)
                if out.tell() % 2:
                    out.write(b"\x00")
                entry = head + struct.pack(bo + ofmt, voff)
            else:
                entry = head + packed.ljust(inline, b"\x00")
            tag_entries.append(entry)
        ifd_offsets.append(out.tell())
        if bigtiff:
            out.write(struct.pack(bo + "Q", len(tag_entries)))
        else:
            out.write(struct.pack(bo + "H", len(tag_entries)))
        for e in tag_entries:
            out.write(e)
        out.write(struct.pack(bo + ofmt, 0))  # next-IFD patched below

    buf = bytearray(out.getvalue())
    esz = 20 if bigtiff else 12
    cnt_sz = 8 if bigtiff else 2
    first_at = 8 if bigtiff else 4
    osz = struct.calcsize(ofmt)
    buf[first_at : first_at + osz] = struct.pack(bo + ofmt, ifd_offsets[0])
    for i in range(len(ifd_offsets) - 1):
        # next-IFD pointer sits after the entry table of IFD i
        ifd = ifd_offsets[i]
        if bigtiff:
            (n,) = struct.unpack(bo + "Q", bytes(buf[ifd : ifd + 8]))
        else:
            (n,) = struct.unpack(bo + "H", bytes(buf[ifd : ifd + 2]))
        ptr = ifd + cnt_sz + n * esz
        buf[ptr : ptr + osz] = struct.pack(bo + ofmt, ifd_offsets[i + 1])
    with open(path, "wb") as f:
        f.write(buf)


def write_aperio_svs(
    path: str,
    level0: np.ndarray,
    levels: int = 2,
    tile: int = 256,
    compression: str = "jpeg",
    quality: int = 90,
    mpp: float = 0.5,
    app_mag: int = 20,
) -> None:
    """Write an RGB image in the Aperio ``.svs`` page layout (fixture twin of
    the files OpenSlide's Aperio driver reads; the reference ingests them via
    ``openslide.open_slide``, CLAM/wsi_core/WholeSlideImage.py:22-90):

      IFD 0   baseline, tiled, ``compression`` ('jpeg' | 'j2k-ycbcr' (33003)
              | 'j2k-rgb' (33005)), Aperio ImageDescription with AppMag/MPP
      IFD 1   thumbnail, STRIPED jpeg (an associated image, not a level)
      IFD 2+  tiled pyramid levels (2x box-downsamples)
      then    'label' and 'macro' striped pages (associated images)

    Interleaving striped associated pages between/after tiled levels is
    exactly what trips a naive sort-by-width pyramid — the reader must
    route by tiled-vs-striped like OpenSlide does.
    """
    from PIL import Image

    assert level0.ndim == 3 and level0.shape[2] == 3 and level0.dtype == np.uint8
    comp_code = {"jpeg": 7, "j2k-ycbcr": 33003, "j2k-rgb": 33005}[compression]

    imgs = [level0]
    for _ in range(1, levels):
        prev = imgs[-1]
        h, w = prev.shape[:2]
        h2, w2 = h // 2 * 2, w // 2 * 2
        ds = prev[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, 3).mean((1, 3))
        imgs.append(ds.astype(np.uint8))

    h0, w0 = level0.shape[:2]
    base_desc = (
        f"Aperio Image Library v12.0.15\r\n{w0}x{h0} [0,0 {w0}x{h0}] "
        f"({tile}x{tile}) -- |AppMag = {app_mag}|StripeWidth = 2040"
        f"|MPP = {mpp:.4f}|Filename = fixture|"
    )

    def enc_tile(t: np.ndarray) -> bytes:
        b = io.BytesIO()
        if comp_code == 7:
            Image.fromarray(t).save(b, "JPEG", quality=quality)
        elif comp_code == 33005:
            Image.fromarray(t).save(b, "JPEG2000", no_jp2=True)
        else:  # 33003: YCbCr planes in a raw J2K codestream
            Image.fromarray(_rgb_to_ycbcr(t)).save(b, "JPEG2000", no_jp2=True)
        return b.getvalue()

    def thumb(img: np.ndarray, max_w: int) -> np.ndarray:
        step = max(1, img.shape[1] // max_w)
        return img[::step, ::step]

    # page spec: (img, tiled?, comp_code, description)
    pages = [(imgs[0], True, comp_code, base_desc)]
    pages.append((thumb(level0, 64), False, 7, "Aperio Image Library v12.0.15\r\nthumb"))
    for ds_img in imgs[1:]:
        pages.append((ds_img, True, comp_code, base_desc))
    pages.append((thumb(level0, 32), False, 7, "Aperio Image Library v12.0.15\r\nlabel 42x42"))
    pages.append((thumb(level0, 48), False, 7, "Aperio Image Library v12.0.15\r\nmacro 10x3"))

    bo = "<"
    out = io.BytesIO()
    out.write(b"II*\x00")
    out.write(struct.pack(bo + "I", 0))  # first-IFD offset patched later
    ofmt, inline, entry_hdr = "I", 4, "HHI"
    ifd_offsets = []

    for img, tiled, comp, desc in pages:
        h, w = img.shape[:2]
        offs, cnts = [], []
        if tiled:
            ntx, nty = -(-w // tile), -(-h // tile)
            for ty in range(nty):
                for tx in range(ntx):
                    t = np.zeros((tile, tile, 3), np.uint8)
                    part = img[ty * tile : (ty + 1) * tile, tx * tile : (tx + 1) * tile]
                    t[: part.shape[0], : part.shape[1]] = part
                    data = enc_tile(t)
                    offs.append(out.tell())
                    cnts.append(len(data))
                    out.write(data)
                    if out.tell() % 2:
                        out.write(b"\x00")
        else:
            rows_per_strip = 16
            for y in range(0, h, rows_per_strip):
                strip = img[y : y + rows_per_strip]
                b = io.BytesIO()
                Image.fromarray(strip).save(b, "JPEG", quality=quality)
                data = b.getvalue()
                offs.append(out.tell())
                cnts.append(len(data))
                out.write(data)
                if out.tell() % 2:
                    out.write(b"\x00")

        desc_b = desc.encode("latin-1") + b"\x00"
        photo = 6 if comp == 7 else 2
        tags = [
            (_W, 4, [w]), (_H, 4, [h]), (_BITS, 3, [8, 8, 8]),
            (_COMP, 3, [comp]), (_PHOTO, 3, [photo]),
            (_SPP, 3, [3]), (_PLANAR, 3, [1]),
            (_DESC, 2, [desc_b]),
        ]
        if tiled:
            tags += [
                (_TILE_W, 3, [tile]), (_TILE_H, 3, [tile]),
                (_TILE_OFF, 4, offs), (_TILE_CNT, 4, cnts),
            ]
        else:
            tags += [
                (_ROWS_PER_STRIP, 3, [16]),
                (_STRIP_OFF, 4, offs), (_STRIP_CNT, 4, cnts),
            ]

        tag_entries = []
        for tag, typ, vals in sorted(tags):
            if typ == 2:  # ASCII
                packed = vals[0]
                cnt = len(packed)
            else:
                fmt = _TYPE_FMT[typ]
                packed = struct.pack(bo + fmt * len(vals), *vals)
                cnt = len(vals)
            size = _TYPE_SIZE[typ] * cnt
            head = struct.pack(bo + entry_hdr, tag, typ, cnt)
            if size > inline:
                voff = out.tell()
                out.write(packed)
                if out.tell() % 2:
                    out.write(b"\x00")
                entry = head + struct.pack(bo + ofmt, voff)
            else:
                entry = head + packed.ljust(inline, b"\x00")
            tag_entries.append(entry)
        ifd_offsets.append(out.tell())
        out.write(struct.pack(bo + "H", len(tag_entries)))
        for e in tag_entries:
            out.write(e)
        out.write(struct.pack(bo + ofmt, 0))  # next-IFD patched below

    buf = bytearray(out.getvalue())
    buf[4:8] = struct.pack(bo + "I", ifd_offsets[0])
    for i in range(len(ifd_offsets) - 1):
        ifd = ifd_offsets[i]
        (n,) = struct.unpack(bo + "H", bytes(buf[ifd : ifd + 2]))
        ptr = ifd + 2 + n * 12
        buf[ptr : ptr + 4] = struct.pack(bo + "I", ifd_offsets[i + 1])
    with open(path, "wb") as f:
        f.write(buf)
