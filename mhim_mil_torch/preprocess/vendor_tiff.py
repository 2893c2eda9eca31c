"""Philips TIFF, Leica SCN and Ventana BIF readers — TIFF-contained
vendor layouts.

A copy of ``mhim_mil_tpu/preprocess/vendor_tiff.py``.

The reference opens all three through OpenSlide's vendor drivers
(`CLAM/wsi_core/WholeSlideImage.py:22-90` calls ``openslide.open_slide``
unconditionally; OpenSlide routes by content signature). These formats
are structurally plain tiled TIFFs — the vendor part is the *layout*:
which pages form the pyramid, where label/macro live, and where the
microns-per-pixel metadata hides. The readers here subclass
:class:`~mhim_mil_torch.preprocess.tiff.PyramidalTiff` and override only
``_build_layout``, so tile decode / region access / caching stay shared
with the generic reader.

Philips TIFF (what OpenSlide's ``philips-tiff`` driver reads):
  * detected by the ``DataObject ObjectType="DPUfsImport"`` XML in the
    first page's ImageDescription (or a ``Philips`` Software tag);
  * tiled pages form the pyramid; striped pages whose description says
    ``Label`` / ``Macro`` are associated images;
  * background tiles are simply ABSENT (TileOffset/ByteCount 0) and render
    as white — the ``sparse_fill`` hook in the shared tile decoder;
  * ``DICOM_PIXEL_SPACING`` (millimetres) in the XML → ``openslide.mpp-*``
    (micrometres); scalar XML attributes land under ``philips.<Name>``.

Leica SCN (what OpenSlide's ``leica`` driver reads):
  * the first page's ImageDescription is an ``<scn>`` XML document mapping
    TIFF directory indices to images: a ``collection`` (slide bounds in
    nanometres) containing ``image`` elements, each with ``dimension``
    entries (``ifd``/``r``) and a ``view`` (offset/size in nm);
  * the image whose view covers the whole collection is the macro
    (associated image); the remaining image is the main pyramid;
  * mpp is derived view-size(nm) / pixels, objective from scanSettings.

Ventana BIF (the single-AOI subset of OpenSlide's ``ventana`` driver):
  * detected by an ``iScan`` element in a page's XMP packet (tag 700) or
    the ``.bif`` extension; ``ScanRes`` (microns/pixel) →
    ``openslide.mpp-*``, ``Magnification`` → objective power, scalar
    ``iScan`` attributes under ``ventana.<Name>``;
  * tiled pages form the pyramid; striped ``Thumbnail`` / ``Label`` /
    ``Macro`` pages are associated images.

Out of scope, raised as named ``UnsupportedVendorFormatError`` with a
conversion recipe: multi-region SCN slides (several main images placed on
the collection grid — OpenSlide composes them; convert via vips), SCN
z-stacks (extra focal planes), multi-AOI BIF slides (OpenSlide composes
the areas of interest with overlap-joint arithmetic), and Philips
iSyntax (not a TIFF at all, ``.isyntax`` stays named-unsupported in
``tiff.open_slide``).
"""

from __future__ import annotations

import io
import re
import struct
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from .tiff import (
    UnsupportedTiffError,
    UnsupportedVendorFormatError,
    _CONVERT_HINT,
    _BITS,
    _COMP,
    _DESC,
    _H,
    _PHOTO,
    _PLANAR,
    _ROWS_PER_STRIP,
    _SOFTWARE,
    _SPP,
    _STRIP_CNT,
    _STRIP_OFF,
    _TILE_CNT,
    _TILE_H,
    _TILE_OFF,
    _TILE_W,
    _TYPE_FMT,
    _TYPE_SIZE,
    _W,
    _XMP,
    _Page,
    PyramidalTiff,
)


def _local(tag: str) -> str:
    """Element tag without its XML namespace."""
    return tag.rsplit("}", 1)[-1]


# ---- Philips TIFF ------------------------------------------------------------


class PhilipsTiff(PyramidalTiff):
    """Philips TIFF layout over the shared pyramidal-TIFF machinery.

    Same API surface as :class:`~mhim_mil_torch.preprocess.tiff.PyramidalTiff`
    (the surface the reference consumes through openslide,
    CLAM/dataset_modules/dataset_h5.py:79-84).
    """

    def _build_layout(self, raw: List[Dict[int, tuple]]) -> None:
        pages = [_Page(t) for t in raw]
        self.properties: Dict[str, str] = {"openslide.vendor": "philips"}
        self._assoc_pages: Dict[str, _Page] = {}

        levels = []
        for p in pages:
            d = p.description.strip().lower()
            if p.tiled:
                # background tiles are absent from the file; OpenSlide's
                # philips driver renders them as white
                p.sparse_fill = 255
                levels.append(p)
            elif "label" in d[:64]:
                self._assoc_pages.setdefault("label", p)
            elif "macro" in d[:64]:
                self._assoc_pages.setdefault("macro", p)
        if not levels:
            raise UnsupportedTiffError("Philips TIFF has no tiled pyramid pages")
        levels.sort(key=lambda p: -p.width)
        self._pages = levels
        self._parse_philips_xml(pages[0].description)

    def _parse_philips_xml(self, desc: str) -> None:
        """Scalar ``Attribute`` values → ``philips.<Name>`` properties;
        ``DICOM_PIXEL_SPACING`` (mm, IDoubleArray of quoted strings) →
        ``openslide.mpp-x/y`` in micrometres."""
        if "<DataObject" not in desc:
            return
        try:
            root = ET.fromstring(desc)
        except ET.ParseError:
            return
        spacing: Optional[List[float]] = None
        for el in root.iter():
            if _local(el.tag) != "Attribute":
                continue
            name = el.get("Name")
            if not name:
                continue
            text = (el.text or "").strip()
            if name == "DICOM_PIXEL_SPACING" and spacing is None:
                vals = [float(v) for v in re.findall(r"[\d.eE+-]+", text)]
                spacing = [v for v in vals if v > 0][:2]
            if text and len(el) == 0:
                self.properties.setdefault(f"philips.{name}", text)
        if spacing:
            # DICOM pixel spacing is (row, column) in millimetres
            mpp_y = spacing[0] * 1000.0
            mpp_x = (spacing[1] if len(spacing) > 1 else spacing[0]) * 1000.0
            self.properties["openslide.mpp-x"] = f"{mpp_x:.6f}"
            self.properties["openslide.mpp-y"] = f"{mpp_y:.6f}"


# ---- Leica SCN ---------------------------------------------------------------


class _ScnImage:
    """One ``image`` element of the SCN XML: dimension (ifd, r, w, h)
    entries plus the view rectangle in collection nanometres."""

    def __init__(self, el: ET.Element):
        self.name = el.get("name", "")
        self.dims: List[Tuple[int, int, int, int]] = []  # (r, ifd, w, h)
        self.view = (0, 0, 0, 0)
        self.objective: Optional[str] = None
        self.px_w = self.px_h = 0
        for child in el.iter():
            t = _local(child.tag)
            if t == "pixels":
                self.px_w = int(child.get("sizeX", 0))
                self.px_h = int(child.get("sizeY", 0))
            elif t == "dimension":
                if child.get("z") not in (None, "0"):
                    raise UnsupportedVendorFormatError(
                        "Leica SCN with z-stack focal planes is not "
                        f"supported; {_CONVERT_HINT}"
                    )
                self.dims.append((
                    int(child.get("r", 0)),
                    int(child.get("ifd")),
                    int(child.get("sizeX", 0)),
                    int(child.get("sizeY", 0)),
                ))
            elif t == "view":
                self.view = (
                    int(child.get("offsetX", 0)),
                    int(child.get("offsetY", 0)),
                    int(child.get("sizeX", 0)),
                    int(child.get("sizeY", 0)),
                )
            elif t == "objective":
                self.objective = (child.text or "").strip()
        self.dims.sort()


class LeicaScn(PyramidalTiff):
    """Leica SCN layout over the shared pyramidal-TIFF machinery.

    The image whose view covers the whole collection is the macro photo
    (exposed as ``associated_images['macro']``, the name OpenSlide uses);
    the single remaining image is the main pyramid. Multi-region slides
    raise the named vendor error (OpenSlide composes regions onto the
    collection grid; this subset does not).
    """

    def _build_layout(self, raw: List[Dict[int, tuple]]) -> None:
        desc = _Page(raw[0]).description
        start = desc.find("<scn")
        if start < 0:
            raise UnsupportedTiffError("no <scn> XML in the first page")
        try:
            root = ET.fromstring(desc[start:])
        except ET.ParseError as e:
            raise UnsupportedTiffError(f"malformed SCN XML: {e}")

        collection = None
        for el in root.iter():
            if _local(el.tag) == "collection":
                collection = el
                break
        if collection is None:
            raise UnsupportedTiffError("SCN XML without a collection element")
        coll_w = int(collection.get("sizeX", 0))
        coll_h = int(collection.get("sizeY", 0))
        images = [
            _ScnImage(el) for el in collection
            if _local(el.tag) == "image"
        ]
        if not images:
            raise UnsupportedTiffError("SCN collection has no images")

        macro = [
            im for im in images
            if im.view[:2] == (0, 0) and im.view[2:] == (coll_w, coll_h)
        ]
        main = [im for im in images if im not in macro]
        if not main:  # macro-only slide: treat the macro as the image
            main, macro = macro, []
        if len(main) > 1:
            raise UnsupportedVendorFormatError(
                f"Leica SCN with {len(main)} scanned regions: OpenSlide "
                "composes multiple regions onto the collection grid, this "
                f"reader supports single-region slides; {_CONVERT_HINT}"
            )
        im = main[0]
        if not im.dims:
            raise UnsupportedTiffError("SCN main image has no dimension entries")

        self.properties: Dict[str, str] = {"openslide.vendor": "leica"}
        self._assoc_pages: Dict[str, _Page] = {}
        levels = []
        for _r, ifd, _w, _h in im.dims:
            if ifd < 0 or ifd >= len(raw):
                raise UnsupportedTiffError(f"SCN dimension ifd {ifd} out of range")
            levels.append(_Page(raw[ifd]))
        levels.sort(key=lambda p: -p.width)
        self._pages = levels
        if macro and macro[0].dims:
            self._assoc_pages["macro"] = _Page(raw[macro[0].dims[0][1]])

        if im.objective:
            self.properties["openslide.objective-power"] = im.objective
        if im.view[2] and im.px_w and im.view[3] and im.px_h:
            # view size is nanometres; mpp is micrometres/pixel
            self.properties["openslide.mpp-x"] = f"{im.view[2] / im.px_w / 1000.0:.6f}"
            self.properties["openslide.mpp-y"] = f"{im.view[3] / im.px_h / 1000.0:.6f}"
        if im.name:
            self.properties["leica.image-name"] = im.name
        for el in root.iter():
            if _local(el.tag) == "device":
                model = el.get("model")
                if model:
                    self.properties["leica.device-model"] = model
                break


# ---- Ventana BIF -------------------------------------------------------------


class VentanaBif(PyramidalTiff):
    """Ventana BIF layout over the shared pyramidal-TIFF machinery —
    the single-AOI subset of what OpenSlide's ``ventana`` driver reads.

    BIF keeps its scanner metadata in an ``iScan`` element inside the XMP
    packet (tag 700): ``ScanRes`` is microns/pixel → ``openslide.mpp-*``,
    ``Magnification`` → ``openslide.objective-power``, every scalar
    attribute lands under ``ventana.<Name>``. Tiled pages form the
    pyramid; striped pages whose description names them ``Label`` /
    ``Thumbnail`` / ``Macro`` are associated images. Slides scanned as
    multiple areas of interest (OpenSlide composes the AOIs with
    overlap-joint arithmetic from the directory XMP) raise the named
    vendor error — the single-AOI mosaic is a plain pyramid.
    """

    def _build_layout(self, raw: List[Dict[int, tuple]]) -> None:
        from .tiff import _XMP, _tag_bytes

        xmp = b""
        for t in raw:
            xmp = _tag_bytes(t, _XMP)
            if b"iScan" in xmp:
                break
        iscan: Optional[ET.Element] = None
        if xmp:
            try:
                root = ET.fromstring(xmp.split(b"\x00", 1)[0].decode(
                    "utf-8", "replace").strip())
                for el in root.iter():
                    if _local(el.tag) == "iScan":
                        iscan = el
                        break
                if iscan is None and _local(root.tag) == "iScan":
                    iscan = root
            except ET.ParseError:
                iscan = None

        self.properties: Dict[str, str] = {"openslide.vendor": "ventana"}
        if iscan is not None:
            n_aois = 1
            for key in ("NumberOfAOIs", "TotalAOIs"):
                if iscan.get(key):
                    n_aois = int(float(iscan.get(key)))
            aoi_els = [
                el for el in iscan.iter() if "AOI" in _local(el.tag)
            ]
            if n_aois > 1 or len(aoi_els) > 1:
                raise UnsupportedVendorFormatError(
                    f"Ventana BIF with {max(n_aois, len(aoi_els))} areas of "
                    "interest: OpenSlide composes AOIs with overlap-joint "
                    "arithmetic, this reader supports single-AOI slides; "
                    f"{_CONVERT_HINT}"
                )
            for name, val in iscan.attrib.items():
                self.properties.setdefault(f"ventana.{name}", val)
            res = iscan.get("ScanRes")  # microns per pixel
            if res:
                self.properties["openslide.mpp-x"] = f"{float(res):.6f}"
                self.properties["openslide.mpp-y"] = f"{float(res):.6f}"
            mag = iscan.get("Magnification")
            if mag:
                self.properties["openslide.objective-power"] = mag

        self._assoc_pages: Dict[str, _Page] = {}
        levels = []
        for t in raw:
            p = _Page(t)
            d = p.description.strip().lower()
            if p.tiled:
                levels.append(p)
            elif "label" in d[:64]:
                self._assoc_pages.setdefault("label", p)
            elif "thumbnail" in d[:64]:
                self._assoc_pages.setdefault("thumbnail", p)
            elif "macro" in d[:64]:
                self._assoc_pages.setdefault("macro", p)
        if not levels:
            raise UnsupportedTiffError("Ventana BIF has no tiled pyramid pages")
        levels.sort(key=lambda p: -p.width)
        self._pages = levels


# ---- fixture writers ---------------------------------------------------------


def _encode_page(img: np.ndarray, comp: str, quality: int) -> List[bytes]:
    """Encode one striped page (16-row JPEG strips, like real label/macro
    pages) — tiled pages are encoded tile-by-tile in ``_write_tiff``."""
    from PIL import Image

    out = []
    for y in range(0, img.shape[0], 16):
        b = io.BytesIO()
        Image.fromarray(img[y : y + 16]).save(b, "JPEG", quality=quality)
        out.append(b.getvalue())
    return out


def _write_tiff(path: str, pages: List[dict]) -> None:
    """Minimal classic-TIFF writer for the vendor fixtures. Each page dict:
    ``img`` (RGB uint8), ``tiled`` (bool), ``tile`` (int), ``comp``
    ('jpeg'|'raw'), ``desc``/``software`` (optional str), ``quality``,
    ``sparse`` (set of (ty, tx) tiles written as ABSENT — offset/count 0,
    the Philips background-tile layout)."""
    from PIL import Image

    bo = "<"
    out = io.BytesIO()
    out.write(b"II*\x00")
    out.write(struct.pack(bo + "I", 0))  # first-IFD offset patched below
    ifd_offsets: List[int] = []

    for spec in pages:
        img = spec["img"]
        tiled = spec.get("tiled", True)
        tile = spec.get("tile", 128)
        comp = spec.get("comp", "jpeg")
        quality = spec.get("quality", 92)
        sparse = spec.get("sparse", set())
        h, w = img.shape[:2]
        offs, cnts = [], []
        if tiled:
            ntx, nty = -(-w // tile), -(-h // tile)
            for ty in range(nty):
                for tx in range(ntx):
                    if (ty, tx) in sparse:
                        offs.append(0)
                        cnts.append(0)
                        continue
                    t = np.zeros((tile, tile, 3), np.uint8)
                    part = img[ty * tile : (ty + 1) * tile,
                               tx * tile : (tx + 1) * tile]
                    t[: part.shape[0], : part.shape[1]] = part
                    if comp == "jpeg":
                        b = io.BytesIO()
                        Image.fromarray(t).save(b, "JPEG", quality=quality)
                        data = b.getvalue()
                    else:
                        data = t.tobytes()
                    offs.append(out.tell())
                    cnts.append(len(data))
                    out.write(data)
                    if out.tell() % 2:
                        out.write(b"\x00")
        else:
            for data in _encode_page(img, comp, quality):
                offs.append(out.tell())
                cnts.append(len(data))
                out.write(data)
                if out.tell() % 2:
                    out.write(b"\x00")

        comp_code = 7 if comp == "jpeg" else 1
        tags = [
            (_W, 4, [w]), (_H, 4, [h]), (_BITS, 3, [8, 8, 8]),
            (_COMP, 3, [comp_code]), (_PHOTO, 3, [6 if comp == "jpeg" else 2]),
            (_SPP, 3, [3]), (_PLANAR, 3, [1]),
        ]
        if spec.get("desc"):
            tags.append((_DESC, 2, [spec["desc"].encode("latin-1") + b"\x00"]))
        if spec.get("software"):
            tags.append((_SOFTWARE, 2, [spec["software"].encode("latin-1") + b"\x00"]))
        if spec.get("xmp"):
            # XMP packet as a BYTE array (type 1), the layout real scanners use
            tags.append((_XMP, 1, list(spec["xmp"])))
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

        entries = []
        for tag, typ, vals in sorted(tags):
            if typ == 2:  # ASCII
                packed = vals[0]
                cnt = len(packed)
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


def _downsamples(level0: np.ndarray, levels: int) -> List[np.ndarray]:
    imgs = [level0]
    for _ in range(1, levels):
        prev = imgs[-1]
        h, w = prev.shape[:2]
        h2, w2 = h // 2 * 2, w // 2 * 2
        ds = prev[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2, 3).mean((1, 3))
        imgs.append(ds.astype(np.uint8))
    return imgs


def write_philips_tiff(
    path: str,
    level0: np.ndarray,
    levels: int = 2,
    tile: int = 128,
    mpp: float = 0.25,
    sparse: Optional[set] = None,
    compression: str = "jpeg",
    quality: int = 92,
) -> None:
    """Write an RGB image in the Philips TIFF layout (fixture twin of what
    OpenSlide's philips-tiff driver reads): tiled pyramid pages, the
    ``DPUfsImport`` XML (with ``DICOM_PIXEL_SPACING`` in millimetres) as
    the first page's ImageDescription, a Philips Software tag, striped
    ``Label`` / ``Macro`` associated pages, and — via ``sparse``, a set of
    level-0 ``(ty, tx)`` tiles — background tiles stored as ABSENT
    (offset/count 0)."""
    assert level0.ndim == 3 and level0.shape[2] == 3 and level0.dtype == np.uint8
    mm = mpp / 1000.0
    xml = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<DataObject ObjectType="DPUfsImport">'
        '<Attribute Name="PIM_DP_SCANNED_IMAGES" PMSVR="IDataObjectArray">'
        '<Array><DataObject ObjectType="DPScannedImage">'
        '<Attribute Name="PIM_DP_IMAGE_TYPE" PMSVR="IString">WSI</Attribute>'
        f'<Attribute Name="DICOM_PIXEL_SPACING" PMSVR="IDoubleArray">'
        f'&quot;{mm:.9f}&quot; &quot;{mm:.9f}&quot;</Attribute>'
        "</DataObject></Array></Attribute>"
        '<Attribute Name="DICOM_MANUFACTURER" PMSVR="IString">PHILIPS</Attribute>'
        "</DataObject>"
    )
    imgs = _downsamples(level0, levels)

    def thumb(max_w: int) -> np.ndarray:
        step = max(1, level0.shape[1] // max_w)
        return level0[::step, ::step]

    pages = [dict(img=imgs[0], tiled=True, tile=tile, comp=compression,
                  quality=quality, desc=xml, software="Philips DP v1.0",
                  sparse=sparse or set())]
    for ds_img in imgs[1:]:
        pages.append(dict(img=ds_img, tiled=True, tile=tile, comp=compression,
                          quality=quality))
    pages.append(dict(img=thumb(40), tiled=False, comp="jpeg", desc="Label"))
    pages.append(dict(img=thumb(64), tiled=False, comp="jpeg", desc="Macro"))
    _write_tiff(path, pages)


def write_ventana_bif(
    path: str,
    level0: np.ndarray,
    levels: int = 2,
    tile: int = 128,
    mpp: float = 0.25,
    magnification: int = 20,
    aois: int = 1,
    quality: int = 92,
) -> None:
    """Write an RGB image in the Ventana BIF layout (fixture twin of the
    single-AOI subset of what OpenSlide's ventana driver reads): tiled
    pyramid pages, the ``iScan`` element (ScanRes in microns/pixel,
    Magnification, NumberOfAOIs) inside an XMP packet on the first page,
    striped ``Thumbnail`` / ``Label`` associated pages. ``aois > 1``
    writes the multi-AOI metadata this reader names as unsupported."""
    assert level0.ndim == 3 and level0.shape[2] == 3 and level0.dtype == np.uint8
    xmp = (
        '<?xpacket begin="" id="W5M0MpCehiHzreSzNTczkc9d"?>'
        '<x:xmpmeta xmlns:x="adobe:ns:meta/">'
        '<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">'
        "<rdf:Description>"
        f'<iScan Magnification="{magnification}" ScanRes="{mpp:g}" '
        f'UnitNumber="1" NumberOfAOIs="{aois}" ShowLabel="1" Z-layers="1"/>'
        "</rdf:Description></rdf:RDF></x:xmpmeta>"
    ).encode("utf-8")
    imgs = _downsamples(level0, levels)

    def thumb(max_w: int) -> np.ndarray:
        step = max(1, level0.shape[1] // max_w)
        return level0[::step, ::step]

    pages = [dict(img=imgs[0], tiled=True, tile=tile, comp="jpeg",
                  quality=quality, xmp=xmp, desc="level=0 mag=40 quality=94")]
    for ds_img in imgs[1:]:
        pages.append(dict(img=ds_img, tiled=True, tile=tile, comp="jpeg",
                          quality=quality))
    pages.append(dict(img=thumb(64), tiled=False, comp="jpeg", desc="Thumbnail"))
    pages.append(dict(img=thumb(40), tiled=False, comp="jpeg", desc="Label"))
    _write_tiff(path, pages)


def write_leica_scn(
    path: str,
    level0: np.ndarray,
    levels: int = 2,
    tile: int = 128,
    mpp: float = 0.5,
    objective: int = 20,
    regions: int = 1,
    quality: int = 92,
) -> None:
    """Write an RGB image in the Leica SCN layout (fixture twin of what
    OpenSlide's leica driver reads): the ``<scn>`` XML on the first page
    mapping directory indices to images, a macro image whose view covers
    the whole collection, and a main region pyramid. ``regions > 1``
    duplicates the main image at a second view offset — the multi-region
    case this reader names as unsupported."""
    assert level0.ndim == 3 and level0.shape[2] == 3 and level0.dtype == np.uint8
    imgs = _downsamples(level0, levels)
    h0, w0 = level0.shape[:2]
    nm_w = int(round(w0 * mpp * 1000))  # collection/view sizes in nanometres
    nm_h = int(round(h0 * mpp * 1000))
    coll_w, coll_h = nm_w * 2, nm_h * 2  # slide is larger than the scan
    step = max(1, w0 // 64)
    macro_img = level0[::step, ::step]
    ns = "http://www.leica-microsystems.com/scn/2010/10/01"

    def image_xml(name, px, dims, view, obj):
        d = "".join(
            f'<dimension sizeX="{w}" sizeY="{h}" r="{r}" ifd="{ifd}"/>'
            for r, ifd, w, h in dims
        )
        return (
            f'<image name="{name}"><pixels sizeX="{px[0]}" sizeY="{px[1]}">'
            f"{d}</pixels>"
            f'<view sizeX="{view[2]}" sizeY="{view[3]}" '
            f'offsetX="{view[0]}" offsetY="{view[1]}"/>'
            "<scanSettings><objectiveSettings>"
            f"<objective>{obj}</objective>"
            "</objectiveSettings></scanSettings></image>"
        )

    mh, mw = macro_img.shape[:2]
    parts = [image_xml("macro", (mw, mh), [(0, 0, mw, mh)],
                       (0, 0, coll_w, coll_h), "0.8")]
    ifd = 1
    for r_i in range(regions):
        dims = []
        for lv, img in enumerate(imgs):
            ih, iw = img.shape[:2]
            dims.append((lv, ifd, iw, ih))
            ifd += 1
        parts.append(image_xml(
            f"region{r_i}", (w0, h0), dims,
            (nm_w // 4 + r_i * nm_w, nm_h // 4, nm_w, nm_h), str(objective),
        ))
    xml = (
        '<?xml version="1.0" encoding="UTF-8"?>'
        f'<scn xmlns="{ns}">'
        f'<device model="Leica SCN400" version="1.0"/>'
        f'<collection sizeX="{coll_w}" sizeY="{coll_h}">'
        + "".join(parts) + "</collection></scn>"
    )

    pages = [dict(img=macro_img, tiled=True, tile=tile, comp="jpeg",
                  quality=quality, desc=xml)]
    for _ in range(regions):
        for img in imgs:
            pages.append(dict(img=img, tiled=True, tile=tile, comp="jpeg",
                              quality=quality))
    _write_tiff(path, pages)
