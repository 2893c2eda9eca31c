"""Slide access for the port's extraction CLI: flat rasters only (a copy of
``RasterSlide`` and part of ``open_slide``, ``mhim_mil_tpu/preprocess/tiff.py:711-809``).

The JAX package reads pyramidal TIFF / Aperio ``.svs``, Hamamatsu ``.ndpi``
and ``.vms``, MIRAX ``.mrxs``, Leica ``.scn`` and Ventana ``.bif`` with its
own native readers. Those readers are not ported yet (ROADMAP.md Queue 1
item 5b), so :func:`open_slide` raises ``NotImplementedError`` for every
such extension rather than reading the file as a flat raster.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# the extensions the JAX package routes to its native readers, and the
# vendor formats it names and refuses (tiff.py:77 _VENDOR_EXTS)
NATIVE_EXTS = (".ndpi", ".mrxs", ".vms", ".scn", ".bif", ".tif", ".tiff", ".svs", ".vmu", ".isyntax", ".svslide")


class RasterSlide:
    """A plain raster image (PNG, JPEG, BMP through PIL) behind the slide API
    the extraction reads: ``dimensions``, ``read_region`` at level 0 and
    ``get_thumbnail``."""

    def __init__(self, path: str):
        from PIL import Image

        self._img = np.asarray(Image.open(path).convert("RGB"))
        h, w = self._img.shape[:2]
        # API uniformity with the pyramidal readers (flat rasters carry no
        # scanner metadata or associated pages).
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


def open_slide(path: str) -> RasterSlide:
    """Open ``path`` as a flat raster. Raises ``NotImplementedError`` for
    the pyramidal and vendor formats, whose readers are not ported."""
    if path.lower().endswith(NATIVE_EXTS):
        raise NotImplementedError(
            f"{path}: the port reads flat rasters (PNG, JPEG, BMP) only; the pyramidal and vendor slide "
            "readers of mhim_mil_tpu/preprocess (TIFF/SVS, NDPI, MIRAX, VMS, SCN, BIF) are ROADMAP.md "
            "Queue 1 item 5b. Export level 0 as a raster, or use the JAX tool tools/extract_features.py")
    return RasterSlide(path)
