"""Attention-heatmap export (a copy of ``mhim_mil_tpu/utils/heatmap.py``):
per-slide instance attention → spatial grid, blended pixel overlays and ROI
sampling.

The reference renders attention heatmaps through the vendored CLAM stack
(reference: CLAM/create_heatmaps.py:35-437, CLAM/wsi_core/WholeSlideImage.py
:487-677 ``visHeatmap``, CLAM/wsi_core/wsi_utils.py:138 ``sample_rois``).
The models emit per-instance attention directly (``return_attn``); this
module provides

- :func:`attention_to_grid` / :func:`export_heatmap` — viewer-agnostic grid
  artifacts (``.npy``/``.csv``);
- :func:`render_heatmap_overlay` — the visHeatmap-style blended overlay for
  plain raster images (percentile normalization, per-pixel accumulation over
  possibly-overlapping patches, matplotlib colormap, alpha blend, optional
  binarize threshold);
- :func:`render_heatmap_pyramidal` — the same overlay at any pyramid level
  of a slide object, band by band;
- :func:`sample_rois` — CLAM's top-k / reverse-top-k / score-range ROI
  sampling over (score, coord) pairs.

numpy only; matplotlib is imported by the two renderers when they run.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def attention_to_grid(
    attn: np.ndarray,
    coords: Optional[np.ndarray] = None,
    normalize: str = "percentile",
) -> np.ndarray:
    """Rasterize per-instance attention ``[N]`` into a ``[H, W]`` grid.

    ``coords[N, 2]`` are integer patch-grid positions (data/readers.py
    ``coords_to_grid``); without coords a row-major square grid is assumed.
    ``normalize``: 'percentile' rescales scores to their empirical CDF (the
    reference's heatmap convention, CLAM/wsi_core/WholeSlideImage.py:560-570
    ``convert_to_percentiles``); 'minmax' or 'none' otherwise.
    """
    attn = np.asarray(attn, np.float64).reshape(-1)
    n = len(attn)
    if normalize == "percentile":
        order = attn.argsort().argsort()
        attn = (order + 1) / n
    elif normalize == "minmax":
        lo, hi = attn.min(), attn.max()
        attn = (attn - lo) / (hi - lo + 1e-12)

    if coords is None:
        w = int(np.ceil(np.sqrt(n)))
        h = int(np.ceil(n / w))
        grid = np.full((h, w), np.nan)
        grid.flat[:n] = attn
        return grid
    coords = np.asarray(coords, np.int64)
    h, w = coords[:, 1].max() + 1, coords[:, 0].max() + 1
    grid = np.full((h, w), np.nan)
    grid[coords[:, 1], coords[:, 0]] = attn
    return grid


def export_heatmap(
    out_dir: str,
    slide_id: str,
    attn: np.ndarray,
    coords: Optional[np.ndarray] = None,
    normalize: str = "percentile",
) -> Dict[str, str]:
    """Write ``<slide>_attn.npy`` (grid) and ``<slide>_attn.csv``
    (x, y, score rows) under ``out_dir``. Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    grid = attention_to_grid(attn, coords, normalize)
    npy = os.path.join(out_dir, f"{slide_id}_attn.npy")
    np.save(npy, grid)
    csv = os.path.join(out_dir, f"{slide_id}_attn.csv")
    attn = np.asarray(attn).reshape(-1)
    if coords is None:
        w = grid.shape[1]
        coords = np.stack([np.arange(len(attn)) % w, np.arange(len(attn)) // w], -1)
    with open(csv, "w") as f:
        f.write("x,y,score\n")
        for (x, y), s in zip(np.asarray(coords), attn):
            f.write(f"{x},{y},{s}\n")
    return {"npy": npy, "csv": csv}


def to_percentiles(scores: np.ndarray) -> np.ndarray:
    """Average-rank percentile scores in [0, 100] (reference
    wsi_utils.py:125-128 ``to_percentiles`` via scipy rankdata 'average')."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    order = scores.argsort(kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ties like rankdata(method='average')
    uniq, inv = np.unique(scores, return_inverse=True)
    sums = np.bincount(inv, weights=ranks)
    cnts = np.bincount(inv)
    ranks = (sums / cnts)[inv]
    return ranks / len(scores) * 100.0


def render_heatmap_overlay(
    image: np.ndarray,
    coords: np.ndarray,
    scores: np.ndarray,
    patch_size: int = 256,
    alpha: float = 0.4,
    cmap: str = "coolwarm",
    binarize: bool = False,
    thresh: float = 0.5,
    blank_canvas: bool = False,
    canvas_color=(220, 20, 50),
) -> np.ndarray:
    """Blend a color-mapped attention heatmap onto a raster image.

    The visHeatmap recipe (reference WholeSlideImage.py:487-677) for plain
    images: scores → percentiles/100; per-pixel score *accumulation* with an
    overlap counter (overlapping patches average); optional binarize at
    ``thresh``; matplotlib ``cmap``; ``alpha``-blend over the image (or a
    flat canvas). ``coords`` are level-0 (x, y) pixel positions.

    Returns the blended uint8 RGB image.
    """
    from matplotlib import colormaps

    img_h, img_w = image.shape[:2]
    scores = to_percentiles(scores) / 100.0
    coords = np.asarray(coords, np.int64)

    overlay = np.zeros((img_h, img_w), np.float64)
    counter = np.zeros((img_h, img_w), np.uint16)
    for (x, y), s in zip(coords, scores):
        if binarize:
            s = 1.0 if s >= thresh else 0.0
        y1, x1 = min(y + patch_size, img_h), min(x + patch_size, img_w)
        overlay[y:y1, x:x1] += s
        counter[y:y1, x:x1] += 1
    seen = counter > 0
    overlay[seen] /= counter[seen]
    if binarize:
        seen &= overlay >= thresh

    cm = colormaps[cmap]
    colored = (cm(np.clip(overlay, 0, 1))[..., :3] * 255).astype(np.uint8)
    base = (
        np.full_like(image[..., :3], np.asarray(canvas_color, np.uint8))
        if blank_canvas
        else image[..., :3]
    )
    out = base.copy()
    out[seen] = (
        alpha * colored[seen].astype(np.float64)
        + (1 - alpha) * base[seen].astype(np.float64)
    ).astype(np.uint8)
    return out


def sample_rois(
    scores: np.ndarray,
    coords: np.ndarray,
    k: int = 5,
    mode: str = "range_sample",
    seed: int = 1,
    score_start: float = 0.45,
    score_end: float = 0.55,
    top_left=None,
    bot_right=None,
) -> Dict[str, np.ndarray]:
    """ROI sampling over (score, coord) pairs (reference
    wsi_utils.py:138-159): ``topk`` / ``reverse_topk`` by score, or
    ``range_sample`` — uniform draw among patches whose percentile score
    falls in [score_start, score_end]. Optional bounding-box screen."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    coords = np.asarray(coords)
    scores = to_percentiles(scores)
    if top_left is not None and bot_right is not None:
        keep = np.all(coords >= np.asarray(top_left), axis=1) & np.all(
            coords <= np.asarray(bot_right), axis=1
        )
        scores, coords = scores[keep], coords[keep]

    if mode == "range_sample":
        lo, hi = score_start * 100.0, score_end * 100.0
        pool = np.flatnonzero((scores >= lo) & (scores <= hi))
        if len(pool) < 1:
            return {"sampled_coords": coords[:0], "sampled_scores": scores[:0]}
        rng = np.random.default_rng(seed)
        ids = rng.choice(pool, min(k, len(pool)), replace=False)
    elif mode == "topk":
        ids = scores.argsort()[::-1][:k]
    elif mode == "reverse_topk":
        ids = scores.argsort()[:k]
    else:
        raise NotImplementedError(mode)
    return {"sampled_coords": coords[ids], "sampled_scores": scores[ids]}


def render_heatmap_pyramidal(
    slide,
    coords: np.ndarray,
    scores: np.ndarray,
    patch_size: int = 256,
    vis_level: int = 1,
    alpha: float = 0.4,
    cmap: str = "coolwarm",
    binarize: bool = False,
    thresh: float = 0.5,
    blank_canvas: bool = False,
    canvas_color=(220, 20, 50),
    band_rows: int = 2048,
    tissue_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """visHeatmap-style blended overlay rendered at an ARBITRARY pyramid
    level, streaming band-by-band (reference
    CLAM/wsi_core/WholeSlideImage.py:487-677 renders block-wise at
    ``vis_level``; the thumbnail-only path of :func:`render_heatmap_overlay`
    covers flat rasters).

    ``slide`` is a ``preprocess.tiff`` slide object (``level_dimensions`` /
    ``level_downsamples`` / ``_read_level``); ``coords`` are level-0 (x, y)
    pixel positions, ``patch_size`` the level-0 patch edge. The per-pixel
    accumulate/average, binarize, colormap and alpha-blend math matches
    :func:`render_heatmap_overlay` pixel-for-pixel at the same scale; only
    the traversal is banded so a gigapixel level is never materialized twice.

    ``tissue_mask``: optional [h, w] bool array at ANY resolution — scaled
    by nearest-neighbor to ``vis_level`` and used to confine blending to
    tissue (the reference's segmentation-contour masking, visHeatmap
    ``segment``/``use_holes``).
    """
    from matplotlib import colormaps

    ds = slide.level_downsamples[vis_level]
    w, h = slide.level_dimensions[vis_level]
    scale = 1.0 / ds
    ps = max(int(patch_size * scale), 1)
    lv_coords = (np.asarray(coords, np.float64) * scale).astype(np.int64)
    sc = to_percentiles(scores) / 100.0
    if binarize:
        sc = (sc >= thresh).astype(np.float64)
    cm = colormaps[cmap]

    out = np.empty((h, w, 3), np.uint8)
    for y0 in range(0, h, band_rows):
        y1 = min(y0 + band_rows, h)
        bh = y1 - y0
        if blank_canvas:
            base = np.full((bh, w, 3), np.asarray(canvas_color, np.uint8))
        else:
            base = slide._read_level(0, y0, vis_level, (w, bh))
        overlay = np.zeros((bh, w), np.float64)
        counter = np.zeros((bh, w), np.uint16)
        live = (lv_coords[:, 1] + ps > y0) & (lv_coords[:, 1] < y1)
        for (x, y), s in zip(lv_coords[live], sc[live]):
            yy0, yy1 = max(y - y0, 0), min(y + ps - y0, bh)
            xx0, xx1 = max(x, 0), min(x + ps, w)
            if yy1 <= yy0 or xx1 <= xx0:
                continue
            overlay[yy0:yy1, xx0:xx1] += s
            counter[yy0:yy1, xx0:xx1] += 1
        seen = counter > 0
        overlay[seen] /= counter[seen]
        if binarize:
            seen &= overlay >= thresh
        if tissue_mask is not None:
            mh, mw = tissue_mask.shape[:2]
            ys = (np.arange(y0, y1) * mh // h).clip(0, mh - 1)
            xs = (np.arange(w) * mw // w).clip(0, mw - 1)
            seen &= tissue_mask[np.ix_(ys, xs)].astype(bool)
        colored = (cm(np.clip(overlay, 0, 1))[..., :3] * 255).astype(np.uint8)
        band = base.copy()
        band[seen] = (
            alpha * colored[seen].astype(np.float64)
            + (1 - alpha) * base[seen].astype(np.float64)
        ).astype(np.uint8)
        out[y0:y1] = band
    return out
