"""Tissue segmentation + patch-grid generation (numpy; no OpenCV/OpenSlide):
the port's copy of ``mhim_mil_tpu/preprocess/segment.py``, whose masks and
coordinates it gives bit for bit.

Reference: CLAM/wsi_core/WholeSlideImage.py:91-183 ``segmentTissue`` (Otsu /
binary threshold on the saturation channel, morphological cleanup, contour
area filtering) and :371-485 ``process_contours`` (grid coords inside
tissue). Re-implemented on numpy over a downsampled RGB thumbnail: the same
HSV-saturation + median-blur + Otsu recipe, connected-component area
filtering instead of OpenCV contours, and patch-grid candidates accepted by
tissue coverage. :func:`_connected_components` is a Python union-find over
every pixel of the thumbnail, as in the JAX package: on a 2048 × 2048
thumbnail it takes seconds of host time.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def rgb_to_saturation(img: np.ndarray) -> np.ndarray:
    """HSV saturation channel of an RGB uint8 image (CLAM segments on S —
    WholeSlideImage.py:100)."""
    img = img.astype(np.float32) / 255.0
    mx = img.max(-1)
    mn = img.min(-1)
    return np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-8), 0.0)


def median_blur(x: np.ndarray, k: int = 7) -> np.ndarray:
    """Separable-ish median filter via sliding windows (k odd)."""
    p = k // 2
    xp = np.pad(x, p, mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(xp, (k, k))
    return np.median(windows, axis=(-2, -1))


def otsu_threshold(x: np.ndarray, bins: int = 256) -> float:
    """Otsu's threshold on a [0,1] float image."""
    hist, edges = np.histogram(x.reshape(-1), bins=bins, range=(0.0, 1.0))
    hist = hist.astype(np.float64)
    p = hist / max(hist.sum(), 1)
    omega = np.cumsum(p)
    mu = np.cumsum(p * (np.arange(bins) + 0.5) / bins)
    mu_t = mu[-1]
    denom = omega * (1 - omega)
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_b = (mu_t * omega - mu) ** 2 / np.maximum(denom, 1e-12)
    return float(edges[np.nanargmax(sigma_b)])


def _connected_components(mask: np.ndarray) -> np.ndarray:
    """4-connected component labelling (two-pass union-find)."""
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    parent = [0]

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    nxt = 1
    for i in range(h):
        for j in range(w):
            if not mask[i, j]:
                continue
            up = labels[i - 1, j] if i else 0
            left = labels[i, j - 1] if j else 0
            if up and left:
                ru, rl = find(up), find(left)
                labels[i, j] = ru
                if ru != rl:
                    parent[max(ru, rl)] = min(ru, rl)
            elif up or left:
                labels[i, j] = up or left
            else:
                parent.append(nxt)
                labels[i, j] = nxt
                nxt += 1
    for i in range(h):
        for j in range(w):
            if labels[i, j]:
                labels[i, j] = find(labels[i, j])
    return labels


def segment_tissue(
    img: np.ndarray,
    sthresh: int = 0,
    blur_k: int = 7,
    min_area_frac: float = 1e-4,
) -> np.ndarray:
    """Boolean tissue mask of an RGB thumbnail (reference segmentTissue
    WholeSlideImage.py:91-183: S-channel → median blur → Otsu/binary →
    area-filtered regions)."""
    s = median_blur(rgb_to_saturation(img), blur_k)
    t = otsu_threshold(s) if sthresh <= 0 else sthresh / 255.0
    mask = s > t
    labels = _connected_components(mask)
    if labels.max() == 0:
        return mask
    areas = np.bincount(labels.reshape(-1))
    min_area = min_area_frac * mask.size
    keep = np.flatnonzero(areas >= min_area)
    keep = keep[keep != 0]
    return np.isin(labels, keep)


def generate_patch_coords(
    tissue_mask: np.ndarray,
    image_hw: Tuple[int, int],
    patch_size: int = 256,
    step_size: int = 256,
    coverage: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Grid patch coords whose tissue coverage exceeds ``coverage``
    (reference process_contours WholeSlideImage.py:371-485; CLAM checks the
    patch centre/four-point containment, coverage is the mask-native
    analogue). Returns CLAM-style ``{'coords': [N,2] (x,y) level-0 px,
    'patch_size', 'downsample'}``."""
    ih, iw = image_hw
    mh, mw = tissue_mask.shape
    sy, sx = ih / mh, iw / mw
    xs = np.arange(0, iw - patch_size + 1, step_size)
    ys = np.arange(0, ih - patch_size + 1, step_size)
    coords = []
    for y in ys:
        my0, my1 = int(y / sy), max(int((y + patch_size) / sy), int(y / sy) + 1)
        for x in xs:
            mx0, mx1 = int(x / sx), max(int((x + patch_size) / sx), int(x / sx) + 1)
            cov = tissue_mask[my0:my1, mx0:mx1].mean()
            if cov >= coverage:
                coords.append((x, y))
    return {
        "coords": np.asarray(coords, np.int64).reshape(-1, 2),
        "patch_size": patch_size,
        "downsample": np.asarray([1, 1]),
    }
