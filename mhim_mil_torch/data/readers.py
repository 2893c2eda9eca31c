"""Feature-store readers: CLAM ``pt_files/*.pt`` + ``h5_files/*.h5`` (a copy
of ``mhim_mil_tpu/data/readers.py``).

Reference: datasets/dataset_feat.py:10-260 (FeatClsDataset / FeatSurvDataset)
and datasets/data_utils.py:86-162 (h5 coords → integer grid positions).
Host-side IO only — features land in numpy and enter the device through the
length-bucketed batcher (data/bucketing.py). ``.pt`` tensors are read with
``torch.load(weights_only=True)``; ``h5py`` is imported only when a
coordinate file is read.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .splits import map_labels


def load_pt_features(path: str) -> np.ndarray:
    """Read one ``pt_files/<slide>.pt`` bag as float32 ``[N, D]``."""
    t = torch.load(path, map_location="cpu", weights_only=True)
    return np.asarray(t.float().numpy(), np.float32)


def load_h5_features(path: str):
    """Read a CLAM ``h5_files/<slide>.h5``: returns (features or None, coords
    or None)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading {path!r} needs h5py, which is not installed") from e

    with h5py.File(path, "r") as f:
        feats = np.asarray(f["features"], np.float32) if "features" in f else None
        coords = np.asarray(f["coords"]) if "coords" in f else None
        attrs = dict(f["coords"].attrs) if "coords" in f else {}
    return feats, coords, attrs


def coords_to_grid(coords: np.ndarray, attrs: Dict) -> np.ndarray:
    """Convert level-0 pixel coords to integer patch-grid positions
    (reference get_seq_pos_fn data_utils.py:110-162): divide by
    ``patch_size_level0 = patch_size * downsample`` and shift to origin."""
    patch_size = int(attrs.get("patch_size", 256))
    # downsample is a per-axis 2-vector in CLAM h5 attrs; real scanners can
    # report anisotropic values, so each axis gets its own level-0 step
    # (reference multiplies the full vector: data_utils.py:123 and divides
    # coords per-axis :134-136)
    downsample = np.asarray(attrs.get("downsample", [1, 1]), np.float64).reshape(-1)
    if downsample.size == 1:
        downsample = np.repeat(downsample, 2)
    step = np.maximum((patch_size * downsample[:2]).astype(np.int64), 1)
    grid = (coords // step[None, :]).astype(np.int64)
    grid -= grid.min(axis=0, keepdims=True)
    return grid


def match_slides(patient_id: str, files: Sequence[str]) -> List[str]:
    """All feature files belonging to a patient/slide id — substring match
    over the store listing (reference dataset_feat.py:31-44)."""
    return sorted(f for f in files if patient_id in f)


class FeatureBagStore:
    """Lazy bag store over a CLAM-layout feature root.

    Layout: ``root/pt_files/*.pt`` (features) and optionally
    ``root/h5_files/*.h5`` (coords). ``persistence`` preloads everything to
    RAM (reference dataset_feat.py:36-41).
    """

    def __init__(self, root: str, h5_root: Optional[str] = None, persistence: bool = False):
        self.pt_dir = os.path.join(root, "pt_files") if os.path.isdir(
            os.path.join(root, "pt_files")
        ) else root
        self.h5_dir = h5_root or os.path.join(root, "h5_files")
        self.files = sorted(
            f for f in os.listdir(self.pt_dir) if f.endswith(".pt")
        )
        self.persistence = persistence
        self._cache: Dict[str, np.ndarray] = {}

    def load(self, fname: str) -> np.ndarray:
        if fname in self._cache:
            return self._cache[fname]
        feats = load_pt_features(os.path.join(self.pt_dir, fname))
        if self.persistence:
            self._cache[fname] = feats
        return feats

    def prefetch(self, fnames, num_workers: int = 6) -> None:
        """Load many bags concurrently into the cache — the counterpart of
        the reference's DataLoader worker pool (``--num_workers``,
        datasets/dataloader.py:35); torch/h5 decoding releases the GIL, so a
        thread pool gives real parallel IO. No-op for workers <= 1."""
        todo = [f for f in dict.fromkeys(fnames) if f not in self._cache]
        if num_workers <= 1 or len(todo) < 2:
            return
        from concurrent.futures import ThreadPoolExecutor

        def _one(f):
            return f, load_pt_features(os.path.join(self.pt_dir, f))

        with ThreadPoolExecutor(max_workers=num_workers) as ex:
            for f, feats in ex.map(_one, todo):
                self._cache[f] = feats

    def coords(self, fname: str) -> Optional[np.ndarray]:
        h5 = os.path.join(self.h5_dir, fname.replace(".pt", ".h5"))
        if not os.path.exists(h5):
            return None
        _, coords, attrs = load_h5_features(h5)
        return coords_to_grid(coords, attrs) if coords is not None else None

    def pixel_coords(self, fname: str) -> Optional[np.ndarray]:
        """Raw level-0 (x, y) pixel coordinates — for heatmap overlays."""
        h5 = os.path.join(self.h5_dir, fname.replace(".pt", ".h5"))
        if not os.path.exists(h5):
            return None
        _, coords, _ = load_h5_features(h5)
        return coords


def build_cls_slides(
    store: FeatureBagStore,
    ids: Sequence[str],
    labels: Sequence,
    dataset: str,
    with_pos: bool = False,
    num_workers: int = 1,
) -> List[Dict]:
    """Classification slides: one dict per matching feature file
    (reference FeatClsDataset dataset_feat.py:10-111). ``num_workers``
    parallelizes the upfront feature loading."""
    int_labels = map_labels(labels, dataset)
    store.prefetch(
        [f for pid in ids for f in match_slides(str(pid), store.files)],
        num_workers,
    )
    slides = []
    for pid, lab in zip(ids, int_labels):
        for f in match_slides(str(pid), store.files):
            s = {"feats": store.load(f), "target": int(lab), "slide": f}
            if with_pos:
                pos = store.coords(f)
                if pos is not None:
                    s["pos"] = pos
            slides.append(s)
    if not store.persistence:
        store._cache.clear()
    return slides


def build_surv_slides(
    store: FeatureBagStore,
    df,
    with_pos: bool = False,
    num_workers: int = 1,
) -> List[Dict]:
    """Survival slides: patient-level concat of all matching bags
    (reference FeatSurvDataset dataset_feat.py:113-260); carries the hazard
    bin (Label), censorship (1 - Status) and the raw event time.

    ``with_pos`` merges the per-slide h5 grid coordinates across the
    patient's slides by plain concatenation, mirroring the reference's
    multi-h5 merge (dataset_feat.py:211-233 cats the per-slide coords; the
    slides therefore share a grid origin — reference behavior, kept) so
    2D-Mamba survival runs see real grids instead of a row-major pseudo-grid.
    """
    store.prefetch(
        [f for _, r in df.iterrows() for f in match_slides(str(r["ID"]), store.files)],
        num_workers,
    )
    slides = []
    for _, row in df.iterrows():
        files = match_slides(str(row["ID"]), store.files)
        if not files:
            continue
        feats = np.concatenate([store.load(f) for f in files], axis=0)
        s = {
            "feats": feats,
            "target": int(row["Label"]),
            "censorship": int(1 - int(row["Status"])),
            "event": float(row["Event"]),
            "slide": files[0],
        }
        if with_pos:
            per_slide = [store.coords(f) for f in files]
            if all(p is not None for p in per_slide):
                pos = np.concatenate(per_slide, axis=0)
                if len(pos) == len(feats):
                    s["pos"] = pos
        slides.append(s)
    if not store.persistence:
        store._cache.clear()
    return slides
