"""The confounder bank of IBMIL (a copy of ``mhim_mil_tpu/utils/confounders.py``,
numpy only, so that the port imports nothing of the JAX package).

The upstream IBMIL workflow k-means-clusters a trained model's bag
features into a prototype bank saved as ``.npy`` and passed back through
``--confounder_path`` (reference modules/abmil_ibmil.py:57-67 loads it).
The same seed gives the same bank as the JAX package's, bit for bit.
"""

from __future__ import annotations

import numpy as np


def kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    """Plain Lloyd's k-means; returns ``[k, D]`` fp32 centroids."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    if len(centers) < k:  # fewer samples than clusters: pad with jitter
        extra = centers[rng.integers(0, len(centers), k - len(centers))]
        centers = np.concatenate([centers, extra + rng.normal(0, 1e-3, extra.shape)])
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(-1)
        new = np.stack([x[assign == j].mean(0) if (assign == j).any() else centers[j] for j in range(k)])
        if np.allclose(new, centers):
            break
        centers = new
    return centers.astype(np.float32)


def build_confounders(bag_features: np.ndarray, k: int, out_path: str, seed: int = 0) -> np.ndarray:
    """Cluster bag features into ``k`` prototypes and save them as ``.npy``."""
    protos = kmeans(bag_features, k, seed=seed)
    np.save(out_path, protos)
    return protos
