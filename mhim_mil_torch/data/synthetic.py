"""Synthetic MIL dataset with a known separable signal (a copy of
``mhim_mil_tpu/data/synthetic.py``: the same numpy draws give the same bags).

The reference has no test fixtures at all (SURVEY.md §4); this generator is
the end-to-end convergence fixture: negative bags are pure background noise,
positive bags contain a small fraction of "tumor" instances drawn from a
shifted Gaussian — the canonical MIL assumption, learnable by every model in
the zoo within a few epochs.
"""

from __future__ import annotations

import numpy as np


def make_synthetic_dataset(
    n_slides: int = 64,
    bag_size: int = 256,
    feat_dim: int = 1024,
    n_classes: int = 2,
    witness_rate: float = 0.05,
    signal: float = 1.5,
    ragged: bool = True,
    seed: int = 0,
):
    """Returns a list of dicts ``{'feats': [n_i, D] f32, 'target': int}``.

    Class ``c > 0`` bags contain ``ceil(witness_rate·n)`` instances whose mean
    is shifted by ``signal`` along class-specific random directions.
    """
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_classes, feat_dim)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    slides = []
    for i in range(n_slides):
        label = int(i % n_classes)
        n = bag_size
        if ragged:
            n = int(rng.integers(bag_size // 2, bag_size + 1))
        feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
        if label > 0:
            k = max(1, int(np.ceil(witness_rate * n)))
            idx = rng.choice(n, size=k, replace=False)
            feats[idx] += signal * dirs[label]
        slides.append({"feats": feats, "target": label})
    return slides


def make_synthetic_survival_dataset(
    n_slides: int = 64,
    bag_size: int = 256,
    feat_dim: int = 1024,
    n_bins: int = 4,
    seed: int = 0,
):
    """Survival fixture: risk grows with the witness fraction; event times are
    exponential in the negated risk, discretised into ``n_bins`` quantile bins
    (mirroring reference datasets/data_utils.py:357-371 semantics).
    Returns dicts ``{'feats', 'target' (bin), 'censorship', 'event' (time)}``.
    """
    rng = np.random.default_rng(seed)
    direction = rng.normal(size=(feat_dim,)).astype(np.float32)
    direction /= np.linalg.norm(direction)

    raw = []
    for _ in range(n_slides):
        n = int(rng.integers(bag_size // 2, bag_size + 1))
        frac = float(rng.uniform(0.0, 0.3))
        feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
        k = int(np.ceil(frac * n))
        if k:
            idx = rng.choice(n, size=k, replace=False)
            feats[idx] += 2.0 * direction
        # low-variance Weibull(k=5) noise keeps the risk→time link learnable
        # (exponential noise drowns it at fixture scale; c-index stays ~0.5)
        time = float(rng.weibull(5.0) / (0.2 + 3.0 * frac))
        censor = int(rng.random() < 0.25)
        raw.append({"feats": feats, "time": time, "censorship": censor})

    times = np.array([r["time"] for r in raw])
    uncensored = times[[r["censorship"] == 0 for r in raw]]
    qs = np.quantile(uncensored, np.linspace(0, 1, n_bins + 1)[1:-1])
    slides = []
    for r in raw:
        bin_id = int(np.searchsorted(qs, r["time"]))
        slides.append(
            {
                "feats": r["feats"],
                "target": bin_id,
                "censorship": r["censorship"],
                "event": r["time"],
            }
        )
    return slides
