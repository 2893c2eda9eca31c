"""Evaluation metric stack (reference: engines/metrics.py; a copy of
``mhim_mil_tpu/engine/metrics.py``).

Pure numpy re-implementations of the torchmetrics collection the reference
uses (AUROC / Accuracy / F1 / Precision / Recall / Cohen's kappa, binary or
macro-multiclass — reference metrics.py:125-159), the seeded deterministic
bootstrap (1000 multinomial resamples — reference metrics.py:35-64) and the
censored concordance index for survival (reference metrics.py:66-104, which
wraps sksurv). Metrics run host-side on eval outputs; only the forward passes
are on-device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# Reference bootstrap seed offset (engines/metrics.py:154-157): seed = fold + BIG.
BOOTSTRAP_SEED_OFFSET = 7784414403328510413


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def auroc_binary(scores: np.ndarray, labels: np.ndarray) -> float:
    """Mann–Whitney rank AUC with tie correction."""
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([neg, pos]), kind="mergesort")
    ranks = np.empty(len(order), float)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ranks for ties
    allv = np.concatenate([neg, pos])
    sorted_v = allv[order]
    i = 0
    while i < len(sorted_v):
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = ranks[order[i : j + 1]].mean()
        i = j + 1
    r_pos = ranks[len(neg) :].sum()
    n_pos, n_neg = len(pos), len(neg)
    return float((r_pos - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def auroc(probs: np.ndarray, labels: np.ndarray, n_classes: int) -> float:
    """Binary: prob of class 1. Multiclass: macro one-vs-rest."""
    if n_classes == 2:
        return auroc_binary(probs[:, 1], (labels == 1).astype(int))
    aucs = []
    for c in range(n_classes):
        if (labels == c).any() and (labels != c).any():
            aucs.append(auroc_binary(probs[:, c], (labels == c).astype(int)))
    return float(np.mean(aucs)) if aucs else float("nan")


def _prf(labels: np.ndarray, preds: np.ndarray, cls: int) -> Tuple[float, float, float]:
    tp = ((preds == cls) & (labels == cls)).sum()
    fp = ((preds == cls) & (labels != cls)).sum()
    fn = ((preds != cls) & (labels == cls)).sum()
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return prec, rec, f1


def classification_metrics(
    logits: np.ndarray, labels: np.ndarray, n_classes: int, bin_metric: bool = False
) -> Dict[str, float]:
    """The reference's metric collection (engines/metrics.py:125-159):
    binary tasks score the positive class; multiclass uses macro averaging.
    """
    probs = _softmax(logits.astype(np.float64))
    preds = probs.argmax(-1)
    acc = float((preds == labels).mean())
    out = {"auc": auroc(probs, labels, n_classes), "acc": acc}
    if n_classes == 2 and bin_metric:
        prec, rec, f1 = _prf(labels, preds, 1)
        out.update(f1=f1, precision=prec, recall=rec)
    else:
        ps, rs, fs = zip(*(_prf(labels, preds, c) for c in range(n_classes)))
        out.update(
            f1=float(np.mean(fs)), precision=float(np.mean(ps)), recall=float(np.mean(rs))
        )
    # Cohen's kappa
    po = acc
    pe = sum(
        (labels == c).mean() * (preds == c).mean() for c in range(n_classes)
    )
    out["kappa"] = float((po - pe) / (1 - pe)) if pe < 1 else 0.0
    return out


def concordance_index_censored(
    event_indicator: np.ndarray,
    event_time: np.ndarray,
    risk: np.ndarray,
    tied_tol: float = 1e-8,
) -> float:
    """Harrell's c-index for right-censored data
    (semantics of sksurv.metrics.concordance_index_censored, which the
    reference wraps at engines/metrics.py:66-104).

    Comparable pairs: i experienced the event and ``t_i < t_j``; concordant
    when ``risk_i > risk_j``; risk ties count 0.5.
    """
    event = event_indicator.astype(bool)
    n = len(event_time)
    num, den = 0.0, 0.0
    order = np.argsort(event_time, kind="mergesort")
    t, e, r = event_time[order], event[order], risk[order]
    for i in range(n):
        if not e[i]:
            continue
        # pairs with strictly later time, or equal time but censored j
        mask = t > t[i] + tied_tol
        mask |= (np.abs(t - t[i]) <= tied_tol) & ~e
        mask[i] = False
        den += mask.sum()
        num += (r[i] > r[mask] + tied_tol).sum()
        num += 0.5 * (np.abs(r[i] - r[mask]) <= tied_tol).sum()
    return float(num / den) if den else float("nan")


def bootstrap(
    metric_fn,
    n: int,
    num_bootstrap: int = 1000,
    seed: int = 0,
) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Deterministic seeded multinomial bootstrap
    (reference: engines/metrics.py:35-64 ``DeterministicBootStrapper`` —
    seed = fold + 7784414403328510413; RNG stream differs from torch's,
    a documented divergence).

    ``metric_fn(idx)`` computes the metric dict on resample indices ``idx``.
    Returns (mean, std) dicts.
    """
    rng = np.random.default_rng(np.uint64(seed) & np.uint64(0xFFFFFFFFFFFFFFFF))
    samples: Dict[str, List[float]] = {}
    for _ in range(num_bootstrap):
        idx = rng.integers(0, n, size=n)
        for k, v in metric_fn(idx).items():
            samples.setdefault(k, []).append(v)
    mean = {k: float(np.nanmean(v)) for k, v in samples.items()}
    std = {k: float(np.nanstd(v)) for k, v in samples.items()}
    return mean, std


def evaluate_classification(
    logits: np.ndarray,
    labels: np.ndarray,
    n_classes: int,
    loss: Optional[float] = None,
    bootstrap_enabled: bool = False,
    num_bootstrap: int = 1000,
    fold: int = 0,
    bin_metric: bool = False,
) -> Dict[str, object]:
    """Full eval row: point metrics (+ bootstrap mean/std when enabled),
    mirroring ``get_metric_val`` (reference engines/metrics.py:161-263)."""
    point = classification_metrics(logits, labels, n_classes, bin_metric)
    row: Dict[str, object] = dict(point)
    if loss is not None:
        row["loss"] = loss
    if bootstrap_enabled:
        mean, std = bootstrap(
            lambda idx: classification_metrics(
                logits[idx], labels[idx], n_classes, bin_metric
            ),
            n=len(labels),
            num_bootstrap=num_bootstrap,
            seed=fold + BOOTSTRAP_SEED_OFFSET,
        )
        row["bootstrap_mean"] = mean
        row["bootstrap_std"] = std
    return row


def evaluate_survival(
    risk: np.ndarray,
    event_time: np.ndarray,
    censorship: np.ndarray,
    loss: Optional[float] = None,
    bootstrap_enabled: bool = False,
    num_bootstrap: int = 1000,
    fold: int = 0,
) -> Dict[str, object]:
    event = 1 - censorship.astype(int)
    row: Dict[str, object] = {
        "cindex": concordance_index_censored(event, event_time, risk)
    }
    if loss is not None:
        row["loss"] = loss
    if bootstrap_enabled:
        mean, std = bootstrap(
            lambda idx: {
                "cindex": concordance_index_censored(
                    event[idx], event_time[idx], risk[idx]
                )
            },
            n=len(risk),
            num_bootstrap=num_bootstrap,
            seed=fold + BOOTSTRAP_SEED_OFFSET,
        )
        row["bootstrap_mean"] = mean
        row["bootstrap_std"] = std
    return row
