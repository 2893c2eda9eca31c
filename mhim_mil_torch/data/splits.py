"""CSV split/label utilities: schema parsing, stratified k-fold, survival bins
(a copy of ``mhim_mil_tpu/data/splits.py``).

Reference: datasets/data_utils.py:174-371. Same CSV schema —
``ID,Label[,Split][,Case]`` for classification, ``ID,Event,Status[,Case]``
for survival — and the same splitting semantics. ``pandas`` is imported
only by the functions that read or split a CSV, so that the synthetic
datasets and :func:`stratified_kfold_indices` work where it is not
installed; those functions raise an ``ImportError`` that names the CSV.
"""

from __future__ import annotations

from typing import List

import numpy as np

# Per-dataset binary zero-labels (reference: datasets/dataset_feat.py:48-56 maps
# `0 if label == <zero> else 1` — every OTHER string maps to 1, not an error).
ZERO_LABELS = {"nsclc": "LUAD", "brca": "IDC", "call": "normal"}


def _pandas(what: str):
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(f"{what} needs pandas, which is not installed") from e
    return pd


def map_labels(labels, dataset: str) -> np.ndarray:
    """Map raw CSV labels to ints (reference dataset_feat.py:46-56): binary
    zero-label mapping for the named datasets (any other string → 1), digit
    strings and ints pass through."""
    key = next((k for k in ZERO_LABELS if k in dataset.lower()), None)
    out = []
    for l in labels:
        if key is not None and isinstance(l, str) and not str(l).isdigit():
            out.append(0 if l == ZERO_LABELS[key] else 1)
        else:
            out.append(int(l))
    return np.asarray(out, np.int64)


def read_csv(csv_file: str, survival: bool = False):
    """Normalise a dataset CSV to columns ``ID, Label[, Split][, Case,
    Event, Status]`` (reference get_data_dfs data_utils.py:200-249)."""
    pd = _pandas(f"reading the dataset CSV {csv_file!r}")
    df = pd.read_csv(csv_file)
    if survival and "Label" not in df.columns:
        df = survival_label(df)
    if "ID" not in df.columns or "Label" not in df.columns:
        if len(df.columns) == 2:
            df.columns = ["ID", "Label"]
        elif len(df.columns) == 4:
            df.columns = ["Case", "ID", "Label", "Split"]
        else:
            raise ValueError(
                f"{csv_file}: need columns ID,Label[,Split] — got {list(df.columns)}"
            )
    return df


def split_by_column(df, val2test: bool = False):
    """Split on the ``Split`` column (reference get_split_dfs
    data_utils.py:180-198): empty val falls back to test."""
    pd = _pandas("splitting a dataset CSV on its Split column")
    s = df["Split"].astype(str).str.lower()
    train = df[s == "train"].reset_index(drop=True)
    test = df[s == "test"].reset_index(drop=True)
    val = df[s == "val"].reset_index(drop=True)
    if val2test:
        test = pd.concat([val, test], axis=0).reset_index(drop=True)
        val = test.iloc[0:0]
    if len(val) == 0:
        val = test
    return train, test, val


def data_split(seed: int, df, ratio: float, label_balance_val: bool = True):
    """Carve a label-balanced validation set out of ``df``
    (reference data_split data_utils.py:291-326). Returns (val, train)."""
    pd = _pandas("carving a validation split out of a dataset CSV")
    rng = np.random.default_rng(seed)
    if label_balance_val:
        val_parts, train_parts = [], []
        for label in df["Label"].unique():
            sub = df[df["Label"] == label]
            idx = rng.permutation(len(sub))
            offset = int(len(sub) * ratio)
            val_parts.append(sub.iloc[idx[:offset]])
            train_parts.append(sub.iloc[idx[offset:]])
        return (
            pd.concat(val_parts).reset_index(drop=True),
            pd.concat(train_parts).reset_index(drop=True),
        )
    idx = rng.permutation(len(df))
    offset = int(len(df) * ratio)
    return (
        df.iloc[idx[:offset]].reset_index(drop=True),
        df.iloc[idx[offset:]].reset_index(drop=True),
    )


def stratified_kfold_indices(labels: np.ndarray, k: int) -> List[np.ndarray]:
    """Deterministic stratified k-fold test indices, matching sklearn's
    un-shuffled StratifiedKFold semantics (reference get_kfold
    data_utils.py:328-355): within each class, in the order the classes are
    first met, samples are dealt to folds in contiguous blocks of n_c//k
    (+1 for the first n_c%k folds)."""
    labels = np.asarray(labels)
    folds: List[List[int]] = [[] for _ in range(k)]
    for cls in dict.fromkeys(labels.tolist()):  # classes in encounter order
        cls_idx = np.flatnonzero(labels == cls)
        n = len(cls_idx)
        sizes = np.full(k, n // k)
        sizes[: n % k] += 1
        start = 0
        for f in range(k):
            folds[f].extend(cls_idx[start : start + sizes[f]])
            start += sizes[f]
    return [np.sort(np.asarray(f, np.int64)) for f in folds]


def get_kfold(
    df,
    k: int,
    seed: int,
    val_ratio: float = 0.0,
    label_balance_val: bool = True,
    val2test: bool = False,
):
    """k-fold split lists (reference get_kfold data_utils.py:328-355).
    Returns (train_dfs, test_dfs, val_dfs); empty val falls back to test
    downstream."""
    pd = _pandas("k-fold splitting a dataset CSV")
    if k <= 1:
        raise ValueError("k must be > 1")
    test_folds = stratified_kfold_indices(df["Label"].to_numpy(), k)
    train_dfs, test_dfs, val_dfs = [], [], []
    all_idx = np.arange(len(df))
    for f in range(k):
        test_df = df.iloc[test_folds[f]].reset_index(drop=True)
        train_df = df.iloc[np.setdiff1d(all_idx, test_folds[f])].reset_index(drop=True)
        if val_ratio > 0:
            val_df, train_df = data_split(seed, train_df, val_ratio, label_balance_val)
            if val2test:
                test_df = pd.concat([val_df, test_df]).reset_index(drop=True)
                val_df = test_df
        else:
            val_df = test_df
        train_dfs.append(train_df)
        test_dfs.append(test_df)
        val_dfs.append(val_df)
    return train_dfs, test_dfs, val_dfs


def survival_label(df, n_bins: int = 4):
    """Discretise event times into ``n_bins`` quantile hazard bins computed
    over *uncensored* patients (reference survival_label
    data_utils.py:357-371). Adds a ``Label`` column; drops unbinnable rows."""
    pd = _pandas("binning the survival times of a dataset CSV")
    eps = 1e-6
    uncensored = df[df["Status"] == 1]
    qs = np.quantile(
        uncensored["Event"].to_numpy(float), np.linspace(0, 1, n_bins + 1)
    )
    qs[0] = df["Event"].min() - eps
    qs[-1] = df["Event"].max() + eps
    labels = (
        pd.cut(df["Event"], bins=qs, labels=False, right=False, include_lowest=True)
        .to_numpy()
    )
    labels = np.nan_to_num(labels, nan=-1).astype(int)
    df = df.copy()
    if "Label" not in df.columns:
        df["Label"] = labels
    return df[df["Label"] != -1].reset_index(drop=True)
