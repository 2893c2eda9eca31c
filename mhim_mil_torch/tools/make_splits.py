"""Write k-fold split CSVs: ``python3 -m mhim_mil_torch.tools.make_splits
--csv_path labels.csv --out splits/ --cv_fold 3 [--val_ratio 0.1] [--seed 2021]
[--val2test] [--survival]`` (a copy of ``tools/make_splits.py`` on the port's
``data/splits.py``).

It writes the folds the driver builds in memory from a flat label CSV
(``ID,Label``, or ``ID,Event,Status`` with ``--survival``) as a directory of
``fold_{k}.csv`` files with a ``Split`` column (train, test, and val where
a validation split is carved out), which ``python3 -m mhim_mil_torch.main
--csv_path <dir>`` reads: the split assignment as a file that can be
versioned, shared or edited by hand. Needs pandas, imported when the tool
runs.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..data.splits import get_kfold, read_csv


def make_split_csvs(csv_path: str, out_dir: str, cv_fold: int, seed: int = 2021, val_ratio: float = 0.0,
                    val2test: bool = False, survival: bool = False) -> List[str]:
    """The driver's k-fold assignment of ``csv_path``, written as
    ``out_dir/fold_{k}.csv``; returns the paths. As the driver's single-CSV
    branch: the frame shuffled by pandas' ``sample(frac=1,
    random_state=seed)``, then the stratified k-fold."""
    import pandas as pd

    df = read_csv(csv_path, survival=survival)
    df = df.sample(frac=1, random_state=seed).reset_index(drop=True)
    train_dfs, test_dfs, val_dfs = get_kfold(df, cv_fold, seed, val_ratio, val2test=val2test)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k, (tr, te, va) in enumerate(zip(train_dfs, test_dfs, val_dfs)):
        parts = [tr.assign(Split="train"), te.assign(Split="test")]
        # a validation split that is the test split needs no rows of its own
        if va is not te and not va.equals(te):
            parts.append(va.assign(Split="val"))
        p = os.path.join(out_dir, f"fold_{k}.csv")
        pd.concat(parts, ignore_index=True).to_csv(p, index=False)
        paths.append(p)
    return paths


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv_path", required=True, help="flat label CSV (ID,Label / ID,Event,Status)")
    ap.add_argument("--out", required=True, help="output directory for fold_{k}.csv")
    ap.add_argument("--cv_fold", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--val_ratio", type=float, default=0.0)
    ap.add_argument("--val2test", action="store_true")
    ap.add_argument("--survival", action="store_true")
    args = ap.parse_args(argv)
    paths = make_split_csvs(args.csv_path, args.out, args.cv_fold, args.seed, args.val_ratio, args.val2test,
                            args.survival)
    for p in paths:
        print(p)
    print(f"wrote {len(paths)} folds; train with: python3 -m mhim_mil_torch.main --csv_path {args.out}")
    return paths


if __name__ == "__main__":
    main()
