"""Convert a feature store to the CLAM layout: ``python3 -m
mhim_mil_torch.tools.convert_features --src feats/ --src_format h5|npy|pt
--dst store/ [--with_coords]`` (a copy of ``tools/convert_features.py`` on
the port's ``data/readers.py`` and ``preprocess/extract.py``).

Every ``*.h5`` (its ``features`` dataset, and its ``coords`` with their
attributes), ``*.npy`` or ``*.pt`` bag of ``--src``, in name order, becomes
``--dst/pt_files/<id>.pt``, and with ``--with_coords`` an h5 source's
coordinates ``--dst/h5_files/<id>.h5``: the layout the driver and the
reference read, from whatever container a published feature set ships in.
h5py is imported only when an h5 file is read or written.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from ..data.readers import load_h5_features, load_pt_features
from ..preprocess.extract import save_feature_store

EXTS = {"h5": ".h5", "npy": ".npy", "pt": ".pt"}


def convert_features(src: str, dst: str, src_format: str, with_coords: bool = False) -> List[str]:
    """Convert every bag of ``src``; returns the slide ids, in order."""
    files = sorted(f for f in os.listdir(src) if f.endswith(EXTS[src_format]))
    print(f"converting {len(files)} {src_format} bags -> {dst}")
    ids = []
    for f in files:
        sid = os.path.splitext(f)[0]
        path = os.path.join(src, f)
        coords = attrs = None
        if src_format == "h5":
            feats, coords, attrs = load_h5_features(path)
            if feats is None:
                raise ValueError(f"{path}: no 'features' dataset")
        elif src_format == "npy":
            feats = np.load(path).astype(np.float32)
        else:
            feats = load_pt_features(path)
        save_feature_store(dst, sid, feats, coords=coords if with_coords else None, attrs=attrs)
        ids.append(sid)
    print("done")
    return ids


def main(argv: Optional[List[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--src_format", choices=sorted(EXTS), required=True)
    ap.add_argument("--with_coords", action="store_true")
    args = ap.parse_args(argv)
    return convert_features(args.src, args.dst, args.src_format, args.with_coords)


if __name__ == "__main__":
    main()
