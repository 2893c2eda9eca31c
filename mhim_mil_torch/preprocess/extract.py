"""The CLAM-layout feature-store writer (a copy of ``save_feature_store``,
``mhim_mil_tpu/preprocess/extract.py:93-117``). ``h5py`` is imported only
when coordinates are written."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch


def save_feature_store(out_root: str, slide_id: str, feats: np.ndarray, coords: Optional[np.ndarray] = None,
                       attrs: Optional[Dict] = None) -> None:
    """Write CLAM-layout artifacts: ``pt_files/<id>.pt`` and, with
    ``coords``, ``h5_files/<id>.h5`` holding ``features`` and ``coords`` with
    ``attrs`` on the coordinates (reference extract_features_fp.py:147-171)."""
    os.makedirs(os.path.join(out_root, "pt_files"), exist_ok=True)
    torch.save(torch.tensor(feats), os.path.join(out_root, "pt_files", f"{slide_id}.pt"))
    if coords is None:
        return
    try:
        import h5py
    except ImportError as e:
        raise ImportError("writing coordinates to h5_files needs h5py, which is not installed") from e
    os.makedirs(os.path.join(out_root, "h5_files"), exist_ok=True)
    with h5py.File(os.path.join(out_root, "h5_files", f"{slide_id}.h5"), "w") as f:
        f.create_dataset("features", data=feats)
        d = f.create_dataset("coords", data=coords)
        for k, v in (attrs or {}).items():
            d.attrs[k] = v
