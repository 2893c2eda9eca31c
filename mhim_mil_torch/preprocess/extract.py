"""The encoder sweep and the CLAM-layout feature-store writer (the port's
copy of ``mhim_mil_tpu/preprocess/extract.py``; reference
CLAM/extract_features_fp.py:30-177: an encoder sweep over h5 coords at
batch 256, h5 append + pt export).

The encoder is any ``nn.Module`` mapping NCHW images to ``[B, D]``
(:func:`.encoders.get_encoder`); it runs on its own device. Patches stay
uint8 on the host, go to that device from pinned memory when it is a card,
and are normalised there as the JAX package normalises them on the host,
``(x/255 − mean)/std`` in fp32. ``h5py`` is imported only when coordinates
are written.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

# Per-encoder normalization constants (reference CLAM/utils/constants.py).
NORM_CONSTANTS = {
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "openai_clip": ((0.4815, 0.4578, 0.4082), (0.2686, 0.2613, 0.2758)),
    "uniform": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
}


def crop_patches(image: np.ndarray, coords: np.ndarray, patch_size: int) -> np.ndarray:
    """Gather ``[N, P, P, 3]`` patches at level-0 (x, y) coords."""
    out = np.zeros((len(coords), patch_size, patch_size, image.shape[-1]), image.dtype)
    h, w = image.shape[:2]
    for i, (x, y) in enumerate(coords):
        ph = min(patch_size, h - y)
        pw = min(patch_size, w - x)
        out[i, :ph, :pw] = image[y : y + ph, x : x + pw]
    return out


def slide_patch_reader(slide, patch_size: int) -> Callable:
    """Patch source over an open slide (:mod:`.tiff`): region reads at
    level 0 — the pyramidal equivalent of ``crop_patches`` (reference
    Whole_Slide_Bag_FP reads the same way via openslide,
    CLAM/dataset_modules/dataset_h5.py:79-84)."""

    def read(chunk: np.ndarray) -> np.ndarray:
        out = np.zeros((len(chunk), patch_size, patch_size, 3), np.uint8)
        for i, (x, y) in enumerate(chunk):
            out[i] = slide.read_region(
                (int(x), int(y)), 0, (patch_size, patch_size)
            )
        return out

    return read


def extract_features(
    encoder: torch.nn.Module,
    image,
    coords: np.ndarray,
    patch_size: int = 256,
    batch_size: int = 256,
    norm: str = "imagenet",
) -> np.ndarray:
    """Sweep the encoder over the patch grid → ``[N, D]`` float32 features.

    ``image`` is either a full-resolution ``[H, W, 3]`` ndarray or a
    patch-source callable (``slide_patch_reader``). The last short batch is
    padded with zeros to ``batch_size`` and cut after the encoder, as in the
    JAX package, where it keeps one compiled shape (reference batches at
    256, extract_features_fp.py:104). Runs under ``torch.inference_mode``.
    """
    device = next(encoder.parameters()).device
    mean, std = (torch.tensor(c, dtype=torch.float32, device=device) for c in NORM_CONSTANTS[norm])
    # a tensor, not a Python scalar: CUDA divides by a host scalar as a
    # product with its reciprocal, which is not the host's division
    scale = torch.tensor(255.0, dtype=torch.float32, device=device)

    feats = []
    n = len(coords)
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            chunk = coords[start : start + batch_size]
            patches = image(chunk) if callable(image) else crop_patches(image, chunk, patch_size)
            x = torch.from_numpy(np.ascontiguousarray(patches))
            if device.type == "cuda":
                x = x.pin_memory()
            x = (x.to(device, non_blocking=True).float() / scale - mean) / std
            pad = batch_size - len(chunk)
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            out = encoder(x.permute(0, 3, 1, 2))
            feats.append(out[: len(chunk)].float().cpu().numpy())
    return np.concatenate(feats, axis=0) if feats else np.zeros((0, 0), np.float32)


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
