"""Export per-slide attention heatmaps: ``python -m mhim_mil_torch.tools.export_attention``
(the counterpart of ``tools/export_attention.py``).

Loads a fold checkpoint (the port's ``.ckpt`` or the JAX package's; without
``--ckpt`` the weights are random from ``--seed``), runs the model's
attention forward over every slide of a CLAM-layout feature store, one
slide at a time on the device, and writes ``<out>/<slide>_attn.npy`` (the
grid of percentile ranks, the reference's heatmap convention) and
``<slide>_attn.csv`` (x, y, raw score) through
``utils/heatmap.export_heatmap``. MHIM runs ``forward_test(return_attn=True)``;
every other model ``forward(..., return_attn=True)``. Multi-head attention
is averaged over the heads.

    python -m mhim_mil_torch.tools.export_attention --ckpt out/fold_0_model_best.ckpt \\
        --model abmil --csv_path labels.csv --dataset_root store/ --out attn/

The tool's own flags are ``--out``, ``--ckpt``, ``--device`` (``cuda``,
the default, or ``cpu``) and ``--image_dir``; every other flag is
the config's (``-c``, ``--model``, ``--baseline``, ``--input_dim``,
``--use_flash_attn`` ...), read by ``load_config``. Without ``--csv_path``
every ``.pt`` file of the store is exported. Overlays on the slide images
(``--image_dir``) need the slide readers, which the port does not have yet:
that flag raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.checkpoint import load_weights

MHIM_FAMILIES = ("mhim", "mhim_pure")


def _slides(cfg) -> List[Dict]:
    """The slides of the CSV (``ID,Label``), or every ``.pt`` of the store."""
    from ..data.readers import FeatureBagStore, build_cls_slides

    store = FeatureBagStore(cfg.dataset_root)
    if cfg.csv_path:
        from ..data.splits import read_csv

        df = read_csv(cfg.csv_path)
        return build_cls_slides(store, df["ID"].tolist(), df["Label"].tolist(), cfg.datasets, with_pos=True)
    slides = []
    for f in store.files:
        pos = store.coords(f)
        slides.append({"feats": store.load(f), "slide": f, **({} if pos is None else {"pos": pos})})
    return slides


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """Run the export; returns each slide's raw scores ``[N]`` by slide id."""
    from ..config import load_config
    from ..models import build_model
    from ..utils.heatmap import export_heatmap

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default=None, help="fold checkpoint (port or JAX); omitted = random weights")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image_dir", default=None)
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    if args.image_dir:
        raise NotImplementedError("--image_dir: overlays need the slide readers (preprocess/tiff and the rest), "
                                  "which are not ported yet (ROADMAP.md, Queue 1, item 5)")
    cfg = load_config(rest)
    if not cfg.dataset_root:
        raise SystemExit("--dataset_root is required")
    model, family = build_model(cfg, device=args.device)
    if args.ckpt:
        load_weights(cfg, model, args.ckpt)
    else:
        print(f"no --ckpt: exporting the attention of random weights (seed {cfg.seed})")
    device = next(model.parameters()).device
    scores = {}
    with torch.inference_mode():
        for s in _slides(cfg):
            feats = torch.from_numpy(np.asarray(s["feats"], np.float32)[None]).to(device)
            mask = torch.ones(feats.shape[:2], dtype=torch.bool, device=device)
            if family in MHIM_FAMILIES:
                out = model.forward_test(feats, mask, return_attn=True)
            else:
                out = model(feats, mask, training=False, return_attn=True)
            attn = out["attn"].float()
            if attn.dim() == 3:  # [B, H, N]: the mean over the heads
                attn = attn.mean(dim=1)
            sid = os.path.splitext(s["slide"])[0]
            scores[sid] = attn[0, :feats.shape[1]].cpu().numpy()
            export_heatmap(args.out, sid, scores[sid], s.get("pos"))
            print(f"exported {sid}")
    return scores


if __name__ == "__main__":
    main()
