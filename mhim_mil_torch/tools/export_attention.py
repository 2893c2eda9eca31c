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
the default, or ``cpu``) and the overlay flags of ``tools/export_attention.py``
(``--image_dir``, ``--patch_size``, ``--vis_level``, ``--alpha``, ``--cmap``,
``--sample_rois``, ``--roi_k``); every other flag is the config's (``-c``,
``--model``, ``--baseline``, ``--input_dim``, ``--use_flash_attn`` ...),
read by ``load_config``. Without ``--csv_path`` every ``.pt`` file of the
store is exported.

With ``--image_dir`` a slide whose store holds level-0 pixel coordinates
(``h5_files/<slide>.h5``) and whose image ``<slide>.{png,jpg,jpeg,tif,tiff,svs}``
lies in that directory also gets ``<slide>_overlay.png``: rendered in bands
at pyramid level ``--vis_level`` by ``render_heatmap_pyramidal`` when the
slide is pyramidal and the level exists, else blended on a thumbnail of at
most 4,096 px by ``render_heatmap_overlay``; with ``--sample_rois`` also
``<slide>_rois.csv`` (x, y, score) of ``--roi_k`` sampled patches
(reference CLAM/create_heatmaps.py:35-437 and wsi_utils.py:138
sample_rois). PIL and matplotlib are imported only for the overlays.
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


IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".svs")


def _slides(cfg, store) -> List[Dict]:
    """The slides of the CSV (``ID,Label``), or every ``.pt`` of the store."""
    from ..data.readers import build_cls_slides

    if cfg.csv_path:
        from ..data.splits import read_csv

        df = read_csv(cfg.csv_path)
        return build_cls_slides(store, df["ID"].tolist(), df["Label"].tolist(), cfg.datasets, with_pos=True)
    slides = []
    for f in store.files:
        pos = store.coords(f)
        slides.append({"feats": store.load(f), "slide": f, **({} if pos is None else {"pos": pos})})
    return slides


def render_overlay(image_path: str, px_coords: np.ndarray, scores: np.ndarray, args) -> np.ndarray:
    """The blended overlay of one slide: banded at pyramid level
    ``args.vis_level`` when the slide has it, else on a thumbnail of at most
    4,096 px with the coordinates scaled to it (reference visHeatmap,
    WholeSlideImage.py:487-677)."""
    from ..preprocess.tiff import open_slide
    from ..utils.heatmap import render_heatmap_overlay, render_heatmap_pyramidal

    slide = open_slide(image_path)
    try:
        if 0 <= args.vis_level < slide.level_count and hasattr(slide, "_read_level"):
            return render_heatmap_pyramidal(slide, px_coords, scores, patch_size=args.patch_size,
                                            vis_level=args.vis_level, alpha=args.alpha, cmap=args.cmap)
        img = slide.get_thumbnail(4096)
        scale = max(1, int(round(slide.dimensions[0] / img.shape[1])))
        return render_heatmap_overlay(img, px_coords // scale, scores, max(args.patch_size // scale, 1),
                                      alpha=args.alpha, cmap=args.cmap)
    finally:
        slide.close()


def write_overlays(args, sid: str, px_coords: np.ndarray, scores: np.ndarray):
    """``<sid>_overlay.png`` from the first image of ``sid`` under
    ``IMAGE_EXTS`` in ``args.image_dir``, and with ``args.sample_rois`` the
    sampled ROIs as ``<sid>_rois.csv``."""
    from ..utils.heatmap import sample_rois

    for ext in IMAGE_EXTS:
        path = os.path.join(args.image_dir, sid + ext)
        if os.path.exists(path):
            from PIL import Image

            out = os.path.join(args.out, f"{sid}_overlay.png")
            Image.fromarray(render_overlay(path, px_coords, scores, args)).save(out)
            print(f"  overlay -> {out}")
            break
    if args.sample_rois:
        rois = sample_rois(scores, px_coords, k=args.roi_k, mode=args.sample_rois)
        with open(os.path.join(args.out, f"{sid}_rois.csv"), "w") as f:
            f.write("x,y,score\n")
            for (x, y), sc in zip(rois["sampled_coords"], rois["sampled_scores"]):
                f.write(f"{x},{y},{sc}\n")


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """Run the export; returns each slide's raw scores ``[N]`` by slide id."""
    from ..config import load_config
    from ..data.readers import FeatureBagStore
    from ..models import build_model
    from ..utils.heatmap import export_heatmap

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default=None, help="fold checkpoint (port or JAX); omitted = random weights")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image_dir", default=None, help="slide images: also render blended overlays")
    ap.add_argument("--patch_size", type=int, default=256)
    ap.add_argument("--vis_level", type=int, default=-1,
                    help="pyramid level of the banded overlay; -1 = the thumbnail path")
    ap.add_argument("--alpha", type=float, default=0.4)
    ap.add_argument("--cmap", default="coolwarm")
    ap.add_argument("--sample_rois", default=None, choices=[None, "topk", "reverse_topk", "range_sample"])
    ap.add_argument("--roi_k", type=int, default=5)
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    cfg = load_config(rest)
    if not cfg.dataset_root:
        raise SystemExit("--dataset_root is required")
    model, family = build_model(cfg, device=args.device)
    if args.ckpt:
        load_weights(cfg, model, args.ckpt)
    else:
        print(f"no --ckpt: exporting the attention of random weights (seed {cfg.seed})")
    device = next(model.parameters()).device
    store = FeatureBagStore(cfg.dataset_root)
    scores = {}
    with torch.inference_mode():
        for s in _slides(cfg, store):
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
            px_coords = store.pixel_coords(s["slide"])
            if args.image_dir and px_coords is not None:
                write_overlays(args, sid, px_coords, scores[sid])
            print(f"exported {sid}")
    return scores


if __name__ == "__main__":
    main()
