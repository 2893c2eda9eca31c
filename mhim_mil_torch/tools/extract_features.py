"""Raster-image preprocessing CLI of the port: segment → patch coords →
encoder sweep on the card → CLAM-layout feature store (pt_files/ +
h5_files/). The counterpart of ``tools/extract_features.py``, with its
flags and output.

The framework equivalent of the reference's two offline CLIs
(`CLAM/create_patches_fp.py:48-286` seg+patch and
`CLAM/extract_features_fp.py:83-177` encoder sweep), for every source
``preprocess/tiff.open_slide`` reads: pyramidal TIFF and BigTIFF, Aperio
``.svs``, Hamamatsu ``.ndpi`` and ``.vms``, MIRAX ``.mrxs``, Philips TIFF,
Leica ``.scn``, Ventana ``.bif`` and plain rasters (PNG/JPEG/BMP through
PIL).

Usage:
  python -m mhim_mil_torch.tools.extract_features --source DIR_OF_IMAGES \\
      --save_dir OUT --encoder resnet50_trunc [--ckpt_path w.pt] \\
      [--patch_size 256] [--step_size 256] [--batch_size 256] \\
      [--coverage 0.5] [--preset presets.csv] [--process_list list.csv] \\
      [--stitch] [--device cpu]

Produces OUT/pt_files/<id>.pt and OUT/h5_files/<id>.h5 (+coords/attrs) —
exactly what data/readers.py consumes for training. ``--preset`` applies a
CLAM-style parameter CSV as defaults; ``--process_list`` gives per-slide
overrides and a ``process`` column to skip slides (reference
create_patches_fp.py:48-286 CSV-driven per-slide params); ``--stitch``
writes OUT/stitches/<id>_stitch.jpg showing the kept patch grid (reference
StitchCoords, wsi_core/wsi_utils.py DrawMap). The encoder runs on the card
unless ``--device cpu`` is given. PIL (reading rasters, ``--stitch``) and
h5py (``h5_files``) are imported only where they are used.
"""

from __future__ import annotations

import argparse
import configparser
import os
import time

import numpy as np

from ..preprocess.encoders import get_encoder
from ..preprocess.extract import extract_features, save_feature_store, slide_patch_reader
from ..preprocess.segment import generate_patch_coords, segment_tissue
from ..preprocess.tiff import open_slide

IMG_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".svs", ".ndpi",
            ".mrxs", ".vms", ".scn", ".bif", ".bmp")


def _vms_satellites(paths):
    """Files referenced by a ``.vms`` slide in the sweep (grid JPEGs, map,
    macro, optimisation file): they are parts of that slide, not slides of
    their own — sweeping them as flat rasters would pollute the store."""
    out = set()
    for p in paths:
        if not p.lower().endswith(".vms"):
            continue
        base = os.path.dirname(os.path.abspath(p))
        try:
            ini = configparser.ConfigParser(interpolation=None, strict=False)
            ini.optionxform = str
            with open(p, "r", encoding="utf-8-sig", errors="replace") as f:
                ini.read_string(f.read())
            for sect in ini.values():
                for _k, v in sect.items():
                    cand = os.path.join(base, v.strip())
                    if os.path.isfile(cand):
                        out.add(os.path.abspath(cand))
        except (OSError, configparser.Error):
            pass
    return out


PARAM_COLS = ("sthresh", "coverage", "patch_size", "step_size")


def _read_param_csv(path):
    """CLAM-style parameter CSV → list of row dicts (plain csv module; the
    reference uses pandas, create_patches_fp.py:96-130)."""
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def slide_params(args, overrides):
    """Per-slide parameters: CLI defaults ← preset CSV ← process-list row."""
    p = {k: getattr(args, k) for k in PARAM_COLS}
    for src in overrides:
        for k in PARAM_COLS:
            if src and src.get(k) not in (None, ""):
                p[k] = type(getattr(args, k))(float(src[k]))
    return p


def write_stitch(out_dir, sid, img, coords, patch_size, max_side=1024,
                 full_hw=None):
    """Downscaled overview with the kept patch grid drawn (reference
    StitchCoords/DrawMap, CLAM/wsi_core/wsi_utils.py:163-207). ``full_hw``
    gives the level-0 size when ``img`` is already a thumbnail (pyramidal
    slides) so the level-0 coords land correctly."""
    from PIL import Image

    if full_hw is None:
        full_hw = img.shape[:2]
    pre = max(1, int(round(full_hw[0] / img.shape[0])))
    scale = max(1, int(np.ceil(max(img.shape[:2]) / max_side))) * pre
    canvas = np.ascontiguousarray(img[:: scale // pre, :: scale // pre].copy())
    ps = max(patch_size // scale, 1)
    for x, y in coords // scale:
        canvas[y : y + ps, x : x + 1] = 0
        canvas[y : y + ps, min(x + ps, canvas.shape[1] - 1)] = 0
        canvas[y : y + 1, x : x + ps] = 0
        canvas[min(y + ps, canvas.shape[0] - 1), x : x + ps] = 0
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{sid}_stitch.jpg")
    Image.fromarray(canvas).save(out)
    return out


def process_slide(path, encoder, norm, args, params=None):
    p = params or {k: getattr(args, k) for k in PARAM_COLS}
    # Pyramidal and vendor slides open through the native readers (tile-level
    # random access, level 0 never materialised); flat rasters fall back to a
    # single-level wrapper (preprocess/tiff.py open_slide; the reference calls
    # openslide.open_slide the same way, WholeSlideImage.py:32).
    slide = open_slide(path)
    try:
        return _process_open_slide(slide, path, encoder, norm, args, p)
    finally:
        slide.close()


def _process_open_slide(slide, path, encoder, norm, args, p):
    w0, h0 = slide.dimensions
    # Segment on a low pyramid level / bounded thumbnail (reference segments
    # at seg_level, WholeSlideImage.py:91-183).
    thumb = slide.get_thumbnail(2048)
    mask = segment_tissue(thumb, sthresh=p["sthresh"])
    grid = generate_patch_coords(
        mask, (h0, w0), p["patch_size"], p["step_size"], p["coverage"]
    )
    coords = grid["coords"]
    if len(coords) == 0:
        return None, 0
    feats = extract_features(
        encoder, slide_patch_reader(slide, p["patch_size"]), coords,
        p["patch_size"], args.batch_size, norm,
    )
    sid = os.path.splitext(os.path.basename(path))[0]
    save_feature_store(
        args.save_dir,
        sid,
        feats,
        coords,
        attrs={
            "patch_size": p["patch_size"],
            "downsample": grid["downsample"],
            "level_dim": np.asarray([w0, h0]),
        },
    )
    if args.stitch:
        write_stitch(
            os.path.join(args.save_dir, "stitches"), sid, thumb, coords,
            p["patch_size"], full_hw=(h0, w0),
        )
    return sid, len(coords)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--source", required=True, help="directory of slides or raster images")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--encoder", default="resnet50_trunc")
    p.add_argument("--ckpt_path", default=None, help="torch state_dict for the encoder")
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--step_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--coverage", type=float, default=0.5)
    p.add_argument("--sthresh", type=int, default=0, help="0 = Otsu")
    p.add_argument("--preset", default=None,
                   help="CLAM-style parameter CSV applied as defaults")
    p.add_argument("--process_list", default=None,
                   help="per-slide CSV: slide_id[,process][,param overrides]")
    p.add_argument("--stitch", action="store_true",
                   help="write stitches/<id>_stitch.jpg patch-grid overviews")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    preset = _read_param_csv(args.preset)[0] if args.preset else None
    plist = (
        {r["slide_id"]: r for r in _read_param_csv(args.process_list)}
        if args.process_list
        else None
    )

    encoder, norm = get_encoder(args.encoder, args.ckpt_path, device=args.device)
    paths = sorted(
        os.path.join(args.source, f)
        for f in os.listdir(args.source)
        if f.lower().endswith(IMG_EXTS)
    )
    sat = _vms_satellites(paths)
    paths = [p for p in paths if os.path.abspath(p) not in sat]
    if not paths:
        raise SystemExit(f"no images in {args.source}")
    os.makedirs(args.save_dir, exist_ok=True)
    for i, path in enumerate(paths):
        sid0 = os.path.splitext(os.path.basename(path))[0]
        row = plist.get(sid0) if plist is not None else None
        if plist is not None and row is None:
            continue  # not on the list (reference: process_list filters)
        if row is not None and str(row.get("process", "1")).strip() in ("0", "false"):
            print(f"[{i + 1}/{len(paths)}] {sid0}: process=0, skipped")
            continue
        t0 = time.time()
        sid, n = process_slide(
            path, encoder, norm, args, slide_params(args, [preset, row])
        )
        if sid is None:
            print(f"[{i + 1}/{len(paths)}] {path}: no tissue found, skipped")
        else:
            print(
                f"[{i + 1}/{len(paths)}] {sid}: {n} patches -> "
                f"{args.save_dir}/pt_files/{sid}.pt ({time.time() - t0:.1f}s)"
            )


if __name__ == "__main__":
    main()
