"""Export a trained checkpoint as a serving bundle: ``python -m mhim_mil_torch.tools.export_serving``
(the counterpart of ``tools/export_serving.py``).

Loads a fold checkpoint (the port's ``.ckpt`` or the JAX package's; the
student's weights, or the EMA teacher's with ``--use_teacher``) into the
model of ``--model`` / ``--baseline`` and writes
``utils/serving.export_serving_bundle``'s bundle: one ``torch.export``
program per instance bucket and platform, the batch dimension symbolic,
the weights inside, the kernels as ``torch.ops.mhim_mil_torch`` ops.

    python -m mhim_mil_torch.tools.export_serving --ckpt out/fold_0_model_best.ckpt \\
        --model mhim --baseline selfattn --out serving_bundle/ --buckets 1024,4096,10240

``--platforms`` is ``cuda`` (the default: needs a card), ``cpu`` or
``cuda,cpu``. Score without the model code or the checkpoint::

    from mhim_mil_torch.utils.serving import load_bundle
    load_bundle("serving_bundle/").score(feats)   # device="cpu" for a cpu program

The tool's own flags are those of ``tools/export_serving.py``; any other
flag is the config's (``-c``, ``--compute_dtype``, ``--n_heads`` ...), read
by ``load_config``. Prints the manifest and the files with their bytes.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the export; returns ``{"manifest", "files"}`` (file name → bytes)."""
    from ..config import load_config
    from ..models import build_model
    from ..utils.checkpoint import load_weights
    from ..utils.serving import export_serving_bundle

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", default="mhim")
    ap.add_argument("--baseline", default="selfattn")
    ap.add_argument("--input_dim", type=int, default=1024)
    ap.add_argument("--inner_dim", type=int, default=512)
    ap.add_argument("--n_classes", type=int, default=2)
    ap.add_argument("--buckets", default="1024,4096,10240")
    ap.add_argument("--platforms", default="cuda")
    ap.add_argument("--use_teacher", action="store_true",
                    help="export the EMA teacher weights instead of the student")
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    platforms = [p.strip() for p in args.platforms.split(",")]
    cfg = load_config(rest, model=args.model, baseline=args.baseline, input_dim=args.input_dim,
                      inner_dim=args.inner_dim, n_classes=args.n_classes)
    model, family = build_model(cfg, device=platforms[0])
    load_weights(cfg, model, args.ckpt, teacher=args.use_teacher)
    manifest = export_serving_bundle(cfg, model, family, args.out,
                                     buckets=[int(x) for x in args.buckets.split(",")], platforms=platforms)
    files = {f: os.path.getsize(os.path.join(args.out, f)) for f in sorted(os.listdir(args.out))}
    print({"manifest": manifest, "files": files})
    return {"manifest": manifest, "files": files}


if __name__ == "__main__":
    main()
