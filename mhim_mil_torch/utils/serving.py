"""Bucketed scoring of feature bags, in this process or from an exported
bundle (port of ``mhim_mil_tpu/utils/serving.py``).

A request is one bag ``[N, D]`` or a batch ``[B, N, D]`` with an optional
``[B, N]`` validity mask. It is padded at the end, masked, into the smallest
instance bucket that holds it, as the training pipeline's length bucketing
does, and scored by :class:`~..engine.steps.EvalBody`, the family's
inference body: ``forward_test`` for ``mhim`` and ``mhim_pure``, the
model's forward on ``(feats, mask)`` for ``default``, ``dsmil`` and
``mamba2d`` (``mamba2d`` and a ``sincos`` model then lay the bag on a
row-major grid, with no coordinates), as ``_infer_fn`` in the JAX package
does. For ``dsmil`` the result holds ``sub_logits`` beside ``logits``,
unfused, as ``_infer_fn``'s does: the caller fuses them
(``0.5·logits + 0.5·sub_logits``). Note that the bags of one MHIM request
are not independent: the Nystrom pseudo-inverse takes its initial scale over
the whole batch, so a bag's logits depend on the bags it is batched with (as
in the JAX package and the reference).

A request of either scorer runs inside the ``record_function`` range
``scorer.request``, its stages inside ``scorer.h2d`` (the features onto the
device), ``scorer.pad`` (the mask and the padding into the bucket),
``scorer.forward`` and ``scorer.to_host`` (the logits to numpy);
``utils/profile_serving.py`` prints each stage's time.

:class:`Scorer` runs the model module in this process.
:func:`export_serving_bundle` writes a bundle that scores without the model
code or the checkpoint: ``torch.export`` of the inference body, weights
included, once per instance bucket and platform, the batch dimension
symbolic. The kernels on its path (K1, K2, the K3p sweep, K4, K5) are
``torch.ops.mhim_mil_torch`` ops, so the program calls them as it calls
aten's. Bundle layout (a directory)::

    manifest.json               model family, buckets, input dim, n_classes,
                                compute dtype, platforms, torch version
    bucket_<N>_<platform>.pt2   the program at bucket N for cuda or cpu

:func:`load_bundle` / :class:`ServingBundle` need torch and the port's
kernel ops (this module imports them), not ``mhim_mil_torch.models``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..engine.steps import EvalBody
from ..ops import abmil_pool, flash_nystrom, nystrom_pinv, scan2d  # noqa: F401 (register the kernels' ops)
from .platform import resolve_device

DEFAULT_BUCKETS = (1024, 4096, 10240)
FORMAT = "mhim_mil_torch.serving/1"
MANIFEST = "manifest.json"

ArrayLike = Union[np.ndarray, torch.Tensor]
Device = Optional[Union[str, torch.device]]


def bucket_for(buckets: Sequence[int], n: int) -> int:
    """The smallest of the sorted ``buckets`` that holds ``n`` instances."""
    for bn in buckets:
        if n <= bn:
            return bn
    raise ValueError(f"bag of {n} instances exceeds the largest bucket {buckets[-1]}")


def pad_request(feats: ArrayLike, mask: Optional[ArrayLike], buckets: Sequence[int], input_dim: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """``(feats[B, bucket, D], mask[B, bucket], squeeze)`` on ``device``: the
    request as a batch, padded at the end into its bucket, masked; ``squeeze``
    when it was one ``[N, D]`` bag. Raises ``ValueError`` on a wrong width or
    a bag past the largest bucket."""
    with record_function("scorer.h2d"):
        feats = torch.as_tensor(feats, dtype=torch.float32, device=device)
    with record_function("scorer.pad"):
        squeeze = feats.dim() == 2
        if squeeze:
            feats = feats[None]
        bsz, n, d = feats.shape
        if d != input_dim:
            raise ValueError(f"feature dim {d} != input_dim {input_dim}")
        if mask is None:
            mask = torch.ones((bsz, n), dtype=torch.bool, device=device)
        else:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=device).reshape(bsz, n)
        pad = bucket_for(buckets, n) - n
        if pad:
            feats = torch.cat([feats, feats.new_zeros((bsz, pad, d))], dim=1)
            mask = torch.cat([mask, mask.new_zeros((bsz, pad))], dim=1)
    return feats, mask, squeeze


def _to_host(out: Dict[str, torch.Tensor], squeeze: bool) -> Dict[str, np.ndarray]:
    with record_function("scorer.to_host"):
        res = {k: v.cpu().numpy() for k, v in out.items()}
    return {k: v[0] for k, v in res.items()} if squeeze else res


def _score(feats: ArrayLike, mask: Optional[ArrayLike], buckets: Sequence[int], input_dim: int,
           device: torch.device, forward: Callable) -> Dict[str, np.ndarray]:
    """One request: :func:`pad_request`, ``forward(feats, mask)`` under
    inference mode, :func:`_to_host`, inside the range ``scorer.request``
    with ``forward`` in ``scorer.forward``."""
    with record_function("scorer.request"):
        feats, mask, squeeze = pad_request(feats, mask, buckets, input_dim, device)
        with torch.inference_mode():
            with record_function("scorer.forward"):
                out = forward(feats, mask)
            return _to_host(out, squeeze)


class Scorer:
    """Scores bags with ``model`` of ``family`` (as ``build_model`` returns
    it) under ``cfg``'s precision policy on ``device`` (CUDA unless ``"cpu"``
    is asked for; the model must already be there)."""

    def __init__(self, cfg, model: torch.nn.Module, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device: Device = None, family: str = "mhim"):
        self.device = resolve_device(device)
        param_dev = next(model.parameters()).device
        if param_dev.type != self.device.type:
            raise ValueError(f"model is on {param_dev}, scorer on {self.device}")
        self.buckets = sorted(int(n) for n in buckets)
        self.input_dim = int(cfg.input_dim)
        self.body = EvalBody(cfg, model, family)

    def bucket_for(self, n: int) -> int:
        return bucket_for(self.buckets, n)

    def score(self, feats: ArrayLike, mask: Optional[ArrayLike] = None) -> Dict[str, np.ndarray]:
        """``{"logits": [B, C]}`` (``[C]`` for one ``[N, D]`` bag), and for
        ``dsmil`` ``"sub_logits"`` of the same shape, fp32 on the host."""
        return _score(feats, mask, self.buckets, self.input_dim, self.device, self.body)


def program_name(bucket: int, platform: str) -> str:
    return f"bucket_{int(bucket)}_{platform}.pt2"


def export_serving_bundle(cfg, model: torch.nn.Module, family: str, out_dir: str,
                          buckets: Sequence[int] = DEFAULT_BUCKETS,
                          platforms: Sequence[str] = ("cuda",)) -> Dict[str, Any]:
    """Export the inference body of ``model`` (family ``family``, ``cfg``'s
    precision policy) at every bucket for every platform (``cuda``, which
    needs a card, or ``cpu``) and write the bundle to ``out_dir``; returns
    the manifest. Each program is traced under ``no_grad`` on its platform,
    where the model (a copy where it lies elsewhere) runs the path of that
    device: on the card the kernels' ops at every length, on the CPU their
    plain versions below ``NystromMSA.stream_min_len`` and the streamed
    attention from it. The batch is ``torch.export.Dim`` ``b`` (min 1),
    traced at 2, since a batch of 1 would specialise; feats are fp32
    ``[b, N, input_dim]`` and the mask bool ``[b, N]``."""
    os.makedirs(out_dir, exist_ok=True)
    batch = torch.export.Dim("b", min=1)
    for platform in platforms:
        device = resolve_device(platform)
        if device.type != platform:
            raise ValueError(f"platform {platform!r}: want 'cuda' or 'cpu'")
        on = model if next(model.parameters()).device.type == platform else copy.deepcopy(model).to(device)
        body = EvalBody(cfg, on, family)
        for n in buckets:
            feats = torch.zeros((2, int(n), int(cfg.input_dim)), device=device)
            mask = torch.ones((2, int(n)), dtype=torch.bool, device=device)
            with torch.no_grad():
                prog = torch.export.export(body, (feats, mask),
                                           dynamic_shapes={"feats": {0: batch}, "mask": {0: batch}})
            prog.example_inputs = None  # else the file keeps the example batch: 80 MiB at 10,240 × 1024
            torch.export.save(prog, os.path.join(out_dir, program_name(n, platform)))
    manifest = {
        "format": FORMAT,
        "model": cfg.model,
        "family": family,
        "baseline": getattr(cfg, "baseline", None),
        "input_dim": int(cfg.input_dim),
        "n_classes": int(cfg.n_classes),
        "buckets": sorted(int(n) for n in buckets),
        "platforms": list(platforms),
        "batch_dim": "symbolic",
        "torch_version": torch.__version__,
        "compute_dtype": getattr(cfg, "compute_dtype", "float32"),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServingBundle:
    """Scorer over an exported bundle, on ``device`` (CUDA unless ``"cpu"``
    is asked for), which must be one of the bundle's platforms: there is no
    fallback to another platform's program.

    ``score(feats, mask=None)`` pads the bag(s) into the smallest bucket
    that fits (padding at the END, masked out: the package-wide convention)
    and runs that bucket's program. Accepts ``[N, D]`` (one bag) or
    ``[B, N, D]`` with an optional ``[B, N]`` validity mask; returns fp32
    ``{"logits"}`` (and ``"sub_logits"`` for dsmil) on the host.
    """

    def __init__(self, path: str, device: Device = None):
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: format {self.manifest.get('format')!r}, want {FORMAT!r}")
        self.device = resolve_device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(f"{path} has no program for {self.device.type} "
                             f"(platforms {self.manifest['platforms']})")
        self.path = path
        self.buckets = sorted(self.manifest["buckets"])
        self._loaded: Dict[int, torch.nn.Module] = {}

    def program(self, bucket: int) -> torch.nn.Module:
        """The loaded program of ``bucket`` on this bundle's device."""
        if bucket not in self._loaded:
            prog = torch.export.load(os.path.join(self.path, program_name(bucket, self.device.type)))
            self._loaded[bucket] = prog.module()
        return self._loaded[bucket]

    def score(self, feats: ArrayLike, mask: Optional[ArrayLike] = None) -> Dict[str, np.ndarray]:
        return _score(feats, mask, self.buckets, self.manifest["input_dim"], self.device,
                      lambda f, m: self.program(f.shape[1])(f, m))


def load_bundle(path: str, device: Device = None) -> ServingBundle:
    return ServingBundle(path, device)
