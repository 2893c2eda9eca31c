"""The numbers that decide ``correct``, and their limits.

Training (the program's first three steps against the reference's, from
the same weights, batches and draws):

- ``loss``: the largest relative gap of a step's loss;
- ``grad1``: the first gradient as Adam took it (its first moment after one
  step over ``1 − β1``), by the worst leaf: the gap between the program's
  norm and the reference's, over the larger of the reference's norm of that
  leaf and of the median leaf;
- ``change3``: the parameters' change over the three steps, by the worst
  leaf in the same way, leaving out the leaves whose reference gradient is
  under a thousandth of the median leaf's (their change is Adam's answer to
  rounding); ``teacher3``: the same for the EMA teacher;
- ``global_q3``: the gap of the norms of the Merge's global queries' change;
- ``keep``: the largest relative gap of a step's mean kept-token count.

Serving: ``logits``, the largest ``max|Δ| / max(1, max|ref|)`` over the
sampled requests.

A number is compared when the cell's limits file names it; ``judge``
holds each to its limit (a number that is not finite fails).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch

GRAD_FLOOR = 1e-3  # leaves under this share of the median leaf's gradient norm move by rounding alone
BUFFERS = ("merge.global_q_mm",)


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def worst_leaf(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keys: List[str]) -> float:
    """The worst leaf's gap of norms, over the larger of the leaf's and the median leaf's reference norm."""
    g, w = _norms({k: got[k] for k in keys}), _norms({k: want[k] for k in keys})
    med = statistics.median(w.values())
    return max(abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keys)


def train_numbers(got: Dict, want: Dict, w0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    out = {"loss": max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                       for a, b in zip(got["losses"], want["losses"]))}
    params = [k for k in want["grads"]]
    # a leaf that Adam never took counts a zero gradient
    got_grads = {k: got["grads"].get(k, torch.zeros_like(want["grads"][k])) for k in params}
    out["grad1"] = worst_leaf(got_grads, want["grads"], params)
    gnorm = _norms(want["grads"])
    med = statistics.median(gnorm.values())
    moving = [k for k in params if gnorm[k] >= GRAD_FLOOR * med]
    for side, name in (("student", "change3"), ("teacher", "teacher3")):
        if side not in want["after"]:
            continue
        d_got = {k: got["after"][side][k].float() - w0[k] for k in moving}
        d_want = {k: want["after"][side][k].float() - w0[k] for k in moving}
        out[name] = worst_leaf(d_got, d_want, moving)
    for k in BUFFERS:
        if k in want["after"]["student"]:
            a = float(torch.linalg.vector_norm((got["after"]["student"][k].float() - w0[k]).double()))
            b = float(torch.linalg.vector_norm((want["after"]["student"][k].float() - w0[k]).double()))
            out["global_q3"] = abs(a - b) / max(b, 1e-30)
    if want["keep"][0] is not None and got["keep"][0] is not None:
        out["keep"] = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                          for a, b in zip(got["keep"], want["keep"]))
    for j, name in ((0, "main_loss"), (1, "aux_loss")):  # the loss's two terms, for the look only
        pairs = [(a[j], b[j]) for a, b in zip(got.get("parts", []), want.get("parts", []))]
        if pairs and all(a is not None and b is not None for a, b in pairs):
            out[name] = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30) for a, b in pairs)
    return out


def serve_numbers(got: List[np.ndarray], want: List[np.ndarray]) -> Dict[str, float]:
    return {"logits": max(float(np.max(np.abs(g - w)) / max(1.0, float(np.max(np.abs(w)))))
                          for g, w in zip(got, want))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each limited number beside its limit, and whether it holds."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit, "ok": math.isfinite(value) and value <= limit}
    return out
