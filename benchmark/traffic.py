"""The traffic generator: one general reader of the mixes in ``traffic/``.

A mix is a JSON file of parameters. ``mode`` says how the cell drives the
program (``train``: train steps over staged batches; ``serve``: a closed
loop of one client scoring one slide a request); the rest gives the slide
lengths and how they are grouped:

- ``n_slides``, ``median``, ``sigma``, ``min_len``, ``max_len``: the
  lengths, lognormal (median and log-sd), clipped and truncated to ints;
- ``sizes_seed``: the seed of that draw. It is fixed in the mix, so that
  every ``--seed`` runs the same set of lengths (the same work) in
  another order; the run's seed draws the order, the features, the
  labels and the weights;
- ``buckets``: the padded lengths a batch may take (``train``);
- ``batch_size``: bags a batch (``train``);
- ``rate_per_s``: the requests offered a second (``serve``); ``arrivals``:
  ``even`` (the default: evenly spaced) or ``gamma`` (gaps drawn from a
  gamma law with the coefficient of variation ``cv``, above 1 for bursts);
  ``sample``: the requests whose logits the check holds to the reference.

The lognormal and the bucketing are frozen copies of the port's epoch
simulation (``tools/bench.py`` ``epoch_slides``) and of its
``data/bucketing.py`` ``batch_bags``, so that a change to the program
cannot move the yardstick.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str, root: Path = TRAFFIC_DIR) -> Dict:
    """The mix ``traffic/<name>.json``."""
    with open(root / f"{name}.json") as f:
        mix = json.load(f)
    if mix.get("mode") not in ("train", "serve"):
        raise ValueError(f"traffic {name}: mode {mix.get('mode')!r} is neither train nor serve")
    return mix


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose of a run (weights, data, order, ...),
    from the run's ``--seed``, which may be any non-negative whole number."""
    words = np.random.SeedSequence([int(seed), int(purpose)]).generate_state(2, np.uint32)
    return int((int(words[0]) << 31) ^ int(words[1])) & ((1 << 63) - 1)


def slide_lengths(mix: Dict) -> np.ndarray:
    """The mix's slide lengths, drawn from ``sizes_seed`` as ``tools/bench.py``
    draws its epoch (lognormal, clipped, truncated)."""
    rng = np.random.default_rng(int(mix["sizes_seed"]))
    lens = rng.lognormal(mean=np.log(float(mix["median"])), sigma=float(mix["sigma"]), size=int(mix["n_slides"]))
    return np.clip(lens, int(mix["min_len"]), int(mix["max_len"])).astype(int)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that holds ``n`` (``data/bucketing.py``)."""
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    raise ValueError(f"a slide of {n} instances exceeds the largest bucket {max(buckets)}")


def bucket_shares(lens: Sequence[int], buckets: Sequence[int]) -> Dict[int, float]:
    """The share of slides that each bucket takes."""
    picks = [pick_bucket(int(n), buckets) for n in lens]
    return {int(b): picks.count(int(b)) / len(picks) for b in sorted(buckets)}


def batch_plan(lens: Sequence[int], buckets: Sequence[int], batch_size: int, seed: int) -> List[Dict]:
    """Batches of ``batch_size`` slides sharing a bucket, as ``batch_bags``
    groups them with ``shuffle``: each bucket's slides in a seeded order,
    cut into batches, a short last batch padded with invalid bags, and the
    batches in one seeded order across buckets. Returns ``[{"bucket",
    "slides": [index, ...]}]``; ``len(slides) < batch_size`` marks the
    padding."""
    rng = np.random.default_rng(seed)
    by_bucket: Dict[int, List[int]] = {}
    for i, n in enumerate(lens):
        by_bucket.setdefault(pick_bucket(int(n), buckets), []).append(i)
    chunks = []
    for b in sorted(by_bucket):
        idxs = by_bucket[b]
        rng.shuffle(idxs)
        for start in range(0, len(idxs), batch_size):
            chunks.append({"bucket": b, "slides": idxs[start:start + batch_size]})
    order = rng.permutation(len(chunks))
    return [chunks[i] for i in order]


def pass_orders(n_items: int, seed: int, n_passes: int) -> List[np.ndarray]:
    """``n_passes`` seeded permutations of ``range(n_items)``: the window
    runs the items pass after pass, each pass in its own order."""
    rng = np.random.default_rng(seed)
    return [rng.permutation(n_items) for _ in range(n_passes)]


def pass_gaps(mix: Dict, n: int, seed: int) -> np.ndarray:
    """The gaps in seconds before each of a pass's ``n`` requests
    (``serve``), which take ``n / rate_per_s`` seconds together:
    ``even`` gaps are all ``1 / rate_per_s``; ``gamma`` gaps are one draw
    from ``sizes_seed``, scaled to that mean, and ``seed`` orders them, so
    that every run offers the same gaps in another order."""
    rate = float(mix["rate_per_s"])
    kind = mix.get("arrivals", "even")
    if kind == "even":
        g = np.full(n, 1.0 / rate)
    elif kind == "gamma":
        cv = float(mix["cv"])
        g = np.random.default_rng([int(mix["sizes_seed"]), 1]).gamma(1.0 / cv ** 2, 1.0, n)
        g = (g * (n / rate) / g.sum())[np.random.default_rng(seed).permutation(n)]
    else:
        raise ValueError(f"arrivals {kind!r} are neither even nor gamma")
    return g
