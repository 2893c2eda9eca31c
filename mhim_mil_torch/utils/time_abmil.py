"""K4's time on the card.

``python -m mhim_mil_torch.utils.time_abmil [--repeats 3]``

Times ``fused_abmil_pool`` (K4) at the flagship's ``x[4, 10240, 512]`` in
fp32 with every token valid and with ragged bags, in bf16, at batch 1, and
at 1,536 columns (two column groups), beside the plain version and the
library yardstick ``scaled_dot_product_attention(ones, logits, x, mask)``
and ``x.sum(dim=1)``, which reads x once as K4 does (the rate at which
this card streams x);
and, at the flagship in fp32, K4 at each chunk size of ``CHUNKS`` (tokens
a block: the plan ``abmil_plan`` takes one of them) by the device time of
one call. Per case: the median of 20 CUDA-event timings of one call after
3 warm-ups, and the profiler's kernel time per call over 10 calls, with
the CUDA launches of one call; ``--repeats`` times in turn; the card's name
and power limit first. A copy in an earlier checkout times that tree's K4
(the chunk sweep only where the tree has a plan). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch
import torch.nn.functional as F

from ..ops import abmil_pool
from .time_scan2d import breakdown, event_ms

SHAPES = (("flagship", 4, 10240, 512, torch.float32, False), ("flagship ragged", 4, 10240, 512, torch.float32, True),
          ("flagship bf16", 4, 10240, 512, torch.bfloat16, False), ("batch 1", 1, 10240, 512, torch.float32, False),
          ("D 1536", 4, 10240, 1536, torch.float32, False))
CHUNKS = (64, 80, 128, 160, 240, 320, 480, 640, 1024)


def operands(gen, b, n, d, dtype, ragged):
    """x, attn logits (3·normal) and the mask, on the card; ragged bags
    hold 10,240 / 8,000 / 6,000 / 2,000 tokens."""
    x = torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
    logits = 3 * torch.randn(b, n, device="cuda", generator=gen)
    lengths = torch.tensor([n, 8000, 6000, 2000][:b] if ragged else [n] * b, device="cuda")
    return x, logits, torch.arange(n, device="cuda")[None] < lengths[:, None]


def launches(call) -> int:
    """The device records of one call, after a warm-up."""
    call()
    return sum(n for *_, n in breakdown(call, iters=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for label, b, n, d, dtype, ragged in SHAPES:
        x, logits, mask = operands(gen, b, n, d, dtype, ragged)
        q = torch.ones(b, 1, 1, 1, device="cuda", dtype=dtype)
        shape = f"{label} [{b}, {n}, {d}] {str(dtype).split('.')[-1]}"
        cases += [(f"K4 {shape}", lambda a=(x, logits, mask): abmil_pool.fused_abmil_pool(*a)),
                  (f"plain {shape}", lambda a=(x, logits, mask): abmil_pool.abmil_pool_plain(*a))]
        if dtype == torch.float32:
            cases.append((f"SDPA {shape}", lambda q=q, k=logits[:, None, :, None], v=x[:, None],
                          am=mask[:, None, None, :]: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=1.0)))
        cases.append((f"x.sum(dim=1) {shape}", lambda x=x: x.sum(dim=1)))  # reads x once: the card's streaming rate
    for name, call in cases:
        print(f"{name}: {launches(call)} CUDA launches a call", flush=True)
    plan = getattr(abmil_pool, "abmil_plan", None)
    if plan is not None:
        x, logits, mask = operands(gen, 4, 10240, 512, torch.float32, False)
        print(f"plan at the flagship: {plan(4, 10240)} tokens a block", flush=True)
        for chunk in CHUNKS:
            abmil_pool.abmil_plan = lambda b, n, sms=0, c=chunk: c
            call = lambda: abmil_pool.fused_abmil_pool(x, logits, mask)
            dev = sum(ms for _, _, ms, _ in breakdown(call))
            print(f"K4 flagship fp32 at {chunk} tokens a block ({-(-10240 // chunk) * 4} blocks): {dev:.4f} device ms",
                  flush=True)
        abmil_pool.abmil_plan = plan
    for rep in range(args.repeats):
        for name, call in cases:
            dev = sum(ms for _, _, ms, _ in breakdown(call))
            print(f"{name} repeat {rep}: {event_ms(call):.4f} ms (device {dev:.4f} ms)", flush=True)


if __name__ == "__main__":
    main()
