"""K1's and K2's times on the card at the flagship's shapes.

``python -m mhim_mil_torch.utils.time_nystrom [--repeats 3] [--batches 4,1]``

Times ``pass_a`` (K1) and ``pass_b`` (K2) of ``ops/flash_nystrom.py`` at
H 8, N 10,241 (the cls token and a 10,240-instance bag), dh 64, 256
landmarks, fp32, every token valid, at each batch size of ``--batches``,
with the operands of :func:`operands` (which ``chip_smoke.py`` uses too).
Per case: the median of 20 CUDA-event timings of one call after 3 warm-ups,
and the profiler's kernel time per call (mean of 10), ``--repeats`` times in
turn; the card's name and power limit first. It calls only the wrappers and
the glue that every tree of the port has had, so a copy of this file in
another checkout times that checkout's kernels on the same operands (same
seed). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..ops import flash_nystrom as fn
from .time_scan2d import event_ms, kernel_ms

H, N, DH, M = 8, 10241, 64, 256


def operands(b, h, n, dh, m, lengths, gen):
    """Realistic K1/K2 operands on the card: random q/k/v (q scaled by
    dh^-½ as the model's), the mask of ``lengths`` valid tokens per bag, and
    the glue of ``flash_nystrom_infer`` between the passes (plain K1)."""
    q = torch.randn(b, h, n, dh, device="cuda", generator=gen) * dh ** -0.5
    k = torch.randn(b, h, n, dh, device="cuda", generator=gen)
    v = torch.randn(b, h, n, dh, device="cuda", generator=gen)
    mask = torch.arange(n, device="cuda")[None] < lengths[:, None]
    q_l, k_l, lm_mask, pinv = fn.landmarks(q, k, mask, m)
    attn3v, m3, s3 = fn.pass_a_plain(q_l, k, v, mask)
    mid, rp = fn.pass_b_operands(q, k_l, mask, lm_mask, pinv, attn3v, s3)
    return dict(q=q, k=k, v=v, mask=mask, q_l=q_l, k_l=k_l, lm_mask=lm_mask, mid=mid, rp=rp, m3=m3)


def pass_args(o):
    """The arguments of ``pass_a`` and of ``pass_b`` from :func:`operands`."""
    return ((o["q_l"], o["k"], o["v"], o["mask"]),
            (o["q"], o["k"], o["mask"], o["k_l"], o["lm_mask"], o["mid"], o["q_l"], o["rp"], o["m3"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batches", default="4,1", help="comma-separated batch sizes")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print(f"timing {fn.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for b in (int(x) for x in args.batches.split(",")):
        a_args, b_args = pass_args(operands(b, H, N, DH, M, torch.full((b,), N, device="cuda"), gen))
        cases += [("K1", b, lambda a=a_args: fn.pass_a(*a)), ("K2", b, lambda a=b_args: fn.pass_b(*a))]
    for rep in range(args.repeats):
        for kid, b, call in cases:
            print(f"{kid} [{b}, {H}, {N}, {DH}] m {M} fp32 repeat {rep}: {event_ms(call):.4f} ms "
                  f"(kernel {kernel_ms(call):.4f} ms)", flush=True)


if __name__ == "__main__":
    main()
