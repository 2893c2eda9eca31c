"""K1's, K2's and K3's times on the card at the flagship's shapes.

``python -m mhim_mil_torch.utils.time_nystrom [--repeats 3] [--batches 4,1]``

Times ``pass_a`` (K1) and ``pass_b`` (K2) of ``ops/flash_nystrom.py`` at
N 10,241 (the cls token and a 10,240-instance bag), 256 landmarks, fp32,
every token valid, at each batch size of ``--batches`` and at head dims 64
and 128 with 512 / dh heads (the flagship's inner width: 8 heads of 64),
with the operands of :func:`operands` (which ``chip_smoke.py`` uses too);
then ``flash_nystrom`` (K3) forward + backward at the student's shape (B 4,
H 8, N 1,027, valid 1,027 / 943 / 717 / 846, dh 64, m 256) under random
cotangents, with attn's cotangent and without it (the student's case). Per
case: the median of 20 CUDA-event timings of one call after 3 warm-ups, and
the profiler's kernel time per call (mean of 10), ``--repeats`` times in
turn; the card's name and power limit first. It calls only the wrappers
and the glue that every tree of the port has had, so a copy of this file in
another checkout times that checkout's kernels on the same operands (same
seed). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..ops import flash_nystrom as fn
from .time_scan2d import event_ms, kernel_ms

N, M, INNER = 10241, 256, 512
DHS = (64, 128)


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


def k3_case(gen, use_attn: bool):
    """K3's forward + backward at the student's shape, as a call."""
    b, h, n, dh = 4, 8, 1027, 64
    q, k, v, co = (torch.randn(b, h, n, dh, device="cuda", generator=gen) for _ in range(4))
    q = q * dh ** -0.5
    ca = torch.randn(b, h, n, device="cuda", generator=gen)
    mask = torch.arange(n, device="cuda")[None] < torch.tensor([1027, 943, 717, 846], device="cuda")[:, None]

    def call():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out, attn = fn.flash_nystrom(qq, kk, vv, mask, M)
        outs, cots = ((out, attn), (co, ca)) if use_attn else ((out,), (co,))
        return torch.autograd.grad(outs, (qq, kk, vv), cots)

    return call


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
    for dh in DHS:
        h = INNER // dh
        for b in (int(x) for x in args.batches.split(",")):
            a_args, b_args = pass_args(operands(b, h, N, dh, M, torch.full((b,), N, device="cuda"), gen))
            shape = f"[{b}, {h}, {N}, {dh}] m {M}"
            cases += [(f"K1 {shape}", lambda a=a_args: fn.pass_a(*a)),
                      (f"K2 {shape}", lambda a=b_args: fn.pass_b(*a))]
    cases += [(f"K3 forward+backward [4, 8, 1027, 64] m {M}, attn {'used' if u else 'unused'}", k3_case(gen, u))
              for u in (True, False)]
    for rep in range(args.repeats):
        for name, call in cases:
            print(f"{name} fp32 repeat {rep}: {event_ms(call):.4f} ms (kernel {kernel_ms(call):.4f} ms)",
                  flush=True)


if __name__ == "__main__":
    main()
