"""K1's, K2's, K3's, K2b's and K1b's times on the card.

``python -m mhim_mil_torch.utils.time_nystrom [--repeats 3] [--batches 4,1] [--cases passes,k3,backward]``

``passes``: ``pass_a`` (K1) and ``pass_b`` (K2) of ``ops/flash_nystrom.py``
at N 10,241 (the cls token and a 10,240-instance bag), 256 landmarks, fp32,
every token valid, at each batch size of ``--batches`` and at head dims 64
and 128 with 512 / dh heads (the flagship's inner width: 8 heads of 64),
with the operands of :func:`operands` (which ``chip_smoke.py`` uses too).
``k3``: ``flash_nystrom`` (K3) forward + backward at the student's shape
(B 4, H 8, N 1,027, valid 1,027 / 943 / 717 / 846, dh 64, m 256) under
random cotangents, with attn's cotangent and without it (the student's
case). ``backward``: ``pass_b_backward`` (K2b) and ``pass_a_backward``
(K1b) alone on the operands of :func:`backward_operands` (``chip_smoke.py``'s
K2b and K1b phases use them too): at the student's shape without and with
the cls term (K2b) or s3's cotangent (K1b), at dh 128 (B 4, H 4), dh 256
(B 4, H 2), dh 32 (B 4, H 16) and dh 16 (B 4, H 32), each beside the
backward of ``scaled_dot_product_attention`` on the same operands
(:func:`sdpa_backward`).

Per case: the median of 20 CUDA-event timings of one call after 3
warm-ups, and the profiler's kernel time per call over 10 calls (each
kernel's mean record times its launches a call, since the profiler now and
then returns fewer records than there were launches; the records it
returned are printed beside it), ``--repeats`` times in turn; the card's
name and power limit first. It calls only the wrappers and the glue that
every tree of the port since K1b has had (K2b is handed K2's ``out`` where
its wrapper takes it), so a copy of this file in another checkout times
that checkout's kernels on the same operands (same seed). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import subprocess
import warnings

import torch

from ..ops import flash_nystrom as fn
from .time_scan2d import event_ms, kernel_ms

N, M, INNER = 10241, 256, 512
DHS = (64, 128)
BACKWARD_SHAPES = (("student", 4, 8, 64), ("dh 128", 4, 4, 128), ("dh 256", 4, 2, 256), ("dh 32", 4, 16, 32),
                   ("dh 16", 4, 32, 16))  # 512 / dh heads, but 8 at dh 64, 4 at 128 and 2 at 256
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")  # torch's preference


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


def backward_operands(gen, b, h, dh, m=256, n=1027):
    """K2b's and K1b's operands at the student's token count (N 1,027,
    ragged from 600 tokens, the first bag full): :func:`operands`, K1's
    outputs ``attn3v`` and ``s3`` (plain), K2's ``out`` (the kernel, as
    ``PassB`` saves it), and random cotangents: ``d_out`` as a ``[B,H,N,dh]``
    view of ``[B,N,H,dh]`` storage (as the head merge hands it back),
    ``d_cls``, ``d_attn3v``, ``d_s3``; all zero at masked tokens. The
    kernels' phases put NaN there themselves."""
    lengths = torch.randint(600, n + 1, (b,), device="cuda", generator=gen)
    lengths[0] = n
    o = operands(b, h, n, dh, m, lengths, gen)
    o["lengths"] = lengths
    o["attn3v"], _, o["s3"] = fn.pass_a_plain(o["q_l"], o["k"], o["v"], o["mask"])
    o["out"] = fn.pass_b(*pass_args(o)[1])[0]
    tok = o["mask"][:, None, :, None]
    o["d_out"] = torch.where(tok, torch.randn(b, n, h, dh, device="cuda", generator=gen).transpose(1, 2), 0.0)
    o["d_cls"] = torch.where(o["mask"][:, None], torch.randn(b, h, n, device="cuda", generator=gen), 0.0)
    o["d_attn3v"] = torch.randn(b, h, m, dh, device="cuda", generator=gen)
    o["d_s3"] = torch.randn(b, h, m, device="cuda", generator=gen)
    return o


def takes_out() -> bool:
    """Whether this tree's ``pass_b_backward`` takes K2's ``out``."""
    return "out" in inspect.signature(fn.pass_b_backward).parameters


def k2b_call(o, q, k, d_out, d_cls=None):
    """K2b on :func:`backward_operands` (``q``, ``k``, ``d_out`` and
    ``d_cls`` as given), with ``out`` where this tree's wrapper takes it."""
    args = (q, k, o["mask"], o["k_l"], o["lm_mask"], o["mid"], o["q_l"], o["rp"], o["m3"], d_out, d_cls)
    kw = {"out": o["out"]} if takes_out() else {}
    return args, kw


def sdpa_backward(q, k, v, mask, d_out):
    """The library yardstick of a backward kernel: the backward of
    ``scaled_dot_product_attention(q, k, v, mask, scale=1)`` under ``d_out``,
    on the first backend, in torch's order of preference, that takes these
    inputs. Returns the timed call (the backward alone, the forward's graph
    kept), its gradients and the backend's name."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns its reason
                out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=1.0)
            grads = torch.autograd.grad(out, leaves, d_out, retain_graph=True)
        except RuntimeError:
            continue
        return (lambda: torch.autograd.grad(out, leaves, d_out, retain_graph=True)), grads, name
    raise RuntimeError("no scaled_dot_product_attention backend takes the yardstick's inputs")


def backward_cases(gen):
    """(name, call) of K2b and K1b at :data:`BACKWARD_SHAPES`, each beside
    its SDPA backward."""
    cases = []
    for label, b, h, dh in BACKWARD_SHAPES:
        o = backward_operands(gen, b, h, dh)
        shape = f"{label} [{b}, {h}, 1027, {dh}] m {M}"
        for cls in ((False, True) if label == "student" else (False,)):
            args, kw = k2b_call(o, o["q"], o["k"], o["d_out"], o["d_cls"] if cls else None)
            cases.append((f"K2b {shape}, cls term {'on' if cls else 'off'}",
                          lambda a=args, kw=kw: fn.pass_b_backward(*a, **kw)))
        lib, _, backend = sdpa_backward(o["q"], o["k_l"], o["mid"], o["lm_mask"][:, None, None, :], o["d_out"])
        cases.append((f"K2b's SDPA backward ({backend}) {shape}", lib))
        a_args = (o["q_l"], o["k"], o["v"], o["mask"], o["attn3v"], o["m3"], o["s3"], o["d_attn3v"])
        for s3 in ((False, True) if label == "student" else (False,)):
            cases.append((f"K1b {shape}, s3's cotangent {'on' if s3 else 'off'}",
                          lambda a=a_args + ((o["d_s3"] if s3 else None),): fn.pass_a_backward(*a)))
        lib, _, backend = sdpa_backward(o["q_l"], o["k"], o["v"], o["mask"][:, None, None, :], o["d_attn3v"])
        cases.append((f"K1b's SDPA backward ({backend}) {shape}", lib))
    return cases


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
    ap.add_argument("--batches", default="4,1", help="comma-separated batch sizes of the passes' cases")
    ap.add_argument("--cases", default="passes,k3,backward", help="comma-separated: passes, k3, backward")
    args = ap.parse_args(argv)
    which = set(args.cases.split(","))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print(f"timing {fn.__file__}; K2b handed K2's out: {takes_out()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    if "passes" in which:
        for dh in DHS:
            h = INNER // dh
            for b in (int(x) for x in args.batches.split(",")):
                a_args, b_args = pass_args(operands(b, h, N, dh, M, torch.full((b,), N, device="cuda"), gen))
                shape = f"[{b}, {h}, {N}, {dh}] m {M}"
                cases += [(f"K1 {shape}", lambda a=a_args: fn.pass_a(*a)),
                          (f"K2 {shape}", lambda a=b_args: fn.pass_b(*a))]
    if "k3" in which:
        cases += [(f"K3 forward+backward [4, 8, 1027, 64] m {M}, attn {'used' if u else 'unused'}",
                   k3_case(gen, u)) for u in (True, False)]
    if "backward" in which:
        cases += backward_cases(torch.Generator(device="cuda").manual_seed(1))
    for rep in range(args.repeats):
        for name, call in cases:
            ev = event_ms(call)
            dev, records = kernel_ms(call)
            print(f"{name} fp32 repeat {rep}: {ev:.4f} ms (kernel {dev:.4f} ms, {records} kernel records for "
                  f"10 calls)", flush=True)


if __name__ == "__main__":
    main()
