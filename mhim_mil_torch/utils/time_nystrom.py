"""K1's, K2's, K3's, K2b's, K1b's and K3p's times on the card.

``python -m mhim_mil_torch.utils.time_nystrom [--repeats 3] [--batches 4,1] [--cases passes,k3,backward,pinv]``

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
(:func:`sdpa_backward`). ``pinv``: the pseudo-inverse of the flagship's
attn2 at G 32, 16 and 8 (:func:`pinv_cases`): K3p forward and forward +
backward, the plain ``moore_penrose_pinv``, 24, 72 and one ``torch.bmm``
calls in fp32, one K3p product, and K3p's forward and one product at each
tile the kernel is built for (``pinv_plan``'s choice and the other), also
at 128 landmarks. The
K3 and pseudo-inverse cases first print their device time by kernel
(:func:`print_breakdown`).

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
from .time_scan2d import breakdown, by_kind, event_ms, kernel_ms

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


def attn2_operand(gen, b, n=N, lengths=None, h=8, dh=64, m=M):
    """The glue's ``attn2 = softmax(q_l·k_lᵀ)`` over the valid landmarks,
    ``[b, h, m, m]``, from random q (scaled by dh^-½) and k of ``lengths``
    valid tokens a bag (all ``n`` where None), as K3p's pseudo-inverse gets
    it: the flagship's at N 10,241, the student's at N 1,027."""
    from ..ops.masked import masked_softmax
    from ..ops.nystrom import _landmark_mean

    q = torch.randn(b, h, n, dh, device="cuda", generator=gen) * dh ** -0.5
    k = torch.randn(b, h, n, dh, device="cuda", generator=gen)
    lengths = torch.full((b,), n, device="cuda") if lengths is None else torch.as_tensor(lengths, device="cuda")
    mask = torch.arange(n, device="cuda")[None] < lengths[:, None]
    mv = mask[:, None, :, None]
    q_l, lm_mask = _landmark_mean(torch.where(mv, q, 0.0), mask, m)
    k_l, _ = _landmark_mean(torch.where(mv, k, 0.0), mask, m)
    return masked_softmax(q_l @ k_l.transpose(-1, -2), lm_mask[:, None, None, :])


def at_tile(npv, tile, call):
    """``call`` with K3p's products at ``tile`` whatever ``pinv_plan`` takes."""
    def run():
        plan = npv.pinv_plan
        npv.pinv_plan = lambda g, m, sms=0: tile
        try:
            return call()
        finally:
            npv.pinv_plan = plan
    return run


def pinv_cases(gen):
    """(name, call) of the pseudo-inverse of the flagship's attn2 at batch 4
    (G 32), 2 (G 16) and 1 (G 8), forward and forward + backward: K3p's
    ``pseudo_inverse`` where this tree has it, the plain
    ``moore_penrose_pinv``, and 24 (72) ``torch.bmm`` calls in fp32 as the
    library yardstick; one K3p product beside one ``torch.bmm``; K3p's
    forward and one product at each of its tiles, at m 256 and 128."""
    from ..ops.nystrom import moore_penrose_pinv

    try:
        from ..ops import nystrom_pinv as npv
    except ImportError:  # a tree before K3p
        npv = None
    cases = []
    for b in (4, 2, 1):
        x = attn2_operand(gen, b)
        z = torch.randn_like(x)
        cot = torch.randn_like(x)
        shape = f"[{b}, 8, {M}, {M}] (G {8 * b})"

        def fwd_bwd(f, x=x, cot=cot):
            xx = x.detach().requires_grad_()
            return torch.autograd.grad(f(xx), xx, cot)

        def bmms(count, x=x, z=z):
            for _ in range(count):
                torch.bmm(x.view(-1, M, M), z.view(-1, M, M))

        if npv is not None:
            cases += [(f"K3p pseudo_inverse forward {shape}", lambda x=x: npv.pseudo_inverse(x)),
                      (f"K3p pseudo_inverse forward+backward {shape}", lambda f=fwd_bwd: f(npv.pseudo_inverse)),
                      (f"K3p one product {shape}", lambda x=x, z=z: npv.pinv_product(x, z))]
        cases += [(f"plain moore_penrose_pinv forward {shape}", lambda x=x: moore_penrose_pinv(x)),
                  (f"plain moore_penrose_pinv forward+backward {shape}", lambda f=fwd_bwd: f(moore_penrose_pinv)),
                  (f"torch.bmm fp32 x 24 {shape}", lambda f=bmms: f(24)),
                  (f"torch.bmm fp32 x 72 {shape}", lambda f=bmms: f(72)),
                  (f"torch.bmm fp32 x 1 {shape}", lambda f=bmms: f(1))]
    for m in (M, 128) if npv is not None else ():
        for b in (4, 2, 1):
            x = attn2_operand(gen, b, m=m)
            z = torch.randn_like(x)
            for tile in npv.TILES:
                at = (f"at tile {tile[0]}x{tile[1]}{' (plan)' if npv.pinv_plan(8 * b, m) == tile else ''} "
                      f"[{b}, 8, {m}, {m}] (G {8 * b})")
                cases += [(f"K3p forward {at}", at_tile(npv, tile, lambda x=x: npv.pseudo_inverse(x))),
                          (f"K3p one product {at}", at_tile(npv, tile, lambda x=x, z=z: npv.pinv_product(x, z)))]
    return cases


def print_breakdown(name, call):
    """A call's device time by kind of kernel (the port's kernels by id,
    cuBLAS products, elementwise passes, reductions, ...), then by kernel."""
    rows = breakdown(call)
    print(f"{name}: {sum(r[2] for r in rows):.4f} device ms a call in {sum(r[3] for r in rows)} launches; by "
          f"kind: {by_kind([(key, ms, n) for key, _, ms, n in rows])}", flush=True)
    for key, kid, ms, n in rows:
        print(f"  {kid:12s} {ms:9.4f} ms {n:4d} launches  {key[:110]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batches", default="4,1", help="comma-separated batch sizes of the passes' cases")
    ap.add_argument("--cases", default="passes,k3,backward,pinv",
                    help="comma-separated: passes, k3, backward, pinv")
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
    if "pinv" in which:
        cases += pinv_cases(torch.Generator(device="cuda").manual_seed(2))
    for name, call in cases:
        if name.startswith(("K3 ", "K3p pseudo_inverse", "plain moore_penrose_pinv forward+")):
            print_breakdown(name, call)
    for rep in range(args.repeats):
        for name, call in cases:
            ev = event_ms(call)
            dev, records = kernel_ms(call)
            print(f"{name} fp32 repeat {rep}: {ev:.4f} ms (kernel {dev:.4f} ms, {records} kernel records for "
                  f"10 calls)", flush=True)


if __name__ == "__main__":
    main()
