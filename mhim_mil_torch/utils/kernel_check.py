"""Every kernel of the port against its plain version on the card (the
counterpart of ``tools/pallas_hw_check.py``):

    python3 -m mhim_mil_torch.utils.kernel_check [--small] [--only NAME,...]

The checks and shapes are those of ``pallas_hw_check.py``, and so are the
tolerances but the VJP's, plus the gate's probe:

- ``flash_nystrom_infer`` (K1 + K2, the pseudo-inverse on K3p): 1 × 8 ×
  4,096, dh 64, 256 landmarks, 80% of the tokens valid; out and attn against
  ``nystrom_attention`` in float64 on the same draws by :func:`vjp_close`'s
  criterion, the fp32 ``nystrom_attention`` held to it too; both errors
  are reported, with the entries that miss rtol 1e-4, atol 1e-5 against
  the fp32 reference (the check's criterion until the pseudo-inverse left
  cuBLAS: out sits on the pinv's rounding, and there the fp64 result itself
  misses it in 26 entries) and the entries of each that miss rtol 1e-4,
  atol 1e-5 against fp64. Two controls must fail the criterion
  (:func:`infer_controls`): the pinv's products in single TF32 and 5
  Newton–Schulz iterations for 6;
- ``flash_nystrom_vjp`` (K3, whose backward runs K1b and K2b): the q/k/v
  gradients of out·co + attn·ca at 1 × 8 × 2,048, dh 64, 128 landmarks, 90%
  valid, against an fp64 reference, autograd through ``nystrom_attention``
  on the same draws in float64, by :func:`vjp_close`: elementwise
  ``|g − g64| ≤ 1e-4·|g64| + 1e-5·max(1, max|g64|)``, the max per tensor.
  The fp32 autograd reference (the backward the port had before K1b and
  K2b) is held to the same criterion, and the check fails if it misses,
  since a criterion that the reference itself misses means nothing. Both
  errors are reported. K3's forward and backward, K1b and K2b must each
  have run once;
- ``fused_abmil_pool`` (K4) against the masked softmax pooling: 4 × 10,240
  × 512, bags from half to full; pooled at rtol 1e-5, atol 1e-5, attn at
  rtol 1e-5, atol 1e-6;
- ``selective_scan_2d`` (K5) against the plain separable scan: 1 × 64 × 64,
  ED 64, N 16; rtol 1e-4, atol 1e-5;
- ``probe`` (K6) against ``probe_plain`` on ``ones(8, 128)``: exact.

This VJP criterion differs from ``pallas_hw_check.py``'s (rtol 1e-4, atol
1e-5 against the fp32 reference): there the gradients reach 86, where fp32's
spacing is 7.6e-6, and the fp32 reference's own rounding fails that
tolerance (the fp64 gradient misses it in 13 entries, by up to 1.1e-4 in
dk; the JAX tool's two fp32 formulations miss it in 5), so it admitted no
backward but the reference's own. The absolute term that scales with
max|g64| (8.6e-4 at the full shape, 7.8 times the fp32 reference's largest
error) is far below the 1e-2 to 1 error of a kernel that drops a term or
mis-masks a token; a single-TF32 product misses it 29-43 times over. At
``--small`` (gradients of order 1) it is as tight as before.

``--small`` takes ``pallas_hw_check.py``'s small shapes. Inputs are numpy
draws from fixed seeds, computed in fp32 with TF32 off. A check passes only
if its kernel was launched. The script prints one JSON line and exits 1 on
any failure, and 2 without a CUDA card of capability 9.0.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np
import torch


def _cuda(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device="cuda")


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    return (got - want).abs().max().item()


VJP_RTOL, VJP_ATOL = 1e-4, 1e-5


def vjp_close(got: torch.Tensor, want64: torch.Tensor) -> dict:
    """The VJP criterion against an fp64 reference gradient: elementwise
    ``|g − g64| ≤ 1e-4·|g64| + 1e-5·max(1, max|g64|)``, the max over the
    tensor. Returns ``ok``, the entries that miss (``n_bad``; NaN misses),
    ``max_abs_err`` and the largest share of its allowance an entry takes
    (``of_allowance``, 1 at the limit)."""
    want = want64.double()
    err = (got.to(want.device).double() - want).abs()
    allow = VJP_RTOL * want.abs() + VJP_ATOL * max(1.0, want.abs().max().item())
    bad = ~(err <= allow)
    return {"ok": not bool(bad.any()), "n_bad": int(bad.sum()), "max_abs_err": err.max().item(),
            "of_allowance": (err / allow).max().item()}


def pinv_reference64(x64: torch.Tensor, x32: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """``moore_penrose_pinv`` of ``x64`` (fp64) with the initial scale's two
    maxes taken over the entries that tie for them in ``x32``, the same
    matrices in fp32, as each tie set's mean: torch's max spreads its
    gradient evenly over exact ties, and the row sums of a softmax tie or
    nearly tie at 1, so an fp64 max would send the gradient to other rows
    than the fp32 computation does. With it, fp32's gradient sits within
    the VJP criterion of the fp64 one (:func:`vjp_close`)."""
    from ..ops.nystrom import newton_schulz_plain

    a32 = x32.detach().abs()
    col32, row32 = a32.sum(dim=-1), a32.sum(dim=-2)
    tc, tr = col32 == col32.max(), row32 == row32.max()
    a = x64.abs()
    denom = (a.sum(dim=-1) * tc).sum() / tc.sum() * ((a.sum(dim=-2) * tr).sum() / tr.sum())
    return newton_schulz_plain(x64, x64.transpose(-1, -2) / denom.clamp_min(1e-12), iters)


def infer_case(small: bool, device: str = "cuda"):
    """The draws of the ``flash_nystrom_infer`` check: ``q, k, v, mask, m``."""
    rng = np.random.default_rng(0)
    b, h, n, dh, m = (1, 2, 256, 32, 16) if small else (1, 8, 4096, 64, 256)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, h, n, dh)).astype(np.float32), device=device) for _ in range(3))
    mask = torch.as_tensor(np.arange(n)[None] < int(n * 0.8), device=device)
    return q, k, v, mask, m


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10 mantissa bits, to nearest."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def single_tf32_pinv(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """``moore_penrose_pinv`` with each product's operands rounded once to
    TF32 and summed in fp32 (with TF32 off, as this script runs): what K3p
    would compute without its 3×TF32 split. A control of the infer check."""
    from ..ops.nystrom import pinv_start

    x, z = pinv_start(x)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    mm = lambda a, b: tf32(a) @ tf32(b)
    for _ in range(iters):
        xz = mm(x, z)
        z = 0.25 * mm(z, 13 * eye - mm(xz, 15 * eye - mm(xz, 7 * eye - xz)))
    return z


def infer_controls(q, k, v, mask, m, want64) -> dict:
    """Two wrong forwards that the infer check's criterion must reject,
    each ``flash_nystrom_infer`` on the check's draws with its pinv broken:
    the products in single TF32 (:func:`single_tf32_pinv` in place of
    K3p's), and 5 Newton–Schulz iterations for 6. Returns ``{control:
    {"out": vjp_close, "attn": vjp_close}}`` against ``want64``."""
    from unittest import mock

    from ..ops import flash_nystrom as fn

    def tf32_pinv():
        with mock.patch.object(fn, "pseudo_inverse", single_tf32_pinv):
            return fn.flash_nystrom_infer(q, k, v, mask, m)

    runs = {"pinv products in single TF32": tf32_pinv,
            "pinv of 5 iterations": lambda: fn.flash_nystrom_infer(q, k, v, mask, m, pinv_iters=5)}
    return {name: {part: vjp_close(g, g64) for part, g, g64 in zip(("out", "attn"), run(), want64)}
            for name, run in runs.items()}


def check_nystrom_infer(small: bool) -> dict:
    from ..ops import flash_nystrom as fn
    from ..ops import nystrom_pinv as npv
    from ..ops.nystrom import nystrom_attention

    q, k, v, mask, m = infer_case(small)
    ref32 = nystrom_attention(q, k, v, mask, m, return_attn=True)
    want64 = nystrom_attention(q.double(), k.double(), v.double(), mask, m, return_attn=True)
    counts = lambda: (fn.pass_a.launches, fn.pass_b.launches, npv.pinv_product.launches)
    launched = counts()
    got = fn.flash_nystrom_infer(q, k, v, mask, m)
    torch.cuda.synchronize()
    if counts() != (launched[0] + 1, launched[1] + 1, launched[2] + 24):
        raise AssertionError("K1 and K2 were not launched once each, or the pinv not 24 times on K3p")
    res = {"max_abs_err": 0.0, "of_allowance": 0.0, "fp32_reference_max_abs_err": 0.0,
           "fp32_reference_of_allowance": 0.0, "fp64_misses_at_rtol_1e-4_atol_1e-5": {}, "controls_of_allowance": {}}
    old_misses = lambda g, want: int(((g.double() - want.double()).abs() > 1e-5 + 1e-4 * want.double().abs()).sum())
    for name, g, g32, g64 in zip(("out", "attn"), got, ref32, want64):
        r32, r = vjp_close(g32, g64), vjp_close(g, g64)
        err = (g - g32).abs()
        off = old_misses(g, g32)
        miss64 = {"kernel": old_misses(g, g64), "fp32_reference": old_misses(g32, g64)}
        res["fp64_misses_at_rtol_1e-4_atol_1e-5"][name] = miss64
        print(f"flash_nystrom_infer {name}: kernel max|d| {r['max_abs_err']:.3e} ({r['of_allowance']:.3f} of the "
              f"allowance), fp32 reference {r32['max_abs_err']:.3e} ({r32['of_allowance']:.3f}); max|ref64| "
              f"{g64.abs().max().item():.3e}; against the fp32 reference at rtol 1e-4 atol 1e-5: kernel "
              f"{off} entries off, max|d| {err.max().item():.3e}; fp64 {old_misses(g64, g32)} entries off; "
              f"against fp64 at rtol 1e-4 atol 1e-5: kernel {miss64['kernel']} entries off, fp32 reference "
              f"{miss64['fp32_reference']}", file=sys.stderr)
        if not r32["ok"]:
            raise AssertionError(f"{name}: the fp32 reference misses the criterion in {r32['n_bad']} entries")
        if not r["ok"]:
            raise AssertionError(f"{name}: {r['n_bad']} entries miss the criterion, max|d| {r['max_abs_err']:.3e}")
        for key, x in (("", r), ("fp32_reference_", r32)):
            for part in ("max_abs_err", "of_allowance"):
                res[key + part] = max(res[key + part], x[part])
    for control, parts in infer_controls(q, k, v, mask, m, want64).items():
        print(f"flash_nystrom_infer control '{control}': " + "; ".join(
            f"{part} {p['n_bad']} entries miss, {p['of_allowance']:.3f} of the allowance" for part, p in parts.items()),
              file=sys.stderr)
        if all(p["ok"] for p in parts.values()):
            raise AssertionError(f"the criterion does not reject the control '{control}'")
        res["controls_of_allowance"][control] = max(p["of_allowance"] for p in parts.values())
    return res


def check_nystrom_vjp(small: bool) -> dict:
    from ..ops import flash_nystrom as fn
    from ..ops.nystrom import nystrom_attention

    rng = np.random.default_rng(2)
    b, h, n, dh, m = (1, 2, 128, 16, 8) if small else (1, 8, 2048, 64, 128)
    q, k, v = (_cuda(rng.normal(size=(b, h, n, dh))) for _ in range(3))
    mask = torch.as_tensor(np.arange(n)[None] < int(n * 0.9), device="cuda")
    co = _cuda(rng.normal(size=(b, h, n, dh)))
    ca = _cuda(rng.normal(size=(b, h, n)))

    def grads(f, dtype=torch.float32):
        qq, kk, vv = (t.to(dtype, copy=True).requires_grad_() for t in (q, k, v))
        out, attn = f(qq, kk, vv)
        return torch.autograd.grad((out * co.to(dtype)).sum() + (attn * ca.to(dtype)).sum(), (qq, kk, vv))

    def counts():
        return (fn.flash_nystrom.forward_calls, fn.flash_nystrom.backward_calls, fn.pass_a_backward.launches,
                fn.pass_b_backward.launches)

    before = counts()
    got = grads(lambda *t: fn.flash_nystrom(*t, mask, m))
    torch.cuda.synchronize()
    if counts() != tuple(c + 1 for c in before):
        raise AssertionError(f"K3's forward, its backward, K1b and K2b did not run once each: "
                             f"{before} -> {counts()}")
    plain = lambda *t: nystrom_attention(*t, mask, m, return_attn=True)
    want64, ref32 = grads(plain, torch.float64), grads(plain)
    res = {"max_abs_err": 0.0, "of_allowance": 0.0, "fp32_reference_max_abs_err": 0.0,
           "fp32_reference_of_allowance": 0.0}
    for name, g, g32, g64 in zip(("dq", "dk", "dv"), got, ref32, want64):
        r32, r = vjp_close(g32, g64), vjp_close(g, g64)
        print(f"flash_nystrom_vjp {name}: kernel max|d| {r['max_abs_err']:.3e} ({r['of_allowance']:.3f} of "
              f"the allowance), fp32 reference {r32['max_abs_err']:.3e} ({r32['of_allowance']:.3f}); "
              f"max|g64| {g64.abs().max().item():.3e}", file=sys.stderr)
        if not r32["ok"]:
            raise AssertionError(f"{name}: the fp32 reference misses the criterion in {r32['n_bad']} entries")
        if not r["ok"]:
            raise AssertionError(f"{name}: {r['n_bad']} entries miss the criterion, max|d| {r['max_abs_err']:.3e}")
        for key, x in (("", r), ("fp32_reference_", r32)):
            for part in ("max_abs_err", "of_allowance"):
                res[key + part] = max(res[key + part], x[part])
    return res


def check_abmil(small: bool) -> dict:
    from ..ops import abmil_pool
    from ..ops.masked import masked_softmax

    rng = np.random.default_rng(1)
    b, n, d = (2, 256, 32) if small else (4, 10240, 512)
    x = _cuda(rng.normal(size=(b, n, d)))
    logits = _cuda(rng.normal(size=(b, n)) * 3)
    mask = torch.as_tensor(np.arange(n)[None] < np.linspace(n // 2, n, b, dtype=int)[:, None], device="cuda")
    attn_want = masked_softmax(logits, mask)
    pooled_want = torch.einsum("bn,bnd->bd", attn_want, torch.where(mask[..., None], x, 0.0))
    launched = abmil_pool.fused_abmil_pool.launches
    pooled, attn = abmil_pool.fused_abmil_pool(x, logits, mask)
    torch.cuda.synchronize()
    if abmil_pool.fused_abmil_pool.launches != launched + 1:
        raise AssertionError("K4 was not launched")
    return {"max_abs_err": max(_close(pooled, pooled_want, 1e-5, 1e-5), _close(attn, attn_want, 1e-5, 1e-6))}


def check_scan2d(small: bool) -> dict:
    from ..ops import scan2d
    from ..ops.scan import selective_scan_2d

    rng = np.random.default_rng(3)
    bs, h, w, ed, n = (1, 6, 8, 8, 4) if small else (1, 64, 64, 64, 16)
    x = _cuda(rng.normal(size=(bs, h, w, ed)))
    delta = _cuda(np.log1p(np.exp(rng.normal(size=(bs, h, w, ed)))) * 0.1)
    a_log = _cuda(np.log(np.tile(np.arange(1, n + 1, dtype=np.float32), (ed, 1))))
    B = _cuda(rng.normal(size=(bs, h, w, n)))
    C = _cuda(rng.normal(size=(bs, h, w, n)))
    D = _cuda(rng.normal(size=(ed,)))
    want = selective_scan_2d(x, delta, -torch.exp(a_log), B, C, D)
    launched = scan2d.selective_scan_2d_fused.launches
    got = scan2d.selective_scan_2d_fused(x, delta, a_log, B, C, D)
    torch.cuda.synchronize()
    if scan2d.selective_scan_2d_fused.launches != launched + 1:
        raise AssertionError("K5 was not launched")
    return {"max_abs_err": _close(got, want, 1e-4, 1e-5)}


def check_probe(small: bool) -> dict:
    from ..ops import probe

    x = torch.ones(8, 128, device="cuda")
    launched = probe.probe.launches
    got = probe.probe(x)
    torch.cuda.synchronize()
    if probe.probe.launches != launched + 1:
        raise AssertionError("K6 was not launched")
    err = (got - probe.probe_plain(x)).abs().max().item()
    if err != 0.0 or got[0, 0].item() != 2.0:
        raise AssertionError(f"probe: max|d| {err} against x + 1")
    return {"max_abs_err": err}


CHECKS = {
    "flash_nystrom_infer": check_nystrom_infer,
    "flash_nystrom_vjp": check_nystrom_vjp,
    "fused_abmil_pool": check_abmil,
    "selective_scan_2d": check_scan2d,
    "probe": check_probe,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's kernels against their plain versions on the card")
    ap.add_argument("--small", action="store_true", help="the small shapes of pallas_hw_check.py --small")
    ap.add_argument("--only", default=None, help="comma-separated subset of " + ",".join(CHECKS))
    args = ap.parse_args(argv)
    selected = args.only.split(",") if args.only else list(CHECKS)
    unknown = [s for s in selected if s not in CHECKS]
    if unknown or not selected:
        print(json.dumps({"kernel_check": {}, "ok": False, "error": f"unknown checks {unknown}"}))
        return 1
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        why = ("no CUDA device" if not torch.cuda.is_available()
               else f"compute capability {torch.cuda.get_device_capability(0)}, the kernels are built for sm_90a")
        print(json.dumps({"kernel_check": {}, "ok": False, "error": f"needs an H100: {why}"}))
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ..kernels import build_all

    build_all()
    results, failed = {}, []
    for name in selected:
        t0 = time.perf_counter()
        try:
            res = {"status": "PASS", **CHECKS[name](args.small)}
        except Exception:
            traceback.print_exc()
            res = {"status": "FAIL"}
            failed.append(name)
        res["seconds"] = time.perf_counter() - t0
        results[name] = res
    print(json.dumps({"kernel_check": results, "device": torch.cuda.get_device_name(0),
                      "small": args.small, "ok": not failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
