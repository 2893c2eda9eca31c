"""The port's kernel gate and its probe (K6) against the JAX package's
Mosaic probe, on the CPU.

The gate's rules: an explicit ``use_flash_attn`` wins, the CPU is
``skipped``, and on CUDA a failed step raises where JAX turns the flag off.
The CUDA branch runs here with the card's answers monkeypatched; the probe
and the kernel check themselves run on the card (``test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mhim_mil_torch.config import load_config
from mhim_mil_torch.ops import probe
from mhim_mil_torch.utils import kernel_check, kernel_gate
from mhim_mil_tpu.utils.pallas_gate import _PROBE_SRC as JAX_PROBE_SRC


def _cfg(**kw):
    return load_config([], model="mhim", **kw)


def _no_probe():
    raise AssertionError("the gate probed the card")


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_explicit_flag_wins(monkeypatch, flag, device):
    monkeypatch.setattr(kernel_gate, "probe_kernels", _no_probe)
    lines = []
    cfg, res = kernel_gate.resolve_kernel_gate(_cfg(use_flash_attn=flag), torch.device(device), log=lines.append)
    assert cfg.use_flash_attn is flag
    assert res.pop("seconds") >= 0
    assert res == {"outcome": "explicit", "detail": f"use_flash_attn={flag}", "probe_launches": 0}
    assert lines == [f"[kernel-gate] explicit: use_flash_attn={flag} -> use_flash_attn={flag}"]


def test_cpu_is_skipped_and_runs_the_plain_versions(monkeypatch):
    monkeypatch.setattr(kernel_gate, "probe_kernels", _no_probe)
    lines = []
    cfg, res = kernel_gate.resolve_kernel_gate(_cfg(), torch.device("cpu"), log=lines.append)
    assert cfg.use_flash_attn is False and res["outcome"] == "skipped" and res["probe_launches"] == 0
    assert lines[0].startswith("[kernel-gate] skipped: ") and lines[0].endswith("-> use_flash_attn=False")


@pytest.mark.parametrize("outcome", ["probe_failed", "probe_timeout", "check_failed"])
def test_a_failed_step_on_cuda_raises(monkeypatch, outcome):
    """Where JAX's gate turns the flag off (pallas_gate.py:130-134), the
    port's raises with the detail: no silent plain path on the card."""
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    monkeypatch.setattr(kernel_gate, "probe_kernels",
                        lambda: {"outcome": outcome, "detail": "nvcc: boom", "probe_launches": 0})
    lines = []
    with pytest.raises(kernel_gate.KernelGateError, match=f"{outcome}: nvcc: boom") as err:
        kernel_gate.resolve_kernel_gate(_cfg(), torch.device("cuda"), log=lines.append)
    assert err.value.result["outcome"] == outcome
    assert lines == [f"[kernel-gate] {outcome}: nvcc: boom -> use_flash_attn=False"]


def test_an_older_card_raises_before_any_probe(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (8, 0))
    monkeypatch.setattr(kernel_gate, "probe_kernels", _no_probe)
    with pytest.raises(kernel_gate.KernelGateError, match="compute capability"):
        kernel_gate.resolve_kernel_gate(_cfg(), torch.device("cuda"), log=lambda s: None)


def test_a_green_gate_enables_the_kernels(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    monkeypatch.setattr(kernel_gate, "probe_kernels",
                        lambda: {"outcome": "enabled", "detail": "ok", "probe_launches": 1})
    cfg, res = kernel_gate.resolve_kernel_gate(_cfg(), torch.device("cuda"), log=lambda s: None)
    assert cfg.use_flash_attn is True and res["probe_launches"] == 1


def test_the_probe_subprocess_reports_a_failure_without_a_card():
    """The probe really runs in a subprocess: without a card its launch
    fails there, and the gate reads ``probe_failed``, never a pass."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe would pass")
    res = kernel_gate.probe_kernels()
    assert res["outcome"] == "probe_failed" and res["probe_launches"] == 0, res


def test_probe_plain_matches_the_jax_probe_kernel():
    """probe_plain against the kernel ``k`` of JAX's ``_PROBE_SRC``, run with
    ``pl.pallas_call(..., interpret=True)`` on ones(8, 128) and random values."""
    ns = {}
    exec(JAX_PROBE_SRC.split("\nx = ")[0], ns)  # the imports and the kernel k, not its compiled call
    for x in (np.ones((8, 128), np.float32), np.random.default_rng(0).normal(size=(8, 128)).astype(np.float32)):
        want = pl.pallas_call(ns["k"], out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), interpret=True)(
            jnp.asarray(x))
        got = probe.probe_plain(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_probe_refuses_cpu_tensors():
    """K6 proves the card; it has no plain fallback."""
    before = probe.probe.launches
    with pytest.raises(ValueError, match="on the card"):
        probe.probe(torch.ones(8, 128))
    assert probe.probe.launches == before


def test_kernel_check_without_a_card_exits_nonzero(capsys):
    """No card, or no check selected: a nonzero exit and ``"ok": false``,
    never a vacuous pass."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert kernel_check.main(["--small"]) == 2
    out = capsys.readouterr().out
    assert '"ok": false' in out and "needs an H100" in out
    assert kernel_check.main(["--only", "nothing"]) == 1
    assert '"ok": false' in capsys.readouterr().out
