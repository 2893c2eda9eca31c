"""Sequence parallelism (``mesh_sp > 1``) of the scan families, ``2dmamba``
and ``mambamil`` (simple, srmamba, bimamba), against the JAX package's
single-device functions on the CPU.

One launch of a gloo world of 4 processes (``tests/torch_dp_worker.py``)
runs every case on its own mesh: the ops at ``dp=1, sp=4`` (the plain 2D
scan and K5's op over 4 uneven bands of grid rows, 7 rows of 2, 2, 2 and 1,
each band's state carried from the bands above by ``sp_carry``; the masked
1D scan over 4 blocks, forward and reversed, on ragged bags one of whose
blocks holds only padding; rasterizing onto the bands, with coordinates and
row-major, with two valid instances on one cell from different ranks;
2dmamba's evaluation), the train steps at ``dp=2, sp=2``, and the control
that scans the bands without the carry. JAX's side runs in this process on
one device, which JAX's own tests hold equal to its ``(dp, sp)`` mesh.
Both sides start from flax's initial weights (mapped by
``utils/weights.py``); dropout is the identity on both sides. Small widths:
input and model dim 32, 4 states, bags of 64 instance slots, 2dmamba's
grid 9 × 7 with ``pos`` and 8 × 8 row-major without.

Tolerances are ``tests/test_torch_sp.py``'s: the scans' outputs rtol 1e-5
and atol 1e-5·max|ref|, their gradients within 1e-5 of each tensor's
max|g|; the steps' loss rtol 1e-5, Adam's first moments within 1e-5 of
max|g| (of the tensor, or of the model where the tensor's whole gradient
lies within that of zero), the parameters by ``_check_params``; the
evaluation's logits and attention rtol 1e-4, atol 1e-5·max|ref|; the
driver's c-index within 1e-6 of one process's.
"""

import json
import os
import re

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.steps import make_train_step as j_make_train_step
from mhim_mil_tpu.engine.train_state import create_train_state as j_create_train_state
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models import mamba as jmamba
from mhim_mil_tpu.ops import scan as jscan
from mhim_mil_tpu.utils import schedules as jsched
from mhim_mil_torch.ops import scan2d
from mhim_mil_torch.utils import weights
from test_torch_sp import GRAD_TOL, SPE, WORKER, _check_params, _close, _grad_close, _group, _np_params, _torchrun

WORLD = 4
STEP_CFG = dict(input_dim=32, n_classes=2, batch_size=8, dropout=0.0, lr=1e-3, lr_sche="const", num_epoch=1,
                compute_dtype="float32", mambamil_dim=32, mambamil_state_dim=4)
GRID_H, GRID_W = 9, 7
MAMBA2D = {"2dmamba_pos": dict(model="2dmamba", mamba_2d_max_h=GRID_H, mamba_2d_max_w=GRID_W),
           "2dmamba_rowmajor": dict(model="2dmamba")}
MAMBAMIL = {f"mambamil_{v}": dict(model="mambamil", mambamil_type=t, mambamil_rate=4)
            for v, t in (("simple", "SimpleMamba"), ("srmamba", "SRMamba"), ("bimamba", "BiMamba"))}
SCAN2D = dict(bs=2, h=7, w=5, ed=6, n=4)  # 7 rows over 4 ranks: bands of 2, 2, 2 and 1
SCAN1D = dict(bs=3, length=50, ed=6, n=4, lengths=(50, 26, 30))  # blocks 13, 13, 12, 12: bag 1's last two pad only
COLLIDE = (3, 50)  # bag 0's instances on one cell: blocks 0 and 3 of 61 instances over 4 ranks


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---- inputs ----------------------------------------------------------------------------


def _scan_inputs(seed, shape, n):
    """x, Δ (0.1·softplus of a normal, so that the state carries across
    bands), A = −exp(A_log) with A_log log U(0.5, 4), B, C, D and the
    cotangent of y, from a numpy seed; ``shape`` is x's."""
    rng = np.random.default_rng(seed)
    ed = shape[-1]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"x": f32(rng.normal(size=shape)), "delta": f32(0.1 * np.log1p(np.exp(rng.normal(size=shape)))),
            "A": f32(-rng.uniform(0.5, 4.0, size=(ed, n))), "B": f32(rng.normal(size=shape[:-1] + (n,))),
            "C": f32(rng.normal(size=shape[:-1] + (n,))), "D": f32(rng.normal(size=(ed,))),
            "cot": f32(rng.normal(size=shape))}


def _scan1d_inputs():
    c = SCAN1D
    d = _scan_inputs(1, (c["bs"], c["length"], c["ed"]), c["n"])
    d["mask"] = np.arange(c["length"])[None] < np.asarray(c["lengths"])[:, None]
    return d


def _raster_inputs():
    """Two bags of 61 instances (the second ragged at 45) at distinct cells
    of the 9 × 7 grid, except bag 0's instances ``COLLIDE``, both valid,
    on one cell."""
    rng = np.random.default_rng(2)
    b, n, c = 2, 61, 8
    cells = np.stack([rng.permutation(GRID_H * GRID_W)[:n] for _ in range(b)])
    cells[0, COLLIDE[1]] = cells[0, COLLIDE[0]]
    return {"feats": rng.normal(size=(b, n, c)).astype(np.float32),
            "coords": np.stack([cells % GRID_W, cells // GRID_W], -1).astype(np.int64),
            "mask": np.arange(n)[None] < np.array([[n], [45]]), "pad": rng.normal(size=(c,)).astype(np.float32)}


def _batch(with_pos: bool):
    """8 ragged bags of up to 60 instances in 64 slots, the last a padding
    bag; with ``pos`` each bag's instances at distinct cells of the 9 × 7
    grid."""
    rng = np.random.default_rng(4)
    b, n = 8, 64
    lengths = rng.integers(40, 61, (b,))
    lengths[-1] = 0
    mask = np.arange(n)[None] < lengths[:, None]
    out = {"feats": np.where(mask[..., None], rng.normal(size=(b, n, 32)), 0.0).astype(np.float32), "mask": mask,
           "bag_valid": lengths > 0, "target": (np.arange(b) % 2).astype(np.int32)}
    if with_pos:
        cells = np.stack([np.concatenate([rng.permutation(GRID_H * GRID_W), [0]]) for _ in range(b)])
        out["pos"] = np.stack([cells % GRID_W, cells // GRID_W], -1).astype(np.int32)
    return out


def _jax_init(cfg: dict, batch):
    """JAX's model, family, config and initial train state for ``cfg``
    (flax's init on the batch's first 8 slots of its first bag)."""
    jcfg = j_load_config([], **cfg)
    jm, family = j_build_model(jcfg)
    sample = {k: jnp.asarray(v[:1, :8] if v.ndim > 1 else v[:1]) for k, v in batch.items()}
    state = j_create_train_state(jcfg, jm, jax.random.PRNGKey(0), sample, jsched.make_lr_schedule(jcfg, SPE))
    return jcfg, jm, family, state


def _to_port(cfg: dict, params) -> dict:
    fn = weights.mamba2d_state_from_flax if cfg["model"] == "2dmamba" else weights.mambamil_state_from_flax
    return fn(_np_params(params))


@pytest.fixture(scope="module")
def inits():
    """JAX's initial state of each model case, made once."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = {**STEP_CFG, **{**MAMBA2D, **MAMBAMIL}[name]}
            cache[name] = (cfg, _batch(name == "2dmamba_pos"), *_jax_init(cfg, _batch(name == "2dmamba_pos")))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def world(tmp_path_factory, inits):
    """One gloo world of WORLD ranks running every case; returns the cases'
    inputs and rank 0's results, by case."""
    tmp = tmp_path_factory.mktemp("sp_scan")
    specs, arrays, inputs = [], {}, {}

    def add(spec, **groups):
        specs.append(spec)
        inputs[spec["name"]] = groups
        for g, d in groups.items():
            for k, v in d.items():
                arrays[f"{spec['name']}/{g}/{k}"] = np.asarray(v)

    ops = dict(kind="scan_ops", dp=1, sp=WORLD)
    s2 = SCAN2D
    scan2d_in = _scan_inputs(0, (s2["bs"], s2["h"], s2["w"], s2["ed"]), s2["n"])
    add({"name": "scan2d", "op": "scan2d", **ops}, **{"in": scan2d_in})
    add({"name": "control_no_carry", "op": "scan2d", "control": "no_carry", **ops}, **{"in": scan2d_in})
    add({"name": "scan1d", "op": "scan1d", **ops}, **{"in": _scan1d_inputs()})
    raster = _raster_inputs()
    add({"name": "raster", "op": "raster", "h": GRID_H, "w": GRID_W, **ops}, **{"in": raster})
    add({"name": "raster_rowmajor", "op": "raster", "rowmajor": True, "w": 8, **ops}, **{"in": raster})
    for name in (*MAMBA2D, *MAMBAMIL):
        cfg, batch, _, _, _, state = inits(name)
        w = {k: v.numpy() for k, v in _to_port(cfg, state.params).items()}
        add({"name": name, "kind": "generic_step", "cfg": cfg, "dp": 2, "sp": 2, "spe": SPE, "dropout": False},
            w=w, batch=batch)
        if name in MAMBA2D:
            add({"name": f"eval_{name}", "kind": "forward", "cfg": cfg, "dp": 1, "sp": WORLD}, w=w, batch=batch)
    arrays["spec"] = np.asarray(json.dumps(specs))
    np.savez(tmp / "in.npz", **arrays)
    _torchrun(WORLD, [WORKER, str(tmp / "in.npz"), str(tmp / "out.npz")])
    out = np.load(tmp / "out.npz")
    results = {}
    for k in out.files:
        case, rest = k.split("/", 1)
        results.setdefault(case, {})[rest] = out[k]
    return inputs, results


# ---- the scans and the rasterization on sp 4 against JAX's single-device functions ----------


def _check_scan2d(res, d):
    """The gathered bands' y (and K5's op's) against JAX's separable scan on
    the whole grid, and the gradients of Σ y·cot."""
    fn = jax.jit(jscan.selective_scan_2d)
    names = ("x", "delta", "A", "B", "C", "D")
    want, vjp = jax.vjp(fn, *(jnp.asarray(d[k]) for k in names))
    scale = float(jnp.abs(want).max())
    _close(res["out/y"], want, rtol=1e-5, atol=1e-5 * scale, msg="y")
    _close(res["out/y_fused"], want, rtol=1e-5, atol=1e-5 * scale, msg="y of K5's op")
    for k, g in zip(names, vjp(jnp.asarray(d["cot"]))):
        _grad_close(res[f"grad/{k}"], g, f"d {k}")


def test_scan2d_bands_carry_each_columns_state(world):
    """The plain 2D scan over 4 uneven bands of a 7-row grid (2, 2, 2, 1
    rows), each band's vertical state folded from the bands above, equals
    JAX's ``selective_scan_2d`` on the whole grid, and so does K5's
    ``scan2d_carry`` op (its plain version here); the gradients for x, Δ,
    B, C (gathered) and A, D (summed over the row) equal JAX's VJP and the
    port's one-process autograd."""
    inputs, results = world
    d, res = inputs["scan2d"]["in"], results["scan2d"]
    _check_scan2d(res, d)
    from mhim_mil_torch.ops.scan import selective_scan_2d

    leaves = {k: torch.from_numpy(d[k]).requires_grad_() for k in ("x", "delta", "A", "B", "C", "D")}
    (selective_scan_2d(*leaves.values()) * torch.from_numpy(d["cot"])).sum().backward()
    for k, t in leaves.items():
        _grad_close(res[f"grad/{k}"], t.grad, f"d {k} against one process")


def test_control_bands_without_the_carry_miss_jax(world):
    """The test sees the carry: the same bands, each scanned from zero (no
    state handed down), miss JAX's whole-grid scan."""
    inputs, results = world
    with pytest.raises(AssertionError):
        _check_scan2d(results["control_no_carry"], inputs["control_no_carry"]["in"])


def test_scan1d_blocks_carry_the_state_both_ways(world):
    """The masked 1D scan over 4 blocks of 50 steps (13, 13, 12, 12) on 3
    ragged bags (50, 26 and 30 valid: bag 1's last two blocks and bag 2's
    last hold only padding, which passes the state on), in rank order and
    reversed (the flipped blocks, the carry from the last rank to the
    first), against JAX's ``selective_scan_1d`` on the whole sequence and
    on the flipped one; the gradients against JAX's VJP."""
    inputs, results = world
    d, res = inputs["scan1d"]["in"], results["scan1d"]
    names = ("x", "delta", "A", "B", "C", "D")
    for sfx, flip in (("", False), ("_rev", True)):
        @jax.jit
        def fn(x, delta, A, B, C, D, flip=flip):
            f = (lambda t: jnp.flip(t, 1)) if flip else (lambda t: t)
            y = jscan.selective_scan_1d(f(x), f(delta), A, f(B), f(C), D, jnp.asarray(f(d["mask"])))
            return f(y)

        want, vjp = jax.vjp(fn, *(jnp.asarray(d[k]) for k in names))
        _close(res[f"out/y{sfx}"], want, rtol=1e-5, atol=1e-5 * float(jnp.abs(want).max()), msg=f"y{sfx}")
        for k, g in zip(names, vjp(jnp.asarray(d["cot"]))):
            _grad_close(res[f"grad/{k}{sfx}"], g, f"d {k}{sfx}")


@pytest.mark.parametrize("case", ["raster", "raster_rowmajor"])
def test_rasterize_bands_match_jax(world, case):
    """``rasterize_band`` over 4 ranks, the bands gathered, against JAX's
    ``rasterize_grid`` on the whole bag: on the 9 × 7 grid with
    coordinates (bands of 3, 2, 2, 2 rows), bit for bit but at the cell
    that two valid instances from ranks 0 and 3 clip to, which holds one
    of them whole, never their sum; and on the row-major grid 8 wide of
    the bag's global indices (8 rows), bit for bit."""
    inputs, results = world
    d, res = inputs[case]["in"], results[case]
    n = d["feats"].shape[1]
    if case == "raster":
        h, w, coords = GRID_H, GRID_W, d["coords"]
    else:
        h, w = -(-n // 8), 8
        coords = np.broadcast_to(np.asarray(jmamba._rowmajor_coords(n, w)), d["coords"].shape)
    grid, gmask = jmamba.rasterize_grid(jnp.asarray(d["feats"]), jnp.asarray(coords), jnp.asarray(d["mask"]), h, w,
                                        jnp.asarray(d["pad"]))
    grid, gmask = np.asarray(grid), np.asarray(gmask)
    np.testing.assert_array_equal(res["out/mask"], gmask)
    got = res["out/grid"]
    if case == "raster":
        col, row = coords[0, COLLIDE[0]]
        cell = got[0, row, col]
        assert any(np.array_equal(cell, d["feats"][0, i]) for i in COLLIDE), cell
        assert not np.allclose(cell, d["feats"][0, COLLIDE[0]] + d["feats"][0, COLLIDE[1]])
        got, grid = got.copy(), grid.copy()
        got[0, row, col] = grid[0, row, col] = 0.0
    np.testing.assert_array_equal(got, grid)


# ---- 2dmamba's evaluation and the steps against JAX's single-device ones ----------------------


@pytest.mark.parametrize("name", list(MAMBA2D))
def test_2dmamba_sp_eval_matches_jax(world, inits, name):
    """2dmamba's evaluation forward at sp 4 (K5's op with the carry on each
    band, its plain version here), the logits and the attention over the
    whole grid gathered, against JAX's forward on one device: with ``pos``
    on the 9 × 7 grid (bands of 3, 2, 2, 2 rows) and on the row-major 8 × 8
    grid (2 rows a band)."""
    _, results = world
    cfg, batch, _, jm, _, state = inits(name)
    args = [jnp.asarray(batch[k]) for k in ("feats", "mask")] + ([jnp.asarray(batch["pos"])] if "pos" in batch
                                                                   else [])
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, training=False, return_attn=True))(state.params, *args)
    res = results[f"eval_{name}"]
    for k in ("logits", "attn"):
        _close(res[k], want[k], rtol=1e-4, atol=1e-5 * float(jnp.abs(want[k]).max()), msg=k)


@pytest.mark.parametrize("name", [*MAMBA2D, *MAMBAMIL])
def test_scan_families_sp_step_matches_jax(world, inits, monkeypatch, name):
    """The generic train step at dp 2 × sp 2 (each rank 4 bags' halves of
    the instances, the last bag a padding bag) against JAX's single-device
    step: 2dmamba with ``pos`` and on the row-major grid (the plain 2D
    scan carried across bands under autograd), and mambamil's simple,
    srmamba (rate 4: the tokens moved to the permuted blocks and back) and
    bimamba (the reverse scan) variants. Loss rtol 1e-5, the gradients
    within GRAD_TOL of max|g|, the parameters after the update by
    ``_check_params``."""
    _, results = world
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg, batch, jcfg, jm, family, state = inits(name)
    s2, m = j_make_train_step(jcfg, jm, family, SPE, donate=False)(state, {k: jnp.asarray(v)
                                                                          for k, v in batch.items()})
    res = results[name]
    _close(res["m/loss"], float(m["loss"]), rtol=1e-5, atol=0, msg="loss")
    moments = [x for x in jax.tree.leaves(s2.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu")]
    mu = {k: v.numpy() for k, v in _to_port(cfg, moments[0].mu).items()}
    want = _to_port(cfg, s2.params)
    assert set(want) == set(mu) == set(_group(res, "g"))
    top = max(np.abs(g).max() for g in mu.values())
    for k, v in want.items():
        scale = np.abs(mu[k]).max() if np.abs(mu[k]).max() > GRAD_TOL * top else top
        _close(res[f"g/{k}"], mu[k], rtol=0, atol=GRAD_TOL * scale, msg=f"gradient {k}")
        _check_params(k, res[f"s/{k}"], v.numpy(), mu[k], jcfg.lr, rtol=1e-4, atol=1e-6, scale=scale)


def test_carry_op_passes_opcheck():
    """``torch.ops.mhim_mil_torch.scan2d_carry`` passes ``opcheck`` on the
    CPU (schema, fake, autograd registration) with and without ``h0``, and
    a grid cut into two bands, the second started from the first's
    ``h_last``, equals the whole grid's scan."""
    d = _scan_inputs(3, (2, 5, 6, 8), 4)
    t = {k: torch.from_numpy(d[k]) for k in ("x", "delta", "B", "C", "D")}
    a_log = torch.log(-torch.from_numpy(d["A"]))
    args = (t["x"], t["delta"], a_log, t["B"], t["C"], t["D"])
    y, last = torch.ops.mhim_mil_torch.scan2d_carry(*args, None)
    top = [v[:, :2] if v.dim() == 4 else v for v in args]
    bottom = [v[:, 2:] if v.dim() == 4 else v for v in args]
    y0, h0 = scan2d.scan2d_carry(*top)
    y1, h1 = scan2d.scan2d_carry(*bottom, h0)
    torch.testing.assert_close(torch.cat([y0, y1], 1), y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h1, last, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y, scan2d.scan2d_plain(*args), rtol=0, atol=0)
    for h in (None, h0):
        torch.library.opcheck(torch.ops.mhim_mil_torch.scan2d_carry, (*bottom, h))


# ---- the driver through its command line ------------------------------------------------


def test_driver_sp_2dmamba_matches_one_process(tmp_path):
    """``torch.distributed.run --nproc_per_node 4`` with ``--mesh_dp 2
    --mesh_sp 2``: 2 folds × 2 epochs of 2dmamba on a synthetic survival
    set (the row-major 8 × 8 grid of 64-instance bags, 4 rows a band): the
    test rows' c-index within 1e-6 of the one-process run, the same files,
    rank 0 alone printed and wrote."""
    from mhim_mil_torch.main import main

    argv = ["-c", "config/feat_surv.yaml", "--datasets", "surv_synth", "--model", "2dmamba", "--mambamil_dim", "32",
            "--mambamil_state_dim", "4", "--input_dim", "32", "--synth_n_slides", "16", "--synth_bag_size", "64",
            "--bucket_sizes", "64", "--batch_size", "4", "--cv_fold", "2", "--num_epoch", "2", "--max_epoch", "2",
            "--lr", "1e-3", "--lr_sche", "const", "--num_bootstrap", "5", "--compute_dtype", "float32",
            "--title", "sp"]
    out_sp, out_one = tmp_path / "sp", tmp_path / "one"
    res = _torchrun(WORLD, ["-m", "mhim_mil_torch.main", "--device", "cpu", *argv, "--mesh_dp", "2", "--mesh_sp", "2",
                            "--output_path", str(out_sp)])
    one = main(["--device", "cpu", *argv, "--output_path", str(out_one)])
    with open(out_sp / "sp_results.json") as f:
        sp = json.load(f)
    assert len(sp["folds"]) == len(one["folds"]) == 2
    for f_sp, f_one in zip(sp["folds"], one["folds"]):
        for row in ("test", "test_ema"):
            if row in f_one:
                assert np.isfinite(f_one[row]["cindex"]), row
                np.testing.assert_allclose(f_sp[row]["cindex"], f_one[row]["cindex"], atol=1e-6, err_msg=row)
    assert sorted(os.listdir(out_sp)) == sorted(os.listdir(out_one))
    lines = res.stdout.splitlines()
    for rank in (1, 2, 3):
        said = [line for line in lines if re.match(rf"\[\w*{rank}\]:", line)]
        assert not [line for line in said if "fold" in line or "results written" in line], said
    assert any(re.match(r"\[\w*0\]:.*results written", line) for line in lines)
