"""The port's sequence parallelism over instances (``mesh_sp > 1``,
``mhim_mil_torch/parallel``) against the JAX package's single-device
functions, on the CPU.

The port's sp world is one launch of 4 gloo processes
(``tests/torch_dp_worker.py``) that runs every case in turn on its own mesh:
the ops at ``dp=1, sp=4`` on JAX's streamed case (``tests/test_parallel.py:
205``: B 2, N 4,096, H 2, dh 8, M 16, one bag ragged at 3,000) and on an
uneven bag of 1,002 tokens (1,001 + cls) whose landmark groups and PPEG
rows cross the block edges; the steps and the evaluation at ``dp=2,
sp=2``. JAX's side runs in this process on one device, which JAX's own
tests hold equal to its ``(dp, sp)`` mesh. Both sides start from the same
weights and take the same uniform draws (fed to JAX's
``random_subset_mask``; dropout patched to the identity on both sides).

Tolerances are the dp row's of ``PERF.md`` §2: the MHIM step's loss rtol
2e-5 and ``keep_num`` rtol 1e-6, the gradients (Adam's first moments)
within 1e-5 of each tensor's max|g|, every parameter and the teacher rtol
1e-4 / atol 1e-6 (2·lr where the gradient is within its tolerance of 0);
abmil's loss rtol 1e-5; AUC and accuracy 1e-6; the streamed Nystrom at
``tests/test_parallel.py:205``'s atol (1e-6 out, 1e-8 attn) against JAX's
and the port's one process. Each subprocess runs under a 240 s timeout.
"""

import json
import os
import re
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.models.merge as jmerge_mod
import mhim_mil_tpu.ops.masking as jmasking_mod
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.train_state import MILTrainState, make_optimizer as j_make_optimizer
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.mhim import MHIM as JMHIM, make_mhim_train_step as j_make_mhim_step
from mhim_mil_tpu.models.positional import PPEG as JPPEG
from mhim_mil_tpu.ops import masked as jmasked
from mhim_mil_tpu.ops import nystrom as jnys
from mhim_mil_tpu.utils import schedules as jsched
from mhim_mil_tpu.utils.torch_import import import_merge, import_mhim_attn, import_mhim_selfattn
from mhim_mil_torch.config import load_config
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.models.transformer import _DepthwiseResConv
from mhim_mil_torch.ops.flash_nystrom import flash_nystrom
from mhim_mil_torch.ops.nystrom import nystrom_attention, nystrom_attention_streamed
from mhim_mil_torch.parallel import make_mesh, shard_batch
from mhim_mil_torch.parallel import mesh as pmesh
from mhim_mil_torch.utils import weights
from mhim_mil_torch.utils.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
WORLD = 4
TIMEOUT_S = 240
SPE = 4
GRAD_TOL = 1e-5  # × max|g| of each tensor

# tests/test_parallel.py:97-148 (dp 2 x sp 2 here)
MHIM_CFG = dict(model="mhim", input_dim=32, inner_dim=64, n_heads=4, batch_size=8, num_epoch=2, lr=1e-3,
                lr_sche="const", mask_ratio=0.5, mask_ratio_h=0.1, mask_ratio_hr=0.5, merge_enable=True,
                merge_ratio=0.25, merge_k=2, aux_alpha=0.5, attn2score=True, dropout=0.0,
                compute_dtype="float32")
# tests/test_parallel.py:237-294: 4,096-token bags, the streamed path on (dp 2 x sp 2 here)
LONG_CFG = dict(model="mhim", baseline="selfattn", input_dim=16, inner_dim=64, batch_size=4, num_epoch=2, lr=1e-3,
                lr_sche="const", mask_ratio=0.5, mask_ratio_h=0.05, mask_ratio_hr=0.5, merge_enable=True,
                merge_ratio=0.2, aux_alpha=0.5, attn2score=True, dropout=0.0, compute_dtype="float32")
# tests/test_parallel.py:18-55 and :151-184, in fp32
GENERIC_CFG = dict(input_dim=32, inner_dim=32, n_classes=2, batch_size=8, dropout=0.0, lr_sche="const",
                   num_epoch=1, compute_dtype="float32")
EVAL_CFG = dict(model="abmil", input_dim=32, inner_dim=32, batch_size=4, num_epoch=1, lr=1e-3, lr_sche="const",
                bucket_sizes=[64], compute_dtype="float32", num_bootstrap=5)
EVAL_SLIDES = dict(n_slides=12, bag_size=64, feat_dim=32, seed=3)
STREAMED = dict(b=2, n=4096, h=2, dh=8, m=16, lengths=(4096, 3000), chunk=512)  # tests/test_parallel.py:205
UNEVEN = dict(b=2, n=1002, h=4, dh=8, m=16, lengths=(1002, 777))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _close(got, want, rtol, atol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=msg)


def _grad_close(got, want, msg=""):
    want = np.asarray(want, np.float32)
    _close(got, want, rtol=0, atol=GRAD_TOL * max(np.abs(want).max(), 1e-30), msg=msg)


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "JAX_PLATFORMS": "cpu"}


def _torchrun(nproc: int, args) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           "--tee", "3", *args]
    res = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, f"{' '.join(cmd)} failed:\n{res.stdout[-4000:]}\n{res.stderr[-6000:]}"
    return res


def _group(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items() if k.startswith(prefix + "/")}


# ---- inputs ---------------------------------------------------------------------------


def _ragged(lengths, n):
    return np.arange(n)[None] < np.asarray(lengths)[:, None]


def _attention_inputs(case, layout):
    """q, k, v (q pre-scaled) in ``layout`` (``bnhd`` or ``bhnd``), the mask
    and the cotangents of out and the cls row, from a numpy seed."""
    rng = np.random.default_rng(0)
    b, n, h, dh = case["b"], case["n"], case["h"], case["dh"]
    q, k, v = (rng.normal(size=(b, n, h, dh)).astype(np.float32) for _ in range(3))
    q *= dh ** -0.5
    d = {"mask": _ragged(case["lengths"], n), "cot_attn": rng.normal(size=(b, h, n)).astype(np.float32)}
    if layout == "bnhd":
        d.update(q=q, k=k, v=v, cot_out=rng.normal(size=(b, n, h * dh)).astype(np.float32))
    else:
        d.update({name: t.transpose(0, 2, 1, 3).copy() for name, t in (("q", q), ("k", k), ("v", v))})
        d["cot_out"] = rng.normal(size=(b, h, n, dh)).astype(np.float32)
    return d


def _landmark_inputs():
    rng = np.random.default_rng(1)
    b, n, h, dh, m = UNEVEN["b"], UNEVEN["n"], UNEVEN["h"], UNEVEN["dh"], UNEVEN["m"]
    mask = _ragged(UNEVEN["lengths"], n)
    t = np.where(mask[:, None, :, None], rng.normal(size=(b, h, n, dh)), 0.0).astype(np.float32)
    return {"t": t, "mask": mask, "cot": rng.normal(size=(b, h, m, dh)).astype(np.float32)}


def _resconv_inputs():
    rng = np.random.default_rng(2)
    b, n, h, dh = 2, UNEVEN["n"], 4, 8
    mask = _ragged(UNEVEN["lengths"], n)
    v = np.where(mask[..., None, None], rng.normal(size=(b, n, h, dh)), 0.0).astype(np.float32)
    w = rng.normal(size=(h, 1, 33, 1)).astype(np.float32) * 0.2
    return {"v": v, "mask": mask, "cot": rng.normal(size=(b, n, h * dh)).astype(np.float32), "w.weight": w}


def _ppeg():
    """JAX's PPEG at width 16 on a bag of 1,001 instances (hw 32: the
    blocks 251/250/250/250 end mid-row), its params and the port's state."""
    rng = np.random.default_rng(3)
    b, n, c = 2, UNEVEN["n"] - 1, 16
    mask = _ragged((n, 640), n)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    jm = JPPEG(c)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))
    sd = {}
    weights.ppeg_state(sd, "", jax.tree.map(np.asarray, variables["params"]))
    d = {"x": x, "mask": mask, "cot": rng.normal(size=(b, n, c)).astype(np.float32)}
    d.update({f"w.{k}": np.asarray(v) for k, v in sd.items()})
    return jm, variables, d


def _mhim_batch(b=8, n=64, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(40, n + 1, (b,))
    lengths[-1] = 0  # a padding bag
    return {"feats": np.where((np.arange(n)[None] < lengths[:, None])[..., None],
                              rng.normal(size=(b, n, dim)), 0.0).astype(np.float32),
            "mask": np.arange(n)[None] < lengths[:, None],
            "bag_valid": lengths > 0,
            "target": rng.integers(0, 2, size=(b,)).astype(np.int32)}


def _long_batch():
    rng = np.random.default_rng(1)
    b, n = 4, 4096
    return {"feats": np.asarray(rng.normal(size=(b, n, 16)), np.float32),
            "mask": np.asarray(np.arange(n)[None] < np.array([n, n, 3500, n])[:, None]),
            "bag_valid": np.ones((b,), bool),
            "target": np.asarray(rng.integers(0, 2, size=(b,)), np.int32)}


def _draws(model, batch):
    rng = np.random.default_rng(1)
    b, n = batch["mask"].shape
    d = {f"mask{i}": rng.random((b, n), dtype=np.float32) for i, s in enumerate(model.sched.stages(False)) if s}
    d["merge"] = rng.random((b, model.static_survivors(n)), dtype=np.float32)
    return d


def _port_mhim(cfg_kw):
    cfg = load_config([], **cfg_kw)
    model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return cfg, model


def _generic_batch():
    rng = np.random.default_rng(0)
    b, n = 8, 64
    return {"feats": np.asarray(rng.normal(size=(b, n, 32)), np.float32), "mask": np.ones((b, n), bool),
            "bag_valid": np.ones((b,), bool), "target": np.asarray(rng.integers(0, 2, size=(b,)), np.int32)}


def _generic_jax():
    from mhim_mil_tpu.engine.train_state import create_train_state as j_create_train_state

    jcfg = j_load_config([], model="abmil", **GENERIC_CFG)
    jm, family = j_build_model(jcfg)
    batch = _generic_batch()
    sample = {k: jnp.asarray(v) for k, v in batch.items()}
    state = j_create_train_state(jcfg, jm, jax.random.PRNGKey(0), sample, jsched.make_lr_schedule(jcfg, SPE))
    return jcfg, jm, family, state, batch


def _eval_state():
    from mhim_mil_tpu.data import batch_bags, make_synthetic_dataset
    from mhim_mil_tpu.engine.train_state import create_train_state as j_create_train_state

    jcfg = j_load_config([], **{**EVAL_CFG, "bucket_sizes": tuple(EVAL_CFG["bucket_sizes"])})
    slides = make_synthetic_dataset(**EVAL_SLIDES)
    jm, family = j_build_model(jcfg)
    sample = {k: jnp.asarray(v) for k, v in next(iter(batch_bags(slides, 4, (64,)))).items()}
    state = j_create_train_state(jcfg, jm, jax.random.PRNGKey(0), sample, jsched.make_lr_schedule(jcfg, 1))
    return jcfg, jm, family, state, slides


def _np_params(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One gloo world of WORLD ranks running every case; returns the cases'
    inputs and rank 0's results, by case."""
    tmp = tmp_path_factory.mktemp("sp")
    specs, arrays, inputs = [], {}, {}

    def add(spec, **groups):
        specs.append(spec)
        inputs[spec["name"]] = groups
        for g, d in groups.items():
            for k, v in d.items():
                arrays[f"{spec['name']}/{g}/{k}"] = np.asarray(v)

    ops = dict(kind="ops", dp=1, sp=WORLD)
    add({"name": "landmark", "op": "landmark", "m": UNEVEN["m"], **ops}, **{"in": _landmark_inputs()})
    add({"name": "streamed", "op": "streamed", "m": STREAMED["m"], "chunk": STREAMED["chunk"], **ops},
        **{"in": _attention_inputs(STREAMED, "bnhd")})
    for op in ("kernels", "materialising"):
        add({"name": op, "op": op, "m": UNEVEN["m"], **ops}, **{"in": _attention_inputs(UNEVEN, "bhnd")})
    add({"name": "resconv", "op": "resconv", **ops}, **{"in": _resconv_inputs()})
    add({"name": "ppeg", "op": "ppeg", **ops}, **{"in": _ppeg()[2]})

    batch = _mhim_batch()
    for baseline in ("selfattn", "attn"):
        cfg_kw = {**MHIM_CFG, "baseline": baseline}
        _, model = _port_mhim(cfg_kw)
        w = {k: v.numpy() for k, v in model.state_dict().items()}
        common = dict(kind="mhim_step", cfg=cfg_kw, dp=2, sp=2, spe=SPE, dropout=False)
        draws = _draws(model, batch)
        add({"name": f"mhim_{baseline}", **common}, w=w, batch=batch, draw=draws)
        if baseline == "selfattn":
            for control in ("k1_unmerged", "loss_every_rank"):
                add({"name": f"control_{control}", **common, "control": control}, w=w, batch=batch, draw=draws)
            add({"name": "forward_test", "kind": "forward_test", "cfg": cfg_kw, "dp": 2, "sp": 2}, w=w, batch=batch)
    pure_kw = {**MHIM_CFG, "model": "mhim_pure", "baseline": "selfattn"}
    _, model_p = _port_mhim(pure_kw)
    add({"name": "mhim_pure_selfattn", "kind": "mhim_step", "cfg": pure_kw, "dp": 2, "sp": 2, "spe": SPE,
         "dropout": False}, w={k: v.numpy() for k, v in model_p.state_dict().items()}, batch=batch)
    _, model_l = _port_mhim(LONG_CFG)
    long_batch = _long_batch()
    add({"name": "mhim_long", "kind": "mhim_step", "cfg": LONG_CFG, "dp": 2, "sp": 2, "spe": SPE, "dropout": False},
        w={k: v.numpy() for k, v in model_l.state_dict().items()}, batch=long_batch, draw=_draws(model_l, long_batch))
    _, _, _, jstate, gbatch = _generic_jax()
    gw = weights.abmil_state_from_flax(_np_params(jstate.params))
    add({"name": "abmil", "kind": "generic_step", "cfg": {"model": "abmil", **GENERIC_CFG}, "dp": 2, "sp": 2,
         "spe": SPE, "dropout": False}, w={k: v.numpy() for k, v in gw.items()}, batch=gbatch)
    _, _, _, estate, _ = _eval_state()
    ew = weights.abmil_state_from_flax(_np_params(estate.params))
    add({"name": "eval", "kind": "eval", "cfg": EVAL_CFG, "dp": 2, "sp": 2, "slides": EVAL_SLIDES},
        w={k: v.numpy() for k, v in ew.items()})
    base = ["--device", "cpu", "--datasets", "synth", "--input_dim", "32", "--inner_dim", "32", "--batch_size", "4",
            "--num_epoch", "1", "--cv_fold", "2", "--synth_n_slides", "8", "--synth_bag_size", "64",
            "--bucket_sizes", "64"]
    for name, argv in (("raise_no_flags", ["--model", "dtfd"]),
                       ("raise_batch_split", ["--model", "rrtmil", "--mesh_dp", "2", "--mesh_sp", "2", "--batch_size",
                                              "3"])):
        add({"name": name, "kind": "raises", "argv": [*base, *argv]})
    arrays["spec"] = np.asarray(json.dumps(specs))
    np.savez(tmp / "in.npz", **arrays)
    _torchrun(WORLD, [WORKER, str(tmp / "in.npz"), str(tmp / "out.npz")])
    out = np.load(tmp / "out.npz")
    results = {}
    for k in out.files:
        case, rest = k.split("/", 1)
        results.setdefault(case, {})[rest] = out[k]
    return inputs, results


# ---- the mesh's sp layout, in this process -------------------------------------------------


def test_sincos_block_takes_the_whole_bags_grid():
    """SINCOS on a block (no collective: the grid position is the block's
    offset plus its index) equals the whole bag's embedding there."""
    from mhim_mil_torch.models.positional import SINCOS

    x, mask = torch.randn(2, 1001, 16), torch.from_numpy(_ragged((1001, 640), 1001))
    whole = SINCOS(16)(x, mask)
    for r in range(4):
        seq = pmesh.Seq(pmesh.instance_blocks(1001, 4), r)
        torch.testing.assert_close(SINCOS(16)(x[:, seq.cols], mask[:, seq.cols], seq=seq), whole[:, seq.cols],
                                   rtol=0, atol=0)


def test_instance_blocks_and_seq_layouts():
    """Blocks of ``N // sp`` or one more, never padded; a Seq's derived
    layouts put the cls token on rank 0 and Merge's tokens on the last."""
    assert pmesh.instance_blocks(1001, 4) == (251, 250, 250, 250)
    assert pmesh.instance_blocks(10240, 2) == (5120, 5120)
    mesh = make_mesh(dp=2, sp=2, world=4, rank=3)
    assert (mesh.index, mesh.sp_index, mesh.instances(1001)) == (1, 1, slice(501, 1001))
    seq = pmesh.Seq((251, 250, 250, 250), 2)
    assert (seq.total, seq.offset, seq.local, seq.cols, seq.first) == (1001, 501, 250, slice(501, 751), False)
    assert seq.prepend(1).counts == (252, 250, 250, 250) and seq.append(2).counts == (251, 250, 250, 252)
    assert pmesh.Seq((3, 2), 0).first and not pmesh.Seq((0, 5), 0).first


# ---- each op on sp 4 against JAX's single-device function -----------------------------------


def test_landmark_mean_blocks_match_jax(world):
    """``_landmark_mean`` on 4 blocks of 1,002 tokens (groups of 63 that
    cross every block edge) against JAX's on the whole bag: the means and
    lm_mask, and the gradient of Σ means·cot for each token."""
    inputs, results = world
    d, res = inputs["landmark"]["in"], results["landmark"]
    fn = lambda t: jnys._landmark_mean(t, jnp.asarray(d["mask"]), UNEVEN["m"])  # noqa: E731
    (means, lm_mask), vjp = jax.vjp(fn, jnp.asarray(d["t"]))
    _close(res["out/means"], means, rtol=1e-5, atol=1e-6, msg="means")
    np.testing.assert_array_equal(res["out/lm_mask"], np.asarray(lm_mask))
    (want,) = vjp((jnp.asarray(d["cot"]), np.zeros(lm_mask.shape, jax.dtypes.float0)))
    _grad_close(res["grad/t"], want, "d t")


def _port_attention(op, d, m, chunk=None):
    """The port's op in one process: out, the cls row and the gradients of
    Σ out·cot_out + Σ attn·cot_attn."""
    leaves = {k: torch.from_numpy(d[k]).requires_grad_() for k in ("q", "k", "v")}
    mask = torch.from_numpy(d["mask"])
    if op == "streamed":
        out, attn = nystrom_attention_streamed(*leaves.values(), mask, m, return_attn=True, chunk=chunk)
    elif op == "kernels":
        out, attn = flash_nystrom(*leaves.values(), mask, m)
    else:
        out, attn = nystrom_attention(*leaves.values(), mask, m, return_attn=True)
    ((out * torch.from_numpy(d["cot_out"])).sum() + (attn * torch.from_numpy(d["cot_attn"])).sum()).backward()
    return out.detach(), attn.detach(), {k: t.grad for k, t in leaves.items()}


def test_streamed_nystrom_blocks_match_one_process(world):
    """JAX's ``tests/test_parallel.py:205`` case on 4 blocks of 1,024: the
    streamed op (windows of 512, the second bag ragged at 3,000) against
    JAX's ``nystrom_attention_streamed`` on the whole bags at that test's
    atol (out 1e-6, attn 1e-8), the gradients for q, k and v within 1e-5
    of max|g|; and against the port's one-process op at the same atol."""
    inputs, results = world
    d, res = inputs["streamed"]["in"], results["streamed"]
    mask = jnp.asarray(d["mask"])
    fn = jax.jit(lambda q, k, v: jnys.nystrom_attention_streamed(q, k, v, mask, STREAMED["m"], return_attn=True,
                                                                 chunk=STREAMED["chunk"]))
    (out, attn), vjp = jax.vjp(fn, *(jnp.asarray(d[k]) for k in ("q", "k", "v")))
    _close(res["out/out"], out, rtol=0, atol=1e-6, msg="out")
    _close(res["out/attn"], attn, rtol=0, atol=1e-8, msg="attn")
    for name, want in zip("qkv", vjp((jnp.asarray(d["cot_out"]), jnp.asarray(d["cot_attn"])))):
        _grad_close(res[f"grad/{name}"], want, f"d {name}")
    one, one_attn, grads = _port_attention("streamed", d, STREAMED["m"], STREAMED["chunk"])
    _close(res["out/out"], one, rtol=0, atol=1e-6, msg="out against one process")
    _close(res["out/attn"], one_attn, rtol=0, atol=1e-8, msg="attn against one process")
    for k, g in grads.items():
        _grad_close(res[f"grad/{k}"], g, f"d {k} against one process")


@pytest.mark.parametrize("op", ["kernels", "materialising"])
def test_kernel_wrappers_blocks_match_jax(world, op):
    """K3's composition (the plain versions of K1, K2, K3p, K1b and K2b),
    and the materialising op that ``use_flash_attn=False`` runs below 4,096
    tokens, on 4 uneven blocks of 1,002 tokens against JAX's
    ``nystrom_attention`` on the whole bags: out and the cls row (rtol
    1e-4, atol 1e-5·max|ref|), and the gradients for q, k and v within 1e-5
    of max|g|; and against the port's one process, out within
    1e-6·max|ref|."""
    inputs, results = world
    d, res = inputs[op]["in"], results[op]
    mask = jnp.asarray(d["mask"])
    fn = jax.jit(lambda q, k, v: jnys.nystrom_attention(q, k, v, mask, UNEVEN["m"], return_attn=True))
    (out, attn), vjp = jax.vjp(fn, *(jnp.asarray(d[k]) for k in ("q", "k", "v")))
    for name, want in (("out", out), ("attn", attn)):
        _close(res[f"out/{name}"], want, rtol=1e-4, atol=1e-5 * float(jnp.abs(want).max()), msg=name)
    for name, want in zip("qkv", vjp((jnp.asarray(d["cot_out"]), jnp.asarray(d["cot_attn"])))):
        _grad_close(res[f"grad/{name}"], want, f"d {name}")
    one, _, _ = _port_attention(op, d, UNEVEN["m"])
    _close(res["out/out"], one, rtol=0, atol=1e-6 * float(one.abs().max()), msg="out against one process")


def _jax_resconv(d):
    """JAX's ``_DepthwiseResConv`` on the whole bags of ``d``: a function of
    its params and ``v [B, N, H·dh]``, its params (the port's weight
    ``[H, 1, 33, 1]`` as JAX's kernel ``[33, 1, 1, H]``) and ``v``."""
    from mhim_mil_tpu.models.transformer import _DepthwiseResConv as JResConv

    b, n, h, dh = d["v"].shape
    jm = JResConv(h, dh)
    params = {"kernel": jnp.asarray(d["w.weight"].transpose(2, 3, 1, 0))}
    return lambda p, v: jm.apply({"params": p}, v), params, jnp.asarray(d["v"].reshape(b, n, h * dh))


@pytest.mark.parametrize("op", ["resconv", "ppeg"])
def test_convolution_halos_match(world, op):
    """The two convolutions along the sequence on 4 blocks, against JAX's
    layers on the whole bags: Nystrom's 33-tap value residual (a 16-token
    halo each side; also against the port's one-process layer) and PPEG on
    the 32 × 32 grid of 1,001 instances (blocks ending mid-row, a halo of
    whole rows); the outputs, the input gradients and the weights'
    gradients summed over the row."""
    inputs, results = world
    d, res = inputs[op]["in"], results[op]
    if op == "resconv":
        fn, params, v = _jax_resconv(d)
        want_out, vjp = jax.vjp(fn, params, v)
        d_params, want_dx = vjp(jnp.asarray(d["cot"]))
        want_dx = np.asarray(want_dx).reshape(d["v"].shape)
        want_p = {"weight": np.asarray(d_params["kernel"]).transpose(3, 2, 0, 1)}
        layer = _DepthwiseResConv(d["v"].shape[2])
        layer.load_state_dict({"weight": torch.from_numpy(d["w.weight"])})
        x = torch.from_numpy(d["v"]).requires_grad_()
        out = layer(x)
        (out * torch.from_numpy(d["cot"])).sum().backward()
        _close(res["out/out"], out.detach(), rtol=1e-5, atol=1e-5, msg="out against one process")
        _grad_close(res["grad/v"], x.grad, "d v against one process")
        _grad_close(res["pgrad/weight"], layer.weight.grad, "d weight against one process")
    else:
        jm, variables, _ = _ppeg()
        fn = lambda p, x: jm.apply({"params": p}, x, jnp.asarray(d["mask"]))  # noqa: E731
        want_out, vjp = jax.vjp(fn, variables["params"], jnp.asarray(d["x"]))
        d_params, want_dx = vjp(jnp.asarray(d["cot"]))
        want_p = {}
        weights.ppeg_state(want_p, "", jax.tree.map(np.asarray, d_params))
    _close(res["out/out"], want_out, rtol=1e-5, atol=1e-5, msg="out")
    _grad_close(res[f"grad/{'v' if op == 'resconv' else 'x'}"], want_dx, "d input")
    assert set(_group(res, "pgrad")) == set(want_p)
    for k, g in want_p.items():
        _grad_close(res[f"pgrad/{k}"], g, f"d {k}")


# ---- the steps at dp 2 x sp 2 against JAX's single-device step ----------------------------------


def _jax_mhim_step(monkeypatch, cfg_kw, port_model, batch, draws):
    """JAX's MHIM train step on one device from the port model's weights,
    fed ``draws`` in place of its uniform draws, dropout off."""
    sd = {k: v.detach().numpy() for k, v in port_model.state_dict().items()}
    params = (import_mhim_selfattn if cfg_kw["baseline"] == "selfattn" else import_mhim_attn)(sd)
    model_state = {}
    if any(k.startswith("merge.") for k in sd):
        params["merge"], mb = import_merge(sd)
        model_state = {"buffers": {"merge": mb}}
    jcfg = j_load_config([], **cfg_kw)
    jmodel, _ = j_build_model(jcfg)
    tx = j_make_optimizer(jcfg, jsched.make_lr_schedule(jcfg, SPE))
    state = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=model_state,
                          teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                          rng=jax.random.PRNGKey(0), tx=tx, apply_fn=jmodel.apply)
    order = iter([draws[k] for k in sorted(draws) if k.startswith("mask")] + [draws["merge"]] if draws else [])

    def fed(rng, pool, k):
        u = next(order)
        assert u.shape == pool.shape
        return jmasked.topk_mask(jnp.asarray(u), pool, k, largest=True)

    monkeypatch.setattr(jmasking_mod, "random_subset_mask", fed)
    monkeypatch.setattr(jmerge_mod, "random_subset_mask", fed)
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    s2, m = j_make_mhim_step(jcfg, jmodel, SPE)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    assert next(order, None) is None  # every draw was taken
    return jax.tree.map(np.asarray, s2), {k: float(v) for k, v in m.items()}


def _check_params(name, got, want, grad, lr, rtol, atol, scale=None):
    """``got`` against ``want`` at rtol / atol, except where the reference
    gradient lies within GRAD_TOL of zero: Adam's first update moves such an
    entry by up to lr either way, so there the two may differ by 2·lr."""
    got, want, grad = (np.asarray(x, np.float32) for x in (got, want, grad))
    noisy = np.abs(grad) <= GRAD_TOL * (np.abs(grad).max() if scale is None else scale)
    d = np.abs(got - want)
    bad = np.where(noisy, d > 2 * lr, d > atol + rtol * np.abs(want))
    assert not bad.any(), (f"{name}: {int(bad.sum())} of {bad.size} entries miss (rtol {rtol}, atol {atol}), "
                           f"max|d| {d[bad].max():.3e}")


@pytest.fixture(scope="module")
def mhim_refs():
    """JAX's single-device step for a case's inputs, shared by a case and
    its controls."""
    cache = {}

    def get(cfg_kw, inputs):
        key = json.dumps(cfg_kw, sort_keys=True)
        if key not in cache:
            _, model = _port_mhim(cfg_kw)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["w"].items()})
            with pytest.MonkeyPatch.context() as mp:
                jstate, jmetrics = _jax_mhim_step(mp, cfg_kw, model, inputs["batch"], inputs.get("draw"))
            moments = [s for s in jax.tree.leaves(jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                       if hasattr(s, "mu")]
            mu = {k: np.asarray(v) for k, v in state_dict_from_flax(moments[0].mu, None).items()}
            cache[key] = {"jstate": jstate, "jmetrics": jmetrics, "jmu": mu, "pure": cfg_kw["model"] == "mhim_pure"}
        return cache[key]

    return get


def _check_against_jax(res, ref, lr=MHIM_CFG["lr"]):
    jstate = ref["jstate"]
    metrics, student, teacher, moments = (_group(res, g) for g in ("m", "s", "t", "g"))
    _close(metrics["loss"], ref["jmetrics"]["loss"], rtol=2e-5, atol=0, msg="loss")
    for k in ("keep_num", "patch_num"):
        _close(metrics[k], ref["jmetrics"][k], rtol=1e-6, atol=0, msg=k)
    assert set(moments) == set(ref["jmu"])
    for k, want in ref["jmu"].items():
        _close(moments[k], want, rtol=0, atol=GRAD_TOL * np.abs(want).max(), msg=f"gradient {k}")
    buffers = jstate.model_state.get("buffers")
    want = state_dict_from_flax(jstate.params, buffers)
    want_t = state_dict_from_flax(jstate.teacher_params, buffers)
    assert set(student) == set(want) and ("merge.global_q_mm" in want) != ref["pure"]
    for k, v in want.items():
        if k in ref["jmu"]:
            _check_params(f"student {k}", student[k], v, ref["jmu"][k], lr, rtol=1e-4, atol=1e-6)
        else:
            _close(student[k], v, rtol=1e-4, atol=1e-6, msg=f"student {k}")
    for k, v in teacher.items():
        if k != "merge.global_q_mm":  # the teacher's copy of the buffer is never read
            _close(v, want_t[k], rtol=1e-4, atol=1e-6, msg=f"teacher {k}")


@pytest.mark.parametrize("case", ["mhim_selfattn", "mhim_attn", "mhim_pure_selfattn", "mhim_long"])
def test_mhim_sp_step_matches_jax(world, mhim_refs, case):
    """A world of dp 2 × sp 2 gloo ranks, each holding 4 bags' halves of
    the instances (the last bag a padding bag), equals JAX's single-device
    step (which JAX's ``tests/test_parallel.py:97`` holds equal to its dp ×
    sp mesh): the flagship step with each baseline, the teacher stage's
    (``mhim_pure``) and the flagship on 4,096-token bags, whose teacher and
    ``forward_test`` run the streamed op (``tests/test_parallel.py:237``)."""
    inputs, results = world
    spec_cfg = LONG_CFG if case == "mhim_long" else {
        **MHIM_CFG, "baseline": "attn" if case == "mhim_attn" else "selfattn",
        "model": "mhim_pure" if "pure" in case else "mhim"}
    _check_against_jax(results[case], mhim_refs(spec_cfg, inputs[case]))


@pytest.mark.parametrize("control", ["k1_unmerged", "loss_every_rank"])
def test_controls_per_rank_couplings_miss_jax(world, mhim_refs, control):
    """The test sees the sp couplings: the flagship step with K1's blocks
    not merged over the sp row, or with each bag's loss counted on every sp
    rank, misses JAX's tolerance."""
    inputs, results = world
    ref = mhim_refs({**MHIM_CFG, "baseline": "selfattn"}, inputs["mhim_selfattn"])
    with pytest.raises(AssertionError):
        _check_against_jax(results[f"control_{control}"], ref)


def test_mhim_sp_forward_test_matches_jax(world):
    """``forward_test`` over dp 2 × sp 2, the logits gathered, against JAX's
    on the whole batch (rtol 1e-4, atol 1e-5)."""
    inputs, results = world
    sd = dict(inputs["forward_test"]["w"])
    params = import_mhim_selfattn(sd)
    params["merge"], mb = import_merge(sd)
    jmodel, _ = j_build_model(j_load_config([], **{**MHIM_CFG, "baseline": "selfattn"}))
    batch = inputs["forward_test"]["batch"]
    want = jax.jit(lambda p, f, m: jmodel.apply({"params": p, "buffers": {"merge": mb}}, f, m,
                                                method=JMHIM.forward_test))(params, batch["feats"], batch["mask"])
    _close(results["forward_test"]["logits"], want["logits"], rtol=1e-4, atol=1e-5)


def test_abmil_sp_step_matches_jax(world, monkeypatch):
    """``tests/test_parallel.py:18-55``: abmil's generic step at dp 2 × sp 2
    against JAX's single-device step: loss rtol 1e-5, the gradients within
    GRAD_TOL of max|g| (a tensor whose whole gradient is within that of the
    model's max|g| of zero at that scale), the parameters after the update
    at rtol 1e-4 / atol 1e-6."""
    from mhim_mil_tpu.engine.steps import make_train_step as j_make_train_step

    _, results = world
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    jcfg, jm, family, state, batch = _generic_jax()
    s2, m = j_make_train_step(jcfg, jm, family, SPE, donate=False)(state, {k: jnp.asarray(v)
                                                                          for k, v in batch.items()})
    res = results["abmil"]
    _close(res["m/loss"], float(m["loss"]), rtol=1e-5, atol=0, msg="loss")
    moments = [x for x in jax.tree.leaves(s2.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu")]
    mu = {k: v.numpy() for k, v in weights.abmil_state_from_flax(_np_params(moments[0].mu)).items()}
    want = weights.abmil_state_from_flax(_np_params(s2.params))
    assert set(want) == set(mu) == set(_group(res, "g"))
    top = max(np.abs(g).max() for g in mu.values())
    for k, v in want.items():
        scale = np.abs(mu[k]).max() if np.abs(mu[k]).max() > GRAD_TOL * top else top
        _close(res[f"g/{k}"], mu[k], rtol=0, atol=GRAD_TOL * scale, msg=f"gradient {k}")
        _check_params(k, res[f"s/{k}"], v, mu[k], jcfg.lr, rtol=1e-4, atol=1e-6, scale=scale)


def test_abmil_sp_eval_matches_jax(world):
    """``tests/test_parallel.py:151-184``: ``evaluate`` over dp 2 × sp 2
    (K4's plain version on each block, merged by the blocks' log-sum-exp)
    against JAX's single-device evaluation: AUC and accuracy within 1e-6."""
    from mhim_mil_tpu.engine.driver import device_eval_batches as j_device_eval_batches
    from mhim_mil_tpu.engine.driver import evaluate as j_evaluate
    from mhim_mil_tpu.engine.steps import make_eval_step as j_make_eval_step

    _, results = world
    jcfg, jm, family, state, slides = _eval_state()
    row = j_evaluate(jcfg, j_make_eval_step(jcfg, jm, family), state, j_device_eval_batches(jcfg, slides), 0, False)
    np.testing.assert_allclose(results["eval"]["auc"], row["auc"], atol=1e-6)
    np.testing.assert_allclose(results["eval"]["acc"], row["acc"], atol=1e-6)


def test_sp_raises_outside_its_models(world):
    """What no sp mesh runs raises ValueError, naming the cause: in the
    world of 4, dtfd without a mesh flag and rrtmil's batch of 3 bags over
    ``--mesh_dp 2 --mesh_sp 2``; in this process, the layout of an sp row
    on which a rank would hold no instance (every rank reads the same
    counts, so all raise alike)."""
    _, results = world
    for case, words in (("raise_no_flags", "--mesh_dp"), ("raise_batch_split", "does not split over --mesh_dp 2")):
        assert str(results[case]["type"]) == "ValueError", case
        assert words in str(results[case]["message"]), case
    with pmesh.Mesh(dp=1, sp=2, world=2, rank=0), pytest.raises(ValueError, match="at least one instance"):
        pmesh.seq_layout(3, "cpu")  # no process group: the other rank's count reads 0


# ---- the driver through its command line ------------------------------------------------


def test_driver_sp_matches_one_process(tmp_path):
    """``tests/test_parallel.py:187-202`` through the command line:
    MHIM-attn under ``torch.distributed.run --nproc_per_node 4`` with
    ``--mesh_dp 2 --mesh_sp 2``, 2 folds × 2 epochs: the test rows' AUC and
    accuracy within 1e-6 of the one-process run, rank 0 alone wrote."""
    from mhim_mil_torch.main import main

    argv = ["--datasets", "synth", "--input_dim", "32", "--inner_dim", "32", "--synth_n_slides", "16",
            "--synth_bag_size", "64", "--bucket_sizes", "64", "--batch_size", "4", "--cv_fold", "2",
            "--num_epoch", "2", "--max_epoch", "2", "--lr", "1e-3", "--lr_sche", "const", "--num_bootstrap", "5",
            "--model", "mhim", "--baseline", "attn", "--mask_ratio", "0.5", "--mask_ratio_h", "0.1",
            "--merge_enable", "true", "--merge_ratio", "0.5", "--aux_alpha", "0.5", "--attn2score", "true",
            "--title", "sp"]
    out_sp, out_one = tmp_path / "sp", tmp_path / "one"
    res = _torchrun(4, ["-m", "mhim_mil_torch.main", "--device", "cpu", *argv, "--mesh_dp", "2", "--mesh_sp", "2",
                        "--output_path", str(out_sp)])
    one = main(["--device", "cpu", *argv, "--output_path", str(out_one)])
    with open(out_sp / "sp_results.json") as f:
        sp = json.load(f)
    assert np.isfinite(sp["summary"]["auc"]["mean"])
    assert len(sp["folds"]) == len(one["folds"]) == 2
    for f_sp, f_one in zip(sp["folds"], one["folds"]):
        for row in ("test", "test_ema"):
            for key in ("auc", "acc"):
                np.testing.assert_allclose(f_sp[row][key], f_one[row][key], atol=1e-6, err_msg=f"{row} {key}")
    assert sorted(os.listdir(out_sp)) == sorted(os.listdir(out_one))
    lines = res.stdout.splitlines()
    for rank in (1, 2, 3):
        said = [line for line in lines if re.match(rf"\[\w*{rank}\]:", line)]
        assert not [line for line in said if "fold" in line or "results written" in line], said
    assert any(re.match(r"\[\w*0\]:.*results written", line) for line in lines)


def test_shard_batch_lays_out_jax_sp_shards():
    """``shard_batch`` on a dp 2 × sp 2 mesh: each rank's rows and instance
    block, the bag-level arrays by rows only, as ``batch_pspecs(True)``
    places them; with ``shard_instances=False`` the rows only."""
    batch = _mhim_batch(b=4, n=63)
    for rank in range(4):
        mesh = make_mesh(dp=2, sp=2, world=4, rank=rank)
        rows, inst = slice(2 * (rank // 2), 2 * (rank // 2) + 2), (slice(0, 32), slice(32, 63))[rank % 2]
        got = shard_batch(mesh, batch)
        for k in ("feats", "mask"):
            np.testing.assert_array_equal(got[k], batch[k][rows][:, inst], err_msg=k)
        for k in ("bag_valid", "target"):
            np.testing.assert_array_equal(got[k], batch[k][rows], err_msg=k)
        np.testing.assert_array_equal(shard_batch(mesh, batch, shard_instances=False)["feats"], batch["feats"][rows])


def test_sp_draws_keep_the_global_draws_block():
    """Under a mesh each rank draws the global shape and keeps its rows and,
    along a sharded instance axis, its block; dropout on a block draws
    what the one-process dropout draws there."""
    want = torch.rand((4, 1001, 3), generator=torch.Generator().manual_seed(3))
    seq_counts = pmesh.instance_blocks(1001, 2)
    for rank in range(4):
        mesh = make_mesh(dp=2, sp=2, world=4, rank=rank)
        seq = pmesh.Seq(seq_counts, mesh.sp_index)
        with mesh:
            got = pmesh.rand_rows((2, seq.local, 3), torch.Generator().manual_seed(3), "cpu", seq)
        assert torch.equal(got, want[mesh.rows(4)][:, seq.cols])
    drop = layers.Dropout(0.25)
    x = torch.randn(4, 1001, 3)
    whole = drop(x, True, torch.Generator().manual_seed(5))
    with make_mesh(dp=1, sp=2, world=2, rank=1):
        seq = pmesh.Seq(seq_counts, 1)
        part = drop(x[:, seq.cols], True, torch.Generator().manual_seed(5), seq)
    assert torch.equal(part, whole[:, seq.cols])
