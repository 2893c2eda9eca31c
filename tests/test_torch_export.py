"""The serving export bundle: the kernels' ``torch.library`` ops
(``torch.ops.mhim_mil_torch``), the shared inference body, the port's
``export_serving_bundle`` / ``ServingBundle`` against the JAX package's bundle
and against the live ``Scorer``, and the export CLI.

Small widths (input_dim 16, inner_dim 32, 2 heads, 16 landmarks) and
buckets below ``NystromMSA.stream_min_len`` (4,096), so that the CPU
programs run the ops' CPU kernels, the kernels' plain versions. Against the
JAX bundle (same flax weights, same bags from a numpy seed): fp32 at rtol
1e-4, atol 1e-5 (the JAX tests' own), the bf16 policy at atol 0.05
(``tests/test_torch_serving.py``'s: the two frameworks round to bf16 at
different places). Against the live ``Scorer``: 1e-5.
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from mhim_mil_tpu.utils.serving import export_serving_bundle as j_export, load_bundle as j_load_bundle
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import (EvalBody, apply_cast, cast_compute, compute_dtype, make_eval_step,
                                         make_mhim_eval_step)
from mhim_mil_torch.models import build_model
from mhim_mil_torch.ops.nystrom import pinv_start
from mhim_mil_torch.utils.checkpoint import port_state_dict
from mhim_mil_torch.utils.serving import Scorer, ServingBundle, export_serving_bundle, load_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM, DIM = 16, 32
CFG = dict(input_dim=IN_DIM, inner_dim=DIM, n_heads=2)
BUCKETS = (64, 128)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for torch: beside the other test workers its
    thread pool spins against theirs, and a tiny run takes 10–100× longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _bags(seed, b, n, lengths=None):
    g = np.random.default_rng(seed)
    feats = g.normal(size=(b, n, IN_DIM)).astype(np.float32)
    lengths = lengths or (n,) * b
    return feats, np.arange(n)[None] < np.array(lengths)[:, None]


def _ops_in(prog):
    """The ``mhim_mil_torch`` ops of an exported program, counted by name."""
    return collections.Counter(n.target.name().split("::")[1].split(".")[0] for n in prog.graph.nodes
                               if n.op == "call_function" and hasattr(n.target, "name")
                               and n.target.name().startswith("mhim_mil_torch::"))


# ---- the ops ------------------------------------------------------------------------------


def _op_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    b, h, n, m, dh = 2, 2, 24, 8, 16
    mask = torch.arange(n)[None] < torch.tensor([[24], [13]])
    ql, lm = r(b, h, m, dh), torch.ones(b, m, dtype=torch.bool)
    x, z0 = pinv_start(torch.softmax(r(4, m, m), -1))
    return {
        "pass_a": (ql, r(b, h, n, dh), r(b, h, n, dh), mask),
        "pass_b": (r(b, h, n, dh), r(b, h, n, dh), mask, r(b, h, m, dh), lm, r(b, h, m, dh), ql,
                   r(b, h, m).abs(), r(b, h, m)),
        "newton_schulz": (x, z0, 3, True),
        "abmil_pool": (r(b, n, 8), r(b, n), mask),
        "scan2d": (r(2, 3, 4, 8), torch.rand(2, 3, 4, 8, generator=g), r(8, 4), r(2, 3, 4, 4), r(2, 3, 4, 4), r(8)),
    }


@pytest.mark.parametrize("name", ["pass_a", "pass_b", "newton_schulz", "abmil_pool", "scan2d"])
def test_op_passes_opcheck(name):
    """Each kernel's op on CPU tensors: its schema, its fake's shapes,
    dtypes and strides against the CPU kernel's, and AOT dispatch with a
    dynamic batch (``torch.library.opcheck``)."""
    op = getattr(torch.ops.mhim_mil_torch, name).default
    torch.library.opcheck(op, _op_cases()[name])


def test_newton_schulz_op_keeps_the_iterates_only_for_a_gradient():
    x, z0, _, _ = _op_cases()["newton_schulz"]
    z, it = torch.ops.mhim_mil_torch.newton_schulz(x, z0, 3, False)
    zk, itk = torch.ops.mhim_mil_torch.newton_schulz(x, z0, 3, True)
    assert it.shape == (0, 4, *x.shape) and itk.shape == (3, 4, *x.shape)
    torch.testing.assert_close(z, zk, rtol=0, atol=0)
    torch.testing.assert_close(itk[0, 0], z0, rtol=0, atol=0)
    assert itk[0, 0].data_ptr() != z0.data_ptr()


# ---- the shared inference body ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model_name", ["mhim", "abmil", "dsmil"])
def test_eval_steps_are_the_body_bit_for_bit(model_name, dtype):
    """``make_mhim_eval_step`` / ``make_eval_step`` give the logits (and
    dsmil's sub_logits) of :class:`EvalBody` run eagerly, bit for bit, and
    those of the functional call over ``cast_compute``'s weights that the
    steps ran before."""
    preset = "config/mhim_c16.yaml" if model_name == "mhim" else "config/feat_cls.yaml"
    cfg = load_config(["-c", preset], model=model_name, compute_dtype=dtype, **CFG)
    model, family = build_model(cfg, device="cpu")
    feats, mask = (torch.from_numpy(a) for a in _bags(1, 3, 64, (64, 40, 9)))
    step = make_mhim_eval_step(cfg, model) if family == "mhim" else make_eval_step(cfg, model, family)
    got = step({"feats": feats, "mask": mask})
    with torch.no_grad():
        body = EvalBody(cfg, model, family)(feats, mask)
        x = feats.to(compute_dtype(cfg))
        if family == "mhim":
            old = {"logits": apply_cast(model, cast_compute(cfg, model), "forward_test", x, mask)["logits"].float()}
        else:
            out = apply_cast(model, cast_compute(cfg, model), "forward", x, mask, training=False)
            old = {"logits": out["logits"].float(),
                   **({"sub_logits": out["inst_logits_bag"].float()} if "inst_logits_bag" in out else {})}
    assert sorted(got) == sorted(body) == sorted(old) == (["logits", "sub_logits"] if family == "dsmil" else ["logits"])
    for k in got:
        torch.testing.assert_close(got[k], body[k], rtol=0, atol=0)
        torch.testing.assert_close(got[k], old[k], rtol=0, atol=0)
    assert all(p.dtype == torch.float32 for p in model.parameters())  # the master weights stay fp32


# ---- against the JAX package's bundle ------------------------------------------------------------


JAX_CASES = {  # label: (preset, config flags, the ops the CPU program must call, by count)
    "abmil": ("config/feat_cls.yaml", dict(model="abmil"), {"abmil_pool": 1}),
    "mhim-attn": ("config/mhim_c16.yaml", dict(model="mhim", baseline="attn"), {"abmil_pool": 1}),
    "mhim-selfattn": ("config/mhim_c16.yaml", dict(model="mhim", baseline="selfattn"), {"pass_a": 2, "pass_b": 2}),
    "2dmamba": ("config/feat_surv.yaml", dict(model="2dmamba", datasets="surv_blca", mambamil_dim=DIM,
                                              mamba_2d_max_h=6, mamba_2d_max_w=7), {"scan2d": 1}),
}


@pytest.fixture(scope="module")
def jax_pairs():
    """``label -> make(dtype) -> (jax cfg, jax model, family, variables,
    port cfg, port model)`` on the same flax weights (MHIM's initialised by
    the training pass, so that they hold the Merge buffers)."""
    made = {}

    def make(label, dtype):
        preset, flags, _ = JAX_CASES[label]
        kw = dict(CFG, **flags, compute_dtype=dtype)
        jcfg = j_load_config(["-c", preset], **kw)
        jm, family = j_build_model(jcfg)
        if label not in made:
            feats, mask = jnp.ones((1, 8, IN_DIM)), jnp.ones((1, 8), bool)
            rngs = {"params": jax.random.PRNGKey(7), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
            if flags["model"] == "mhim":
                variables = jax.jit(partial(jm.init, training=True))(rngs, feats, mask, jnp.zeros((1, 8)))
            elif flags["model"] == "2dmamba":
                variables = jax.jit(jm.init)(rngs, feats, mask, jnp.zeros((1, 8, 2), jnp.int32))
            else:
                variables = jax.jit(jm.init)(rngs, feats, mask)
            made[label] = jax.tree.map(np.asarray, variables)
        variables = made[label]
        cfg = load_config(["-c", preset], **kw)
        model, port_family = build_model(cfg, device="cpu")
        model.load_state_dict(port_state_dict(cfg, variables["params"],
                                              {k: v for k, v in variables.items() if k != "params"}))
        assert port_family == family
        return jcfg, jm, family, variables, cfg, model

    return make


@pytest.mark.parametrize("label,dtype", [("abmil", "float32"), ("abmil", "bfloat16"), ("mhim-attn", "float32"),
                                         ("mhim-attn", "bfloat16"), ("mhim-selfattn", "float32"),
                                         ("mhim-selfattn", "bfloat16"), ("2dmamba", "float32")])
def test_bundle_matches_the_jax_bundle(jax_pairs, tmp_path, label, dtype):
    """Both packages export the same weights on the CPU at bucket 64 and
    score the same requests there: a ragged batch of 3 (the programs traced
    at a batch of 2) and one bag of 50. The port's program calls the
    kernels' ops the model reaches."""
    jcfg, jm, family, variables, cfg, model = jax_pairs(label, dtype)
    j_export(jcfg, jm, family, variables, str(tmp_path / "jax"), buckets=(64,), platforms=("cpu",))
    manifest = export_serving_bundle(cfg, model, family, str(tmp_path / "port"), buckets=(64,), platforms=("cpu",))
    assert sorted(os.listdir(tmp_path / "port")) == ["bucket_64_cpu.pt2", "manifest.json"]
    assert manifest["format"] == "mhim_mil_torch.serving/1" and manifest["compute_dtype"] == dtype
    assert {k: manifest[k] for k in ("family", "input_dim", "buckets", "platforms", "batch_dim")} == {
        "family": family, "input_dim": IN_DIM, "buckets": [64], "platforms": ["cpu"], "batch_dim": "symbolic"}
    prog = torch.export.load(str(tmp_path / "port" / "bucket_64_cpu.pt2"))
    assert _ops_in(prog) == JAX_CASES[label][2]
    assert prog.example_inputs is None  # the file holds the weights, not the example batch
    jb, pb = j_load_bundle(str(tmp_path / "jax")), load_bundle(str(tmp_path / "port"), device="cpu")
    for feats, mask in (_bags(3, 3, 64, (64, 45, 12)), (_bags(4, 1, 50)[0][0], None)):
        got, want = pb.score(feats, mask), jb.score(feats, mask)
        assert sorted(got) == sorted(want) == ["logits"]
        assert got["logits"].shape == want["logits"].shape and got["logits"].dtype == np.float32
        if dtype == "float32":
            np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_allclose(got["logits"], want["logits"], atol=0.05)


# ---- against the live Scorer ---------------------------------------------------------------------


ZOO = [("config/mhim_c16.yaml", dict(model="mhim_pure")), ("config/mhim_c16.yaml", dict(model="mhim", baseline="dsmil"))]
ZOO += [("config/feat_cls.yaml", dict(model=m)) for m in ("gabmil", "transmil", "dsmil", "clam_sb", "clam_mb", "dtfd",
                                                           "ibmil", "rrtmil", "mambamil", "meanmil", "maxmil")]


@pytest.mark.parametrize("preset,flags", ZOO, ids=[f["model"] + f.get("baseline", "") for _, f in ZOO])
def test_every_other_model_exports_and_equals_the_scorer(tmp_path, preset, flags):
    """The rest of the registry (mhim_pure, MHIM-dsmil, the zoo; ibmil with
    a confounder bank) under the presets' bf16 policy at bucket 64: the
    bundle's logits (and dsmil's sub_logits) within 1e-5 of the live
    ``Scorer``'s on a ragged batch of 3 and on one bag."""
    if flags["model"] == "ibmil":
        np.save(tmp_path / "bank.npy", np.random.default_rng(5).normal(size=(4, DIM)).astype(np.float32))
        flags = dict(flags, confounder_path=str(tmp_path / "bank.npy"), confounder_k=4)
    cfg = load_config(["-c", preset], **CFG, **flags)
    model, family = build_model(cfg, device="cpu")
    export_serving_bundle(cfg, model, family, str(tmp_path / "b"), buckets=(64,), platforms=("cpu",))
    bundle, scorer = load_bundle(str(tmp_path / "b"), device="cpu"), Scorer(cfg, model, (64,), "cpu", family)
    for feats, mask in (_bags(6, 3, 60, (60, 33, 5)), (_bags(7, 1, 64)[0][0], None)):
        got, want = bundle.score(feats, mask), scorer.score(feats, mask)
        assert sorted(got) == sorted(want) == (["logits", "sub_logits"] if family == "dsmil" else ["logits"])
        for k in want:
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)


# ---- behaviour ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def abmil_bundle(tmp_path_factory):
    cfg = load_config(["-c", "config/feat_cls.yaml"], model="abmil", compute_dtype="float32", **CFG)
    model, family = build_model(cfg, device="cpu")
    path = str(tmp_path_factory.mktemp("abmil") / "bundle")
    export_serving_bundle(cfg, model, family, path, buckets=BUCKETS, platforms=("cpu",))
    return path, cfg, model


def test_the_symbolic_batch_takes_any_batch(abmil_bundle):
    """Programs traced at a batch of 2 score batches of 1, 3 and 5, each bag
    as the live model scores it alone (abmil's bags are independent)."""
    path, cfg, model = abmil_bundle
    bundle = ServingBundle(path, device="cpu")
    feats, mask = _bags(8, 5, 128, (128, 90, 64, 1, 17))
    for b in (1, 3, 5):
        got = bundle.score(feats[:b], mask[:b])["logits"]
        with torch.no_grad():
            want = model(torch.from_numpy(feats[:b]), torch.from_numpy(mask[:b]))["logits"].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_the_bundle_rejects_oversize_bags_wrong_widths_and_a_missing_platform(abmil_bundle, monkeypatch):
    path, _, _ = abmil_bundle
    bundle = load_bundle(path, device="cpu")
    with pytest.raises(ValueError, match="exceeds the largest bucket 128"):
        bundle.score(_bags(9, 1, 129)[0])
    with pytest.raises(ValueError, match="feature dim"):
        bundle.score(np.zeros((1, 10, IN_DIM + 1), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingBundle(path)  # CUDA unless the CPU is asked for: no card, no fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="no program for cuda"):
        ServingBundle(path, device="cuda")


def test_a_cuda_export_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda export is valid here")
    cfg = load_config(["-c", "config/feat_cls.yaml"], model="abmil", **CFG)
    model, family = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_serving_bundle(cfg, model, family, str(tmp_path / "b"), buckets=(64,))
    assert not (tmp_path / "b" / "manifest.json").exists()


def test_the_loader_needs_neither_jax_nor_the_models(abmil_bundle):
    """A fresh process scores the bundle with ``mhim_mil_torch.utils.serving``
    alone: neither ``jax`` nor ``mhim_mil_torch.models`` is imported."""
    path, cfg, model = abmil_bundle
    feats, mask = _bags(10, 2, 100, (100, 70))
    np.save(os.path.join(os.path.dirname(path), "feats.npy"), feats)
    np.save(os.path.join(os.path.dirname(path), "mask.npy"), mask)
    code = (
        "import sys, numpy as np, os\n"
        "from mhim_mil_torch.utils.serving import load_bundle\n"
        f"d = {os.path.dirname(path)!r}\n"
        f"out = load_bundle({path!r}, device='cpu').score(np.load(os.path.join(d, 'feats.npy')), "
        "np.load(os.path.join(d, 'mask.npy')))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mhim_mil_tpu')\n"
        "             or m.startswith('mhim_mil_torch.models'))\n"
        "assert not bad, bad\n"
        "np.save(os.path.join(d, 'out.npy'), out['logits'])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = Scorer(cfg, model, BUCKETS, "cpu", "default").score(feats, mask)["logits"]
    np.testing.assert_allclose(np.load(os.path.join(os.path.dirname(path), "out.npy")), want, rtol=0, atol=1e-5)


# ---- the CLI ------------------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["port", "jax"])
def test_export_serving_cli(tmp_path, source):
    """checkpoint -> ``python -m mhim_mil_torch.tools.export_serving`` ->
    the bundle's files -> a scored bag, from a port checkpoint and from a
    JAX ``.ckpt`` of the same abmil weights (``--use_teacher`` from the
    port's), as ``tests/test_serving.py::test_export_serving_cli`` does for
    the JAX tool."""
    jm, _ = j_build_model(j_load_config(["-c", "config/feat_cls.yaml"], model="abmil", **CFG))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), jnp.ones((1, 8, IN_DIM)),
                                               jnp.ones((1, 8), bool))["params"])
    cfg = load_config(["-c", "config/feat_cls.yaml"], model="abmil", **CFG)
    model, family = build_model(cfg, device="cpu")
    model.load_state_dict(port_state_dict(cfg, params))
    ckpt = str(tmp_path / "fold_0_model_best.ckpt")
    extra = []
    if source == "jax":
        from types import SimpleNamespace

        j_save_checkpoint(ckpt, SimpleNamespace(params=params, teacher_params=None, opt_state={}, step=0,
                                                model_state={}, rng=jax.random.PRNGKey(0)))
    else:
        torch.save({"model": {k: torch.zeros_like(v) for k, v in model.state_dict().items()},
                    "teacher": model.state_dict()}, ckpt)
        extra = ["--use_teacher"]
    out = str(tmp_path / "bundle")
    res = subprocess.run(
        [sys.executable, "-m", "mhim_mil_torch.tools.export_serving", "--ckpt", ckpt, "--out", out,
         "--model", "abmil", "--input_dim", str(IN_DIM), "--inner_dim", str(DIM), "--buckets", "16,32",
         "--platforms", "cpu", "-c", "config/feat_cls.yaml", "--n_heads", "2", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(os.listdir(out)) == ["bucket_16_cpu.pt2", "bucket_32_cpu.pt2", "manifest.json"]
    feats = np.random.default_rng(11).normal(size=(12, IN_DIM)).astype(np.float32)
    got = load_bundle(out, device="cpu").score(feats)["logits"]
    want = Scorer(cfg, model, (16, 32), "cpu", family).score(feats)["logits"]
    assert got.shape == (cfg.n_classes,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
