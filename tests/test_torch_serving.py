"""The port's scorer and eval step against the JAX package's eval step, the
device rule of the entry points, and the package's independence from JAX.

Small widths (input_dim 16, inner_dim 32, 2 heads, 16 landmarks), buckets
(64, 128). fp32: rtol 1e-4, atol 1e-5. The bf16 policy is compared at
atol 0.05 on logits of magnitude ~1, since the two frameworks round to bf16
at different places.
"""

import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.train_state import MILTrainState
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models.mhim import make_mhim_eval_step as j_make_eval_step
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import make_mhim_eval_step
from mhim_mil_torch.models import build_model
from mhim_mil_torch.utils.serving import Scorer
from mhim_mil_torch.utils.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM = 16
CFG = dict(model="mhim", baseline="selfattn", input_dim=IN_DIM, inner_dim=32, n_heads=2)
BUCKETS = (64, 128)


@pytest.fixture(scope="module")
def pair():
    """Flax params and a function making the port's model with the same weights."""
    jcfg = j_load_config(["-c", "config/mhim_c16.yaml"], **CFG)
    jmodel, _ = j_build_model(jcfg)
    x = jnp.zeros((1, 8, IN_DIM))
    init = jax.jit(partial(jmodel.init, training=True))
    rngs = {"params": jax.random.PRNGKey(7), "dropout": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}
    variables = init(rngs, x, jnp.ones((1, 8), bool), jnp.zeros((1, 8), jnp.float32))
    params = jax.tree.map(np.asarray, variables["params"])
    sd = state_dict_from_flax(params, jax.tree.map(np.asarray, variables["buffers"]))

    def port(**kw):
        cfg = load_config(["-c", "config/mhim_c16.yaml"], **CFG, **kw)
        model, _ = build_model(cfg, device="cpu")
        model.load_state_dict(sd)
        return cfg, model

    def jax_eval(batch, **kw):
        jcfg_kw = j_load_config(["-c", "config/mhim_c16.yaml"], **CFG, **kw)
        state = MILTrainState(
            step=jnp.zeros((), jnp.int32), params=params, model_state={},
            teacher_params=params, opt_state=(), rng=jax.random.PRNGKey(0),
            tx=optax.identity(), apply_fn=jmodel.apply,
        )
        out = j_make_eval_step(jcfg_kw, jmodel)(state, {k: jnp.asarray(v) for k, v in batch.items()})
        return np.asarray(out["logits"])

    return port, jax_eval


def _bags(seed, b, n):
    return np.random.default_rng(seed).normal(size=(b, n, IN_DIM)).astype(np.float32)


def _pad(feats, mask, bucket):
    b, n, d = feats.shape
    feats = np.concatenate([feats, np.zeros((b, bucket - n, d), np.float32)], axis=1)
    mask = np.concatenate([mask, np.zeros((b, bucket - n), bool)], axis=1)
    return feats, mask


def test_scorer_pads_into_the_bucket_and_matches_the_jax_eval_step(pair):
    """A ragged request of 90 instances goes into bucket 128, padded at the end
    and masked: the scorer's logits equal the eval step on that padded batch,
    and the JAX eval step's on the same batch."""
    port, jax_eval = pair
    cfg, model = port(compute_dtype="float32")
    scorer = Scorer(cfg, model, buckets=BUCKETS, device="cpu")
    feats = _bags(0, 3, 90)
    mask = np.arange(90)[None] < np.array([[90], [61], [0]])
    assert scorer.bucket_for(90) == 128 and scorer.bucket_for(64) == 64
    got = scorer.score(feats, mask)["logits"]
    assert got.shape == (3, 2) and got.dtype == np.float32
    pf, pm = _pad(feats, mask, 128)
    step = make_mhim_eval_step(cfg, model)
    want_port = step({"feats": torch.from_numpy(pf), "mask": torch.from_numpy(pm)})["logits"]
    np.testing.assert_allclose(got, want_port.numpy(), rtol=1e-6, atol=1e-6)
    want = jax_eval({"feats": pf, "mask": pm}, compute_dtype="float32")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    one = scorer.score(feats[0])["logits"]  # a single [N, D] bag
    assert one.shape == (2,)


def test_scorer_bf16_policy_matches_the_jax_eval_step(pair):
    port, jax_eval = pair
    cfg, model = port()
    assert cfg.compute_dtype == "bfloat16"
    feats = _bags(1, 2, 64)
    mask = np.arange(64)[None] < np.array([[64], [40]])
    got = Scorer(cfg, model, buckets=BUCKETS, device="cpu").score(feats, mask)["logits"]
    want = jax_eval({"feats": feats, "mask": mask})
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.05)
    assert next(model.parameters()).dtype == torch.float32  # the master weights stay fp32


def test_batch_composition_changes_a_bags_logits(pair):
    """The pinv's initial scale couples the bags of one call, in the port as
    in JAX: a bag scored alone and beside another gets other logits."""
    port, jax_eval = pair
    cfg, model = port(compute_dtype="float32")
    scorer = Scorer(cfg, model, buckets=BUCKETS, device="cpu")
    feats = _bags(2, 2, 64)
    feats[1] *= 30.0
    alone = scorer.score(feats[:1])["logits"]
    together = scorer.score(feats)["logits"]
    assert np.abs(alone[0] - together[0]).max() > 1e-4
    mask = np.ones((2, 64), bool)
    np.testing.assert_allclose(together, jax_eval({"feats": feats, "mask": mask},
                                                  compute_dtype="float32"), rtol=1e-4, atol=1e-5)


def test_scorer_rejects_oversize_bags_and_wrong_widths(pair):
    port, _ = pair
    cfg, model = port(compute_dtype="float32")
    scorer = Scorer(cfg, model, buckets=BUCKETS, device="cpu")
    with pytest.raises(ValueError, match="exceeds the largest bucket 128"):
        scorer.score(_bags(3, 1, 129))
    with pytest.raises(ValueError, match="feature dim"):
        scorer.score(np.zeros((1, 10, IN_DIM + 1), np.float32))


def test_entry_points_default_to_cuda_and_never_fall_back(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    port, _ = pair
    cfg, model = port()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scorer(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")


def test_port_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys, mhim_mil_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(mhim_mil_torch.__path__, 'mhim_mil_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mhim_mil_tpu',\n"
        "                                                            'pandas', 'h5py', 'PIL', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 15, mods\n"
        "assert {'mhim_mil_torch.ops.scan', 'mhim_mil_torch.ops.scan2d', 'mhim_mil_torch.models.mamba'} <= set(mods)\n"
        "assert {'mhim_mil_torch.main', 'mhim_mil_torch.engine.driver', 'mhim_mil_torch.engine.metrics',\n"
        "        'mhim_mil_torch.ops.probe', 'mhim_mil_torch.utils.kernel_gate', 'mhim_mil_torch.utils.kernel_check',\n"
        "        'mhim_mil_torch.utils.checkpoint', 'mhim_mil_torch.utils.early_stopping',\n"
        "        'mhim_mil_torch.utils.logging', 'mhim_mil_torch.data.synthetic', 'mhim_mil_torch.data.splits',\n"
        "        'mhim_mil_torch.data.bucketing', 'mhim_mil_torch.data.readers'} <= set(mods)\n"
        "assert {'mhim_mil_torch.models.abmil', 'mhim_mil_torch.models.mean_max', 'mhim_mil_torch.models.dsmil',\n"
        "        'mhim_mil_torch.models.positional', 'mhim_mil_torch.models.transformer',\n"
        "        'mhim_mil_torch.utils.weights'} <= set(mods)\n"
        "assert {'mhim_mil_torch.models.clam', 'mhim_mil_torch.models.dtfd', 'mhim_mil_torch.models.ibmil',\n"
        "        'mhim_mil_torch.models.rrt', 'mhim_mil_torch.utils.confounders'} <= set(mods)\n"
        "assert {'mhim_mil_torch.utils.heatmap', 'mhim_mil_torch.tools.export_attention'} <= set(mods)\n"
        "assert {'mhim_mil_torch.tools.bench', 'mhim_mil_torch.tools.stress_30k', 'mhim_mil_torch.tools.latency',\n"
        "        'mhim_mil_torch.tools.timing'} <= set(mods)\n"
        "assert {'mhim_mil_torch.tools.roofline', 'mhim_mil_torch.tools.step_breakdown',\n"
        "        'mhim_mil_torch.tools.make_splits', 'mhim_mil_torch.tools.convert_features',\n"
        "        'mhim_mil_torch.preprocess.extract'} <= set(mods)\n"
        "assert {'mhim_mil_torch.preprocess.encoders', 'mhim_mil_torch.preprocess.segment',\n"
        "        'mhim_mil_torch.tools.extract_features'} <= set(mods)\n"
        "assert {'mhim_mil_torch.preprocess.tiff', 'mhim_mil_torch.preprocess.ndpi', 'mhim_mil_torch.preprocess.vms',\n"
        "        'mhim_mil_torch.preprocess.mirax', 'mhim_mil_torch.preprocess.vendor_tiff',\n"
        "        'mhim_mil_torch.native'} <= set(mods)\n"
        "assert {'mhim_mil_torch.parallel', 'mhim_mil_torch.parallel.mesh'} <= set(mods)\n"
        "assert 'mhim_mil_torch.preprocess.slide' not in mods\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
