"""The port's 2D Mamba path (``2dmamba``) against the JAX package on the CPU.

The same numpy inputs go through the JAX function and its port: the scans
(``linear_scan``, both variants of ``selective_scan_2d``, K5's plain version
against JAX's scan and its Pallas kernel in interpret mode), the grid
rasterisation, the whole ``MambaMIL2D`` with flax weights carried by
``mamba2d_state_from_flax``, the eval step and the scorer. Small widths:
input 16, model dim 32 (so ED = 64 and JAX's kernel path applies), state 16.
fp32 at rtol 1e-4, atol 1e-5; the bf16 policy at the serving tolerance of
0.1 against JAX's plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mhim_mil_tpu.ops.pallas_scan2d as jps
from mhim_mil_tpu.config import load_config as j_load_config
from mhim_mil_tpu.engine.steps import make_eval_step as j_make_eval_step
from mhim_mil_tpu.engine.train_state import MILTrainState
from mhim_mil_tpu.models import build_model as j_build_model
from mhim_mil_tpu.models import mamba as jmamba
from mhim_mil_tpu.ops import scan as jscan
from mhim_mil_tpu.utils.serving import _infer_fn
from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine.steps import make_eval_step
from mhim_mil_torch.models import build_model
from mhim_mil_torch.models import mamba
from mhim_mil_torch.ops import scan, scan2d
from mhim_mil_torch.utils.serving import Scorer
from mhim_mil_torch.utils.weights import mamba2d_state_from_flax

RTOL, ATOL = 1e-4, 1e-5
IN_DIM, DIM = 16, 32
GRID_H, GRID_W = 6, 7
CFG = dict(model="2dmamba", input_dim=IN_DIM, mambamil_dim=DIM, mamba_2d_max_w=GRID_W,
           mamba_2d_max_h=GRID_H)
BUCKETS = (32, 64)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _scan_inputs(seed, bs, h, w, ed, n):
    """x, Δ = 0.1·softplus(normal), A_log = log(1..n), B, C, D as
    ``test_pallas_scan2d.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bs, h, w, ed)).astype(np.float32)
    delta = (np.log1p(np.exp(rng.normal(size=(bs, h, w, ed)))) * 0.1).astype(np.float32)
    a_log = np.log(np.tile(np.arange(1, n + 1, dtype=np.float32), (ed, 1)))
    B = rng.normal(size=(bs, h, w, n)).astype(np.float32)
    C = rng.normal(size=(bs, h, w, n)).astype(np.float32)
    D = rng.normal(size=(ed,)).astype(np.float32)
    return x, delta, a_log, B, C, D


# ---- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("length,dim", [(13, 0), (11, 1), (1, 0)])
def test_linear_scan_matches_jax(length, dim):
    """Along a non-power-of-two axis (and a single step), either axis."""
    rng = np.random.default_rng(length)
    shape = (length, 3) if dim == 0 else (2, length, 3)
    a = rng.uniform(0.2, 1.0, size=shape).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jscan.linear_scan(jnp.asarray(a), jnp.asarray(x), axis=dim))
    got = scan.linear_scan(_t(a), _t(x), dim=dim).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_linear_scan_survives_products_that_underflow():
    """ā = exp(−0.1·16) over a BLCA row of 381 columns: the product of ā
    underflows to 0 in fp32, where a closed form through cumprod divides by
    it; the doubling scan stays finite and equal to the recurrence."""
    a = np.full((381, 2), np.exp(-1.6), np.float32)
    x = np.random.default_rng(0).normal(size=(381, 2)).astype(np.float32)
    assert np.prod(a[:, 0]) == 0.0
    want = np.zeros_like(x, np.float64)
    h = np.zeros(2)
    for t in range(381):
        h = a[t] * h + x[t]
        want[t] = h
    got = scan.linear_scan(_t(a), _t(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bs,h,w,ed,n,ed_tile", [(2, 6, 8, 8, 4, 4), (2, 9, 16, 8, 4, 4), (1, 5, 11, 4, 2, 2)])
def test_selective_scan_2d_matches_jax_and_the_pallas_kernel(bs, h, w, ed, n, ed_tile):
    """The port's separable scan, K5's plain version and the K5 wrapper on
    CPU tensors against JAX's scan and ``pallas_selective_scan_2d`` in
    interpret mode, at ``test_pallas_scan2d.py``'s shapes. No launch is
    counted on the CPU."""
    x, delta, a_log, B, C, D = _scan_inputs(h * w, bs, h, w, ed, n)
    j = [jnp.asarray(t) for t in (x, delta, a_log, B, C, D)]
    want = np.asarray(jscan.selective_scan_2d(j[0], j[1], -jnp.exp(j[2]), *j[3:]))
    want_k = np.asarray(jps.pallas_selective_scan_2d(*j, ed_tile=ed_tile, interpret=True))
    t = [_t(v) for v in (x, delta, a_log, B, C, D)]
    before = scan2d.selective_scan_2d_fused.launches
    got = {
        "separable": scan.selective_scan_2d(t[0], t[1], -torch.exp(t[2]), *t[3:]),
        "scan2d_plain": scan2d.scan2d_plain(*t),
        "fused on the CPU": scan2d.selective_scan_2d_fused(*t),
    }
    assert scan2d.selective_scan_2d_fused.launches == before
    for name, g in got.items():
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), want_k, rtol=RTOL, atol=ATOL, err_msg=name)


def test_wavefront_matches_jax_and_the_sequential_recurrence():
    """On a tiny grid, where the lattice-path growth stays small."""
    x, delta, a_log, B, C, D = _scan_inputs(5, 2, 3, 4, 4, 2)
    j = [jnp.asarray(t) for t in (x, delta, -np.exp(a_log), B, C, D)]
    want = np.asarray(jscan.selective_scan_2d(*j, variant="wavefront"))
    seq = jscan.selective_scan_2d_seq(x, delta, -np.exp(a_log), B, C, D)
    got = scan.selective_scan_2d(*(_t(v) for v in (x, delta, -np.exp(a_log), B, C, D)), variant="wavefront")
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), seq, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown variant"):
        scan.selective_scan_2d(*(_t(v) for v in (x, delta, a_log, B, C, D)), variant="diagonal")


def test_rasterize_grid_matches_jax():
    """Masked rows go to the trash cell (and may collide), coordinates out of
    the grid are clipped; the valid cells are distinct after clipping."""
    h, w, c = 4, 5, 3
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 8, c)).astype(np.float32)
    coords = np.array([
        [[0, 0], [4, 3], [7, 1], [-2, 2], [1, 9], [2, 2], [0, 0], [0, 0]],
        [[3, 0], [0, 3], [2, 1], [9, 9], [1, 1], [4, 0], [3, 3], [1, 0]],
    ], np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 0, 1, 1, 0]], bool)
    pad = rng.normal(size=(c,)).astype(np.float32)
    want = jmamba.rasterize_grid(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask), h, w,
                                 jnp.asarray(pad))
    got = mamba.rasterize_grid(_t(feats), _t(coords), _t(mask), h, w, _t(pad))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].sum() == mask.sum()
    np.testing.assert_array_equal(mamba.rowmajor_coords(7, 3).numpy(), np.asarray(jmamba._rowmajor_coords(7, 3)))


# ---- the model ---------------------------------------------------------------------


def _bag(seed, b, n, cells=GRID_H * GRID_W, lengths=None):
    """Features, a ragged mask and distinct (column, row) cells per bag."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, n, IN_DIM)).astype(np.float32)
    lengths = lengths or (n,) * b
    mask = np.arange(n)[None] < np.array(lengths)[:, None]
    idx = np.stack([rng.permutation(cells)[:n] for _ in range(b)])
    pos = np.stack([idx % GRID_W, idx // GRID_W], -1).astype(np.int32)
    return feats, mask, pos


@pytest.fixture(scope="module")
def flax_model():
    """JAX's MambaMIL2D with the linear position embedding, its numpy params
    and a port model carrying the same weights."""
    jm = jmamba.MambaMIL2D(input_dim=IN_DIM, dim=DIM, max_w=GRID_W, max_h=GRID_H,
                           pos_emb_type="linear", use_flash=True)
    feats, mask, pos = _bag(0, 1, 8)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(pos))
    params = jax.tree.map(np.asarray, v["params"])
    port = mamba.MambaMIL2D(input_dim=IN_DIM, dim=DIM, max_w=GRID_W, max_h=GRID_H, pos_emb_type="linear")
    port.load_state_dict(mamba2d_state_from_flax(params))
    return jm, params, port.eval()


@pytest.mark.parametrize("jax_path", ["plain", "pallas interpret"])
@pytest.mark.parametrize("with_pos", [True, False], ids=["pos", "raster"])
def test_mamba_mil2d_matches_jax(flax_model, with_pos, jax_path):
    """Logits, bag_feat and attn with ``pos`` on the 6 × 7 grid (linear
    position embedding on) and on the raster grid (20 instances: 4 × 5),
    ragged; JAX on its plain scan and on its Pallas kernel in interpret
    mode (``FORCE_INTERPRET``, as its own model-level test sets it)."""
    jm, params, port = flax_model
    feats, mask, pos = _bag(1, 2, 20, lengths=(20, 13))
    args = (jnp.asarray(feats), jnp.asarray(mask)) + ((jnp.asarray(pos),) if with_pos else ())
    jps.FORCE_INTERPRET = jax_path != "plain"
    try:
        want = jm.apply({"params": params}, *args, return_attn=True)
    finally:
        jps.FORCE_INTERPRET = False
    with torch.no_grad():
        got = port(_t(feats), _t(mask), _t(pos) if with_pos else None, return_attn=True)
    assert got["attn"].shape == ((2, GRID_H * GRID_W) if with_pos else (2, 20))
    for key in ("logits", "bag_feat", "attn"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL, err_msg=key)


def _flax_from_port(sd, n_layers=1):
    """The port's state_dict as the JAX package's MambaMIL2D param tree (the
    reverse of ``mamba2d_state_from_flax``; the JAX package has no mamba importer)."""
    n = {k: v.numpy() for k, v in sd.items()}
    lin = lambda p: {"kernel": n[f"{p}.weight"].T, **({"bias": n[f"{p}.bias"]} if f"{p}.bias" in n else {})}
    tree = {"_fc1": lin("_fc1"), "norm": {"scale": n["norm.weight"], "bias": n["norm.bias"]},
            "attn_0": lin("attention.0"), "attn_1": lin("attention.2"), "classifier": lin("classifier")}
    if "pad_token" in n:
        tree["pad_token"] = n["pad_token"]
    if "pos_embs.weight" in n:
        tree["pos_embs"] = lin("pos_embs")
    for i in range(n_layers):
        pre = f"layers.{i}.mixer"
        mixer = {k: lin(f"{pre}.{k}") for k in ("in_proj", "x_proj", "dt_proj", "out_proj")}
        mixer.update({k: {"weight": n[f"{pre}.{k}.weight"]} for k in ("dt_layernorm", "B_layernorm", "C_layernorm")})
        mixer["conv1d"] = {"kernel": n[f"{pre}.conv1d.weight"].transpose(2, 1, 0), "bias": n[f"{pre}.conv1d.bias"]}
        mixer["A_log"], mixer["D"] = n[f"{pre}.A_log"], n[f"{pre}.D"]
        tree[f"layer{i}"] = {"norm": {"weight": n[f"layers.{i}.norm.weight"]}, "mixer": mixer}
    return tree


def test_state_dict_round_trips_through_flax(flax_model):
    """flax → port → flax gives back every leaf, and the port's names cover
    the whole JAX tree."""
    _, params, port = flax_model
    back = _flax_from_port(port.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)


def test_init_weights_follow_the_jax_initialisers():
    """``dt_proj``, ``A_log``, ``D``, the pad token, the RMSNorms and the
    conv follow the JAX module's initialisers, not xavier and zero."""
    cfg = load_config(["-c", "config/feat_surv.yaml"], **CFG)
    model, _ = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    mixer = model.layers[0].mixer
    dt_rank = mixer.dt_rank
    assert dt_rank == 2 and mixer.ed == 2 * DIM
    assert mixer.dt_proj.weight.abs().max() <= dt_rank ** -0.5
    dt = torch.nn.functional.softplus(mixer.dt_proj.bias)
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
    torch.testing.assert_close(mixer.A_log, torch.log(torch.arange(1.0, 17.0)).expand(2 * DIM, 16))
    assert torch.all(mixer.D == 1) and torch.all(mixer.conv1d.bias == 0)
    for norm in (model.layers[0].norm, mixer.dt_layernorm, mixer.B_layernorm, mixer.C_layernorm):
        assert torch.all(norm.weight == 1)
    assert 0 <= model.pad_token.min() and model.pad_token.max() < 1 and model.pad_token.std() > 0.1
    # the conv's LeCun-normal std against flax's own draw of the same kernel
    jm = jmamba.MambaMIL2D(input_dim=IN_DIM, dim=DIM, max_w=GRID_W, max_h=GRID_H)
    feats, mask, _ = _bag(0, 1, 8)
    jconv = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(mask))["params"]["layer0"]["mixer"]["conv1d"]
    ratio = float(mixer.conv1d.weight.detach().std()) / float(np.std(np.asarray(jconv["kernel"])))
    assert 0.85 < ratio < 1.15, ratio


def test_build_model_gives_the_blca_survival_configuration():
    """``feat_surv.yaml`` + ``2dmamba`` + ``surv_blca``: the BLCA grid, four
    survival bins, width 128, ED 256, dt_rank 8; the kernel switch."""
    cfg = load_config(["-c", "config/feat_surv.yaml"], model="2dmamba", datasets="surv_blca")
    model, family = build_model(cfg, device="cpu")
    assert family == "mamba2d"
    assert (model.max_w, model.max_h, model.classifier.out_features) == (381, 275, 4)
    mixer = model.layers[0].mixer
    assert (len(model.layers), mixer.ed, mixer.dt_rank, mixer.d_state, mixer.use_flash) == (1, 256, 8, 16, True)
    plain, _ = build_model(cfg.replace(use_flash_attn=False), device="cpu")
    assert not plain.layers[0].mixer.use_flash


def test_training_takes_the_plain_scan_and_the_1d_block_raises(flax_model):
    """Under grad in training mode the block differentiates the plain scan
    (and equals the no-grad path). A 1D input, which raised before the 1D
    scan was ported, now runs the masked 1D scan: an all-valid mask gives
    what no mask gives (``tests/test_torch_mambamil.py`` holds it against JAX)."""
    _, _, port = flax_model
    block = port.layers[0]
    grid = torch.randn(1, 3, 4, DIM, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = block(grid)
    got = block(grid, training=True)
    got.sum().backward()
    torch.testing.assert_close(got.detach(), want, rtol=RTOL, atol=ATOL)
    assert block.mixer.A_log.grad is not None and block.mixer.A_log.grad.abs().sum() > 0
    port.zero_grad()
    seq = torch.randn(2, 5, DIM, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = block.mixer(seq)
        torch.testing.assert_close(block.mixer(seq, torch.ones(2, 5, dtype=torch.bool)), out, rtol=0, atol=0)
    assert out.shape == seq.shape and torch.isfinite(out).all()


# ---- the eval step and the scorer ---------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """JAX's 2dmamba from the config (its plain scan: ``use_flash_attn`` is
    None there), its params, and a function making the port's model with
    the same weights."""
    jcfg = j_load_config(["-c", "config/feat_surv.yaml"], **CFG)
    jm, family = j_build_model(jcfg)
    assert family == "mamba2d"
    feats, mask, pos = _bag(0, 1, 8)
    v = jm.init(jax.random.PRNGKey(5), jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(pos))
    params = jax.tree.map(np.asarray, v["params"])
    sd = mamba2d_state_from_flax(params)

    def port(**kw):
        cfg = load_config(["-c", "config/feat_surv.yaml"], **CFG, **kw)
        model, fam = build_model(cfg, device="cpu")
        model.load_state_dict(sd)
        return cfg, model, fam

    def jax_cfg(**kw):
        return j_load_config(["-c", "config/feat_surv.yaml"], **CFG, **kw)

    return jm, params, port, jax_cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_with_pos_matches_the_jax_eval_step(pair, dtype):
    """A padded bucket of 32 slots (one bag ragged at 20) with grid
    coordinates: fp32 at rtol 1e-4 atol 1e-5; the bf16 policy within 0.1
    of JAX's plain path (JAX's kernel path takes −exp(A_log) in fp32, its
    plain path in bf16, and lets the block promote to fp32)."""
    jm, params, port, jax_cfg = pair
    cfg, model, family = port(compute_dtype=dtype)
    feats, mask, pos = _bag(2, 2, 32, lengths=(32, 20))
    got = make_eval_step(cfg, model, family)({"feats": _t(feats), "mask": _t(mask), "pos": _t(pos)})["logits"]
    state = MILTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state={}, teacher_params=None,
                          opt_state=(), rng=jax.random.PRNGKey(0), tx=optax.identity(), apply_fn=jm.apply)
    jbatch = {"feats": jnp.asarray(feats), "mask": jnp.asarray(mask), "pos": jnp.asarray(pos)}
    want = np.asarray(j_make_eval_step(jax_cfg(compute_dtype=dtype), jm, "mamba2d")(state, jbatch)["logits"])
    assert got.dtype == torch.float32 and got.shape == (2, 4)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=0.1)
        assert next(model.parameters()).dtype == torch.float32  # the master weights stay fp32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scorer_matches_the_jax_infer_fn(pair, dtype):
    """``Scorer(family="mamba2d")``: a request of two bags of 30 instances
    (one ragged at 17) goes into bucket 32, on the raster grid with no
    coordinates (6 × 6), as ``_infer_fn`` scores the padded batch."""
    jm, params, port, jax_cfg = pair
    cfg, model, family = port(compute_dtype=dtype)
    scorer = Scorer(cfg, model, buckets=BUCKETS, device="cpu", family=family)
    feats, mask, _ = _bag(3, 2, 30, lengths=(30, 17))
    got = scorer.score(feats, mask)["logits"]
    pf = np.concatenate([feats, np.zeros((2, 2, IN_DIM), np.float32)], 1)
    pm = np.concatenate([mask, np.zeros((2, 2), bool)], 1)
    want = np.asarray(_infer_fn(jax_cfg(compute_dtype=dtype), jm, family, {"params": params})(
        jnp.asarray(pf), jnp.asarray(pm))["logits"])
    assert got.dtype == np.float32 and got.shape == (2, 4)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        one = scorer.score(feats[0])["logits"]  # a single [N, D] bag
        np.testing.assert_allclose(one, got[0], rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=0.1)
