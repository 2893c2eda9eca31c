"""K5's cluster layout (``ops/scan2d.scan_plan``) on the CPU.

The plan is pure Python: blocks of G channels, runs of R = 3 columns a
thread, P runs a block and a row over a cluster of S blocks. Held here at
every grid that ``chip_smoke.py`` and the card tests launch: the plan
covers a row exactly, S ≤ 8, a block's h within the register budget, one
wave at the BLCA grid counting two blocks an SM on 132 SMs, and G filling
32 bytes of a cell. Then the wrapper's card branch, its launch replaced by
``scan2d_plain`` that asserts the layout the wrapper planned, against JAX's
separable scan and ``pallas_selective_scan_2d`` in interpreter mode (rtol
1e-4, atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mhim_mil_tpu.ops.pallas_scan2d as jps
from mhim_mil_torch.ops import scan2d
from mhim_mil_tpu.ops import scan as jscan

SMS = 132  # an H100 SXM
WIDTHS = (1, 11, 31, 33, 102, 119, 120, 121, 192, 193, 381, 383, 384, 385, 500, 700, 767, 768, 769, 1000,
          1024, 1025, 1100, 1151, 1152)
WIDE = (1153, 1500, 2100, 4200)
ITEMSIZE = {"fp32": 4, "bf16": 2}


def _columns(plan: scan2d.ScanPlan, w: int):
    """Every column a thread of the layout walks, once per (block, run, step)."""
    return [seg * plan.columns + j * plan.run + k
            for seg in range(plan.cluster) for j in range(plan.runs) for k in range(plan.run)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n", scan2d.STATES)
@pytest.mark.parametrize("w", WIDTHS)
def test_plan_covers_the_row_exactly(w, n, dtype):
    """Each column of the row is walked by exactly one thread of a channel;
    the columns past the row fall in the last block only, so no block is
    empty; S ≤ 8 and a block is a whole number of warps of at most 128
    threads (192 of 4 channels, only for rows past 768 columns), each
    keeping R·N ≤ 48 floats of h in registers."""
    plan = scan2d.scan_plan(w, n, ITEMSIZE[dtype])
    assert plan is not None
    cols = _columns(plan, w)
    assert len(cols) == len(set(cols))
    assert sorted(c for c in cols if c < w) == list(range(w))
    assert (plan.cluster - 1) * plan.columns < w <= plan.cluster * plan.columns
    assert 1 <= plan.cluster <= scan2d.MAX_CLUSTER
    limit = 192 if plan.group == 4 and w > 768 else 128
    assert plan.threads % 32 == 0 and plan.threads <= limit
    assert plan.run == scan2d.RUN and plan.run * n <= 48
    # a block's h: G channels x its columns x N states, within the budget of
    # its threads at 48 floats each
    assert plan.group * plan.columns * n <= limit * 48


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("w", WIDTHS + WIDE)
def test_group_fills_a_sector(w, dtype):
    """G·itemsize is 32 bytes, one sector of a cell's channels, where blocks
    of 128 threads over 8 blocks hold the row: up to 384 columns in fp32
    (G 8) and 192 in bf16 (G 16). Wider rows take 8 and then 4 channels a
    block (up to 384 and 768 columns), so that a block of 128 threads holds
    more runs, and then 4 channels in blocks of up to 192 threads (up to
    1,152 columns). Wider rows have no plan: the wide kernel."""
    plan = scan2d.scan_plan(w, 16, ITEMSIZE[dtype])
    sector_cols = {"fp32": 384, "bf16": 192}[dtype]
    if w > 1152:
        assert plan is None
    elif w <= sector_cols:
        assert plan.group * ITEMSIZE[dtype] == 32
    else:
        assert plan.group == (8 if w <= 384 else 4)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_one_wave_at_the_blca_grid(dtype):
    """At the BLCA grid (Bs 1, W 381, ED 256, N 16) every block of the grid
    is resident at once, counting two blocks an SM on 132 SMs: the layout is
    G 8, S 8, 16 runs of 3 columns, 128 threads, 256 blocks, in fp32 and in
    bf16 (a 16-channel bf16 block would need 256 threads, one an SM)."""
    plan = scan2d.scan_plan(381, 16, ITEMSIZE[dtype])
    assert plan.blocks(1, 256) <= 2 * SMS
    assert (plan.group, plan.cluster, plan.runs, plan.run) == (8, 8, 16, 3)
    assert plan.blocks(1, 256) == 256


@pytest.mark.parametrize("bs,ed", [(1, 8), (3, 12), (4, 20), (1, 256), (4, 256)])
def test_blocks_count_masked_channel_groups(bs, ed):
    """ED not a multiple of G rounds the channel groups up (the last group
    masked): Bs · ⌈ED/G⌉ · S blocks."""
    plan = scan2d.scan_plan(102, 16, 4)
    assert plan.blocks(bs, ed) == bs * -(-ed // plan.group) * plan.cluster


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("w", (1, 31, 33, 381, 700, 768, 769, 1000, 1024))
def test_every_row_up_to_1024_columns_has_a_cluster_plan(w, dtype):
    """Every row of at most 1,024 columns (the rows the parent's one-block
    kernel held in registers) runs the cluster kernel at every built state
    size, in blocks of more than 128 threads only past 768 columns."""
    for n in scan2d.STATES:
        plan = scan2d.scan_plan(w, n, ITEMSIZE[dtype])
        assert plan is not None
        assert plan.threads <= 128 or (w > 768 and plan.group == 4)
    assert scan2d.WIDEST == 1152


def test_plan_refuses_an_unbuilt_state_size():
    with pytest.raises(ValueError, match="state size"):
        scan2d.scan_plan(381, 12, 4)


def _scan_inputs(seed, bs, h, w, ed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bs, h, w, ed)).astype(np.float32)
    delta = (np.log1p(np.exp(rng.normal(size=(bs, h, w, ed)))) * 0.1).astype(np.float32)
    a_log = np.log(np.tile(np.arange(1, n + 1, dtype=np.float32), (ed, 1)))
    bc = rng.normal(size=(bs, h, w, 3 + 2 * n)).astype(np.float32)
    D = rng.normal(size=(ed,)).astype(np.float32)
    return x, delta, a_log, bc, D


@pytest.mark.parametrize("bs,h,w,ed,n", [(1, 5, 11, 8, 16), (3, 4, 31, 12, 16), (2, 3, 33, 20, 8),
                                         (1, 3, 40, 8, 4), (1, 2, 50, 8, 2), (1, 2, 400, 4, 16)])
def test_card_branch_matches_jax(monkeypatch, bs, h, w, ed, n):
    """The K5 wrapper's card branch, its launch replaced by scan2d_plain
    that asserts the layout ``scan_plan`` gives the shape covers its row,
    against JAX's separable scan and pallas_selective_scan_2d in
    interpreter mode, rtol 1e-4 atol 1e-5; B and C at offsets 3 and 3 + N
    of one projection."""
    planned = []

    def launch(x, delta, a_log, B, C, D):
        plan = scan2d.scan_plan(x.shape[2], a_log.shape[-1], x.element_size())
        assert (plan.cluster - 1) * plan.columns < x.shape[2] <= plan.cluster * plan.columns
        planned.append(plan)
        return scan2d.scan2d_plain(x, delta, a_log, B, C, D)

    monkeypatch.setattr(scan2d, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(scan2d, "_launch", launch)
    x, delta, a_log, bc, D = _scan_inputs(w * n, bs, h, w, ed, n)
    B, C = bc[..., 3:3 + n], bc[..., 3 + n:]
    j = [jnp.asarray(t) for t in (x, delta, a_log, B, C, D)]
    want = np.asarray(jscan.selective_scan_2d(j[0], j[1], -jnp.exp(j[2]), *j[3:]))
    want_k = np.asarray(jps.pallas_selective_scan_2d(*j, ed_tile=ed, interpret=True))
    t = torch.from_numpy(bc)
    before = scan2d.selective_scan_2d_fused.launches
    with torch.no_grad():
        got = scan2d.selective_scan_2d_fused(torch.from_numpy(x), torch.from_numpy(delta), torch.from_numpy(a_log),
                                             t[..., 3:3 + n], t[..., 3 + n:], torch.from_numpy(D))
    assert scan2d.selective_scan_2d_fused.launches == before + 1
    assert len(planned) == 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_k, rtol=1e-4, atol=1e-5)
