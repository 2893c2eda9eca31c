"""One rank of a data- or sequence-parallel world of the port, for
tests/test_torch_parallel.py, tests/test_torch_parallel_zoo.py,
tests/test_torch_sp.py, tests/test_torch_sp_scan.py,
tests/test_torch_sp_zoo.py and tests/test_torch_sp_last.py.

    python -m torch.distributed.run --nproc_per_node W tests/torch_dp_worker.py IN.npz OUT.npz

Joins a gloo world from torchrun's environment and runs the cases that
``IN.npz`` lists (its ``spec``, a JSON list) in order, each on a mesh of
its own ``dp`` × ``sp`` ranks (``sp`` 1 unless the spec says; every rank
makes each mesh; the ranks past it sit the case out). The batches are laid
out by ``shard_batch`` (rows over dp, instances over sp). A case's arrays
are ``IN.npz``'s ``<case>/<name>``; rank 0 writes its results to
``OUT.npz`` as ``<case>/<name>``. Kinds:

- ``mhim_step`` / ``generic_step``: one train step of the port's model on
  the given weights (``w/<key>``) and global batch (``batch/<key>``), the
  MHIM step fed the global draws (``draw/mask<i>``, ``draw/merge``); the
  metrics (``m/<key>``), the student (``s/<key>``), the teacher
  (``t/<key>``) and Adam's first moments (``g/<key>``) after it.
  ``dropout`` false patches the port's dropout to the identity. ``control`` keeps one coupling per rank: ``pinv`` the
  pseudo-inverse's initial scale, ``wmean`` the losses' weight sum,
  ``clam_count`` the count of bags CLAM's instance loss averages over.
  ``attrs`` sets attributes of the model after it is built (CLAM's
  ``subtyping``, DTFD's ``distill``; a dotted name sets a submodule's,
  such as ``layer1.attn.parity``); ``scramble`` names state tensors that the ranks past 0
  overwrite before ``replicate_tree``, which must restore rank 0's;
- ``forward_test``: the MHIM logits of the global batch, gathered;
- ``eval``: ``evaluate``'s row over ``make_synthetic_dataset``'s slides
  (``make_synthetic_survival_dataset``'s with ``survival``): its AUC and
  accuracy or its c-index, and the logits (DSMIL's fused);
- ``raises``: ``mhim_mil_torch.main.main(argv)``; the error's type and
  message;
- ``ops``: one op of the sequence-parallel path (``op``: ``landmark``,
  ``streamed``, ``kernels``, ``materialising`` (with ``parity`` if the
  spec says), ``resconv``, ``ppeg``, ``peg``, ``sattention``: MHIM's
  selfattn module built with ``parity``, its ``cls_feat`` and cls
  attention) on this rank's block of
  the global inputs (``in/<name>``), its outputs and the gradients of
  ``Σ output·cotangent`` for its inputs gathered over the sp row
  (``out/<name>``, ``grad/<name>``), and its parameters' gradients summed
  over the row (``pgrad/<name>``).

- ``scan_ops``: one op of the scan families' sequence-parallel path
  (``op``: ``scan2d``, the plain 2D scan and K5's op on this rank's band
  of grid rows; ``scan1d``, the masked 1D scan on this rank's block, and
  reversed; ``raster``, ``rasterize_band`` with ``coords``, or on the
  row-major grid ``w`` wide when the spec says ``rowmajor``) on the global
  inputs (``in/<name>``): its outputs gathered over the sp row
  (``out/<name>``) and, for the scans, the gradients of
  ``Σ output·cotangent`` for the sharded inputs gathered and for the
  replicated ones summed over the row (``grad/<name>``);
- ``forward``: the model's ``forward(training=False, return_attn=True)``
  (MHIM's ``forward_test``) on this rank's part of the global batch: the
  logits and DSMIL's ``inst_logits_bag``, gathered over dp, and ``attn``
  where the model gives it (``2dmamba``'s, which the model gathers over
  the grid; with ``gather_attn`` the block's, gathered over the sp row);
- ``mesh_ops``: one of the sp row's primitives (``op``: ``pick``,
  ``argmax``, ``amax``) on this rank's block of the global inputs
  (``in/<name>``): ``sp_pick`` of the rows ``idx``, ``sp_argmax`` and the
  top-k of the gathered scores, ``sp_amax``; the outputs (``out/<name>``)
  and, for the pick and the max, the gradient of ``Σ output·cot``
  gathered over the row (``grad/x``).

``control`` also takes ``k1_unmerged`` (K1's blocks not merged over the
sp row), ``loss_every_rank`` (each bag's whole loss paid on every sp
rank: every rank weighs its bags 1 and the weight sum counts each bag
once), ``no_carry`` (the scans' bands and blocks started from zero:
no state carried across ranks), ``local_ties`` (the row max's cotangent
split among this rank's ties only) and ``local_pick`` (DSMIL's critical
instances and CLAM's top-k chosen on each rank's own block, their
features read there), ``local_ids`` (DTFD's pseudo-bags from each rank's
own valid ranks and count) and ``local_regions`` (RRT-MIL's regions cut
from each rank's own block).

Imports torch and the port only.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from mhim_mil_torch.config import load_config
from mhim_mil_torch.engine import losses
from mhim_mil_torch.ops import flash_nystrom
from mhim_mil_torch.engine.steps import make_mhim_train_step, make_train_step
from mhim_mil_torch.engine.train_state import create_mhim_state, create_train_state
from mhim_mil_torch.models import build_model, clam, dsmil, dtfd, layers, rrt
from mhim_mil_torch.ops import nystrom, scan, scan2d
from mhim_mil_torch.parallel import make_mesh, replicate_tree, shard_batch
from mhim_mil_torch.parallel import mesh as pmesh
from mhim_mil_torch.parallel.mesh import gather_rows


def _group(data, case, prefix):
    p = f"{case}/{prefix}/"
    return {k[len(p):]: data[k] for k in data.files if k.startswith(p)}


def _model(spec, data):
    cfg = load_config([], **spec["cfg"])
    model, family = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _group(data, spec["name"], "w").items()})
    for k, v in spec.get("attrs", {}).items():
        owner, _, name = k.rpartition(".")
        setattr(model.get_submodule(owner), name, v)
    return cfg, model, family


def _step(spec, data, mesh, out):
    cfg, model, family = _model(spec, data)
    if mesh.rank:
        for k in spec.get("scramble", ()):
            model.state_dict()[k].fill_(float(mesh.rank))
    batch = shard_batch(mesh, _group(data, spec["name"], "batch"))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    spe = spec["spe"]
    if spec["kind"] == "mhim_step":
        state = create_mhim_state(cfg, model, spe, device="cpu")
        step = make_mhim_train_step(cfg, spe, device="cpu")
        d = _group(data, spec["name"], "draw")
        draws = None
        if d:
            masks = [torch.from_numpy(d[f"mask{i}"]) if f"mask{i}" in d else None for i in range(3)]
            draws = {"mask": masks, "merge": torch.from_numpy(d["merge"])}
        run = lambda: step(state, batch, draws=draws)  # noqa: E731
    else:
        state = create_train_state(cfg, model, spe, device="cpu")
        step = make_train_step(cfg, family, spe, device="cpu")
        run = lambda: step(state, batch)  # noqa: E731
    replicate_tree(mesh, state)
    with mesh:
        metrics = run()
    for k, v in metrics.items():
        out[f"m/{k}"] = np.asarray(float(v))
    for k, v in state.model.state_dict().items():
        out[f"s/{k}"] = v.detach().numpy()
    if state.teacher is not None:
        for k, v in state.teacher.state_dict().items():
            out[f"t/{k}"] = v.detach().numpy()
    for k, p in state.model.named_parameters():
        if "exp_avg" in state.optimizer.opt.state.get(p, {}):
            out[f"g/{k}"] = state.optimizer.opt.state[p]["exp_avg"].numpy()


def _forward_test(spec, data, mesh, out):
    _, model, _ = _model(spec, data)
    batch = shard_batch(mesh, _group(data, spec["name"], "batch"))
    with mesh:
        logits = model.forward_test(torch.from_numpy(np.ascontiguousarray(batch["feats"])),
                                    torch.from_numpy(np.ascontiguousarray(batch["mask"])))["logits"]
        out["logits"] = gather_rows(logits).numpy()


def _eval(spec, data, mesh, out):
    from mhim_mil_torch.data.synthetic import make_synthetic_dataset, make_synthetic_survival_dataset
    from mhim_mil_torch.engine.driver import device_eval_batches, evaluate

    cfg, model, family = _model(spec, data)
    slides = (make_synthetic_survival_dataset if spec.get("survival") else make_synthetic_dataset)(**spec["slides"])
    with mesh:
        row = evaluate(cfg, model, family, device_eval_batches(cfg, slides, "cpu", mesh), 0, False)
    for k in ("auc", "acc", "cindex"):
        if k in row:
            out[k] = np.asarray(row[k])
    out["logits"] = np.asarray(row["_logits"])


def _raises(spec, out):
    from mhim_mil_torch.main import main

    try:
        main(spec["argv"])
    except Exception as e:  # the case records what was raised
        out["type"], out["message"] = np.asarray(type(e).__name__), np.asarray(str(e))
    else:
        out["type"], out["message"] = np.asarray(""), np.asarray("")


def _ops(spec, data, mesh, out):
    from mhim_mil_torch.models.positional import PEG, PPEG
    from mhim_mil_torch.models.transformer import _DepthwiseResConv
    from mhim_mil_torch.ops.nystrom import _landmark_mean, nystrom_attention, nystrom_attention_streamed
    from mhim_mil_torch.parallel.mesh import Seq, sp_gather, sp_sum

    d = {k: torch.from_numpy(v) for k, v in _group(data, spec["name"], "in").items()}
    op, m = spec["op"], spec.get("m", 0)
    n = d["mask"].shape[1]
    seq = Seq.split(n, mesh.sp, mesh.sp_index)
    tok = 2 if op in ("landmark", "kernels", "materialising") else 1  # the token axis of the op's inputs
    mask = d["mask"][:, seq.cols].contiguous()

    def mine(name, dim=tok):
        return d[name].narrow(dim, seq.offset, seq.local).clone().requires_grad_(d[name].is_floating_point())

    owner = float(mesh.sp_index == 0)  # a replicated output's loss, counted once
    module = None
    with mesh:
        if op == "landmark":
            leaves = {"t": mine("t")}
            means, lm_mask = _landmark_mean(leaves["t"], mask, m, seq=seq)
            outs, loss = {"means": (means, None), "lm_mask": (lm_mask, None)}, (means * d["cot"]).sum() * owner
        elif op in ("streamed", "kernels", "materialising"):
            leaves = {k: mine(k) for k in ("q", "k", "v")}
            if op == "streamed":
                o, a = nystrom_attention_streamed(*leaves.values(), mask, m, return_attn=True, chunk=spec["chunk"],
                                                  seq=seq)
            elif op == "kernels":
                o, a = flash_nystrom.flash_nystrom(*leaves.values(), mask, m, seq=seq)
            else:
                o, a = nystrom_attention(*leaves.values(), mask, m, return_attn=True, parity=spec.get("parity", False),
                                         seq=seq)
            outs = {"out": (o, tok), "attn": (a, 2)}
            loss = (o * mine("cot_out")).sum() + (a * mine("cot_attn", 2)).sum()
        elif op == "sattention":
            from mhim_mil_torch.models.baselines import SAttentionBaseline

            module = SAttentionBaseline(d["x"].shape[-1], spec["heads"], use_flash=False, parity=True)
            module.load_state_dict({k[2:]: v for k, v in d.items() if k.startswith("w.")})
            leaves = {"x": mine("x")}
            res = module(leaves["x"], mask, return_attn=True, seq=seq)
            outs = {"cls_feat": (res["cls_feat"], None), "attn": (res["attn"], 2)}
            loss = (res["cls_feat"] * d["cot"]).sum() * owner + (res["attn"] * mine("cot_attn", 2)).sum()
        else:
            if op == "resconv":
                module = _DepthwiseResConv(d["v"].shape[2])
                leaves = {"v": mine("v")}
            else:
                module = (PPEG if op == "ppeg" else PEG)(d["x"].shape[-1])
                leaves = {"x": mine("x")}
            module.load_state_dict({k[2:]: v for k, v in d.items() if k.startswith("w.")})
            o = module(*leaves.values(), seq) if op == "resconv" else module(leaves["x"], mask, seq)
            outs, loss = {"out": (o, 1)}, (o * mine("cot")).sum()
        loss.backward()
        with torch.no_grad():
            for k, (t, dim) in outs.items():
                out[f"out/{k}"] = (t if dim is None else sp_gather(t, seq, dim)).numpy()
            for k, t in leaves.items():
                out[f"grad/{k}"] = sp_gather(t.grad, seq, tok).numpy()
            for k, p in (module.named_parameters() if module is not None else ()):
                out[f"pgrad/{k}"] = sp_sum(p.grad if p.grad is not None else torch.zeros_like(p)).numpy()


def _scan_ops(spec, data, mesh, out):
    from mhim_mil_torch.models.mamba import rasterize_band, rowmajor_coords
    from mhim_mil_torch.ops.scan import selective_scan_1d_sharded, selective_scan_2d_sharded
    from mhim_mil_torch.ops.scan2d import selective_scan_2d_fused_sharded
    from mhim_mil_torch.parallel.mesh import Seq, sp_gather, sp_sum

    d = {k: torch.from_numpy(v) for k, v in _group(data, spec["name"], "in").items()}
    op = spec["op"]
    with mesh:
        if op == "raster":
            n = d["feats"].shape[1]
            seq = Seq.split(n, mesh.sp, mesh.sp_index)
            feats, mask = d["feats"][:, seq.cols], d["mask"][:, seq.cols]
            if spec.get("rowmajor"):
                w = spec["w"]
                h = -(-n // w)
                coords = rowmajor_coords(seq.local, w, start=seq.offset).expand(feats.shape[0], -1, 2)
            else:
                h, w = spec["h"], spec["w"]
                coords = d["coords"][:, seq.cols]
            grid, gmask, rows = rasterize_band(feats, coords, mask, h, w, d["pad"], seq)
            out["out/grid"] = sp_gather(grid, rows).numpy()
            out["out/mask"] = sp_gather(gmask, rows).numpy()
            return
        length = d["x"].shape[1]
        seq = Seq.split(length, mesh.sp, mesh.sp_index)

        def mine(name, flip=False):
            t = d[name][:, seq.cols]
            return (t.flip(1) if flip else t).clone().requires_grad_(d[name].is_floating_point())

        owned = ("x", "delta", "B", "C")
        runs = [("", False)] if op == "scan2d" else [("", False), ("_rev", True)]
        for sfx, flip in runs:
            leaves = {k: mine(k, flip) for k in owned}
            shared = {k: d[k].clone().requires_grad_() for k in ("A", "D")}
            if op == "scan2d":
                y = selective_scan_2d_sharded(leaves["x"], leaves["delta"], shared["A"], leaves["B"], leaves["C"],
                                              shared["D"], seq)
                with torch.no_grad():  # K5's op (its plain version on the CPU) from A_log = log(−A)
                    y_k5 = selective_scan_2d_fused_sharded(*(d[k][:, seq.cols] for k in ("x", "delta")),
                                                           torch.log(-d["A"]),
                                                           *(d[k][:, seq.cols] for k in ("B", "C")), d["D"], seq)
                    out["out/y_fused"] = sp_gather(y_k5, seq).numpy()
            else:
                lseq = seq.reversed() if flip else seq
                mask = d["mask"][:, seq.cols]
                y = selective_scan_1d_sharded(leaves["x"], leaves["delta"], shared["A"], leaves["B"], leaves["C"],
                                              shared["D"], mask.flip(1) if flip else mask, lseq)
            if flip:
                y = y.flip(1)
            (y * d["cot"][:, seq.cols]).sum().backward()
            with torch.no_grad():
                out[f"out/y{sfx}"] = sp_gather(y, seq).numpy()
                for k, t in leaves.items():
                    g = t.grad.flip(1) if flip else t.grad
                    out[f"grad/{k}{sfx}"] = sp_gather(g, seq).numpy()
                for k, t in shared.items():
                    out[f"grad/{k}{sfx}"] = sp_sum(t.grad).numpy()


def _forward(spec, data, mesh, out):
    _, model, family = _model(spec, data)
    batch = shard_batch(mesh, _group(data, spec["name"], "batch"))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    with mesh, torch.no_grad():
        if family in ("mhim", "mhim_pure"):
            res = model.forward_test(batch["feats"], batch["mask"], return_attn=True)
        else:
            extra = (batch["pos"],) if "pos" in batch else ()
            res = model(batch["feats"], batch["mask"], *extra, training=False, return_attn=True)
        for k in ("logits", "inst_logits_bag"):
            if k in res:
                out[k] = gather_rows(res[k]).numpy()
        if "attn" in res:
            attn = res["attn"]
            if spec.get("gather_attn"):
                attn = pmesh.sp_gather(attn, pmesh.seq_layout(attn.shape[-1], attn.device), -1)
            out["attn"] = gather_rows(attn).numpy()


def _mesh_ops(spec, data, mesh, out):
    from mhim_mil_torch.models.clam import top_k_indices
    from mhim_mil_torch.parallel.mesh import Seq, sp_amax, sp_argmax, sp_gather, sp_pick

    d = {k: torch.from_numpy(v) for k, v in _group(data, spec["name"], "in").items()}
    seq = Seq.split(d["x"].shape[1], mesh.sp, mesh.sp_index)
    x = d["x"][:, seq.cols].clone().requires_grad_()
    with mesh:
        if spec["op"] == "argmax":
            out["out/argmax"] = sp_argmax(x.detach(), seq, 1).numpy()
            out["out/topk"] = top_k_indices(sp_gather(x.detach(), seq, 1).transpose(1, 2), spec["k"]).numpy()
            return
        y = sp_pick(x, d["idx"], seq) if spec["op"] == "pick" else sp_amax(x, 1)
        (y * d["cot"]).sum().mul(float(mesh.sp_index == 0)).backward()  # a replicated output's loss, counted once
        out["out/y"] = y.detach().numpy()
        out["grad/x"] = sp_gather(x.grad, seq, 1).numpy()


def _gather_rows(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


_DTFD_IDS, _RRT_ENCODER = dtfd.pseudo_bag_ids, rrt.RRTEncoder.forward


def _row_once(x):
    from mhim_mil_torch.parallel.mesh import active, batch_sum

    return batch_sum(x) / active().sp


CONTROLS = {"pinv": [(nystrom, "batch_max", lambda x: x)], "wmean": [(losses, "batch_sum", lambda x: x)],
            "k1_unmerged": [(flash_nystrom, "merge_pass_a", lambda a, m, s: (a, m, s))],
            "loss_every_rank": [(losses, "owner_weight", lambda: 1.0), (losses, "batch_sum", _row_once)],
            "clam_count": [(clam, "batch_sum", lambda x: x)],
            "local_ties": [(pmesh, "_row_ties", lambda count, group: count)],
            "local_pick": [(dsmil, "sp_argmax", lambda x, seq, dim=1: x.argmax(dim) + seq.offset),
                           (dsmil, "sp_pick", lambda x, idx, seq: _gather_rows(x, idx - seq.offset)),
                           (clam, "sp_gather", lambda x, seq, dim=1: x),
                           (clam, "sp_pick", lambda x, idx, seq: _gather_rows(x, idx))],
            "local_ids": [(dtfd, "pseudo_bag_ids", lambda mask, group, seq=None: _DTFD_IDS(mask, group))],
            "local_regions": [(rrt.RRTEncoder, "forward", lambda self, x, mask, training=False, gen=None, seq=None:
                               _RRT_ENCODER(self, x, mask, training, gen))],
            "no_carry": [(scan, "sp_carry", lambda decay, state, seq: torch.zeros_like(state)),
                         (scan2d, "sp_carry", lambda decay, state, seq: torch.zeros_like(state))]}


def main():
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    data = np.load(sys.argv[1])
    results = {}
    for spec in json.loads(str(data["spec"])):
        if spec["kind"] == "raises":
            out = {}
            _raises(spec, out)
        else:
            mesh = make_mesh(spec["dp"], spec.get("sp", 1))
            if mesh.idle:
                continue
            out = {}
            patched = []
            if not spec.get("dropout", True):
                patched.append((layers.Dropout, "forward", lambda self, x, *a, **k: x))
            if spec.get("control"):
                patched += CONTROLS[spec["control"]]
            saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
            for obj, name, fn in patched:
                setattr(obj, name, fn)
            try:
                {"mhim_step": _step, "generic_step": _step, "forward_test": _forward_test,
                 "eval": _eval, "ops": _ops, "scan_ops": _scan_ops, "mesh_ops": _mesh_ops,
                 "forward": _forward}[spec["kind"]](spec, data, mesh, out)
            finally:
                for obj, name, fn in saved:
                    setattr(obj, name, fn)
        results.update({f"{spec['name']}/{k}": v for k, v in out.items()})
    dist.barrier()
    if rank == 0:
        np.savez(sys.argv[2], **results)
    dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main()
