"""One rank of a data-parallel world of the port, for tests/test_torch_parallel.py.

    python -m torch.distributed.run --nproc_per_node W tests/torch_dp_worker.py IN.npz OUT.npz

Joins a gloo world from torchrun's environment and runs the cases that
``IN.npz`` lists (its ``spec``, a JSON list) in order, each on a mesh of
its own ``dp`` ranks (every rank makes each mesh; the ranks past it sit
the case out). A case's arrays are ``IN.npz``'s ``<case>/<name>``; rank 0
writes its results to ``OUT.npz`` as ``<case>/<name>``. Kinds:

- ``mhim_step`` / ``generic_step``: one train step of the port's model on
  the given weights (``w/<key>``) and global batch (``batch/<key>``), the
  MHIM step fed the global draws (``draw/mask<i>``, ``draw/merge``); the
  metrics (``m/<key>``), the student (``s/<key>``), the teacher
  (``t/<key>``) and Adam's first moments (``g/<key>``) after it.
  ``dropout`` false patches the port's dropout to the identity. ``control`` keeps one coupling per rank: ``pinv`` the
  pseudo-inverse's initial scale, ``wmean`` the losses' weight sum;
- ``forward_test``: the MHIM logits of the global batch, gathered;
- ``eval``: ``evaluate``'s row over ``make_synthetic_dataset``'s slides;
- ``raises``: ``mhim_mil_torch.main.main(argv)``; the error's type and
  message.

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
from mhim_mil_torch.engine.steps import make_mhim_train_step, make_train_step
from mhim_mil_torch.engine.train_state import create_mhim_state, create_train_state
from mhim_mil_torch.models import build_model, layers
from mhim_mil_torch.ops import nystrom
from mhim_mil_torch.parallel import make_mesh, replicate_tree, shard_batch
from mhim_mil_torch.parallel.mesh import gather_rows


def _group(data, case, prefix):
    p = f"{case}/{prefix}/"
    return {k[len(p):]: data[k] for k in data.files if k.startswith(p)}


def _model(spec, data):
    cfg = load_config([], **spec["cfg"])
    model, family = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _group(data, spec["name"], "w").items()})
    return cfg, model, family


def _step(spec, data, mesh, out):
    cfg, model, family = _model(spec, data)
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
    from mhim_mil_torch.data.synthetic import make_synthetic_dataset
    from mhim_mil_torch.engine.driver import device_eval_batches, evaluate

    cfg, model, family = _model(spec, data)
    slides = make_synthetic_dataset(**spec["slides"])
    with mesh:
        row = evaluate(cfg, model, family, device_eval_batches(cfg, slides, "cpu", mesh), 0, False)
    out["auc"], out["acc"] = np.asarray(row["auc"]), np.asarray(row["acc"])
    out["logits"] = np.asarray(row["_logits"])


def _raises(spec, out):
    from mhim_mil_torch.main import main

    try:
        main(spec["argv"])
    except Exception as e:  # the case records what was raised
        out["type"], out["message"] = np.asarray(type(e).__name__), np.asarray(str(e))
    else:
        out["type"], out["message"] = np.asarray(""), np.asarray("")


CONTROLS = {"pinv": (nystrom, "batch_max"), "wmean": (losses, "batch_sum")}


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
            mesh = make_mesh(spec["dp"], 1)
            if mesh.idle:
                continue
            out = {}
            patched = []
            if not spec.get("dropout", True):
                patched.append((layers.Dropout, "forward", lambda self, x, *a, **k: x))
            if spec.get("control"):
                patched.append((*CONTROLS[spec["control"]], lambda x: x))
            saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
            for obj, name, fn in patched:
                setattr(obj, name, fn)
            try:
                {"mhim_step": _step, "generic_step": _step, "forward_test": _forward_test,
                 "eval": _eval}[spec["kind"]](spec, data, mesh, out)
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
