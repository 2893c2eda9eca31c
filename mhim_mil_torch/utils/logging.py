"""Experiment logging: JSONL metrics stream + optional wandb (a copy of
``mhim_mil_tpu/utils/logging.py``).

The reference logs per-iteration meters and per-epoch metric rows to stdout
and (opt-in) wandb (reference: main.py:456-468, engines/base_engine.py:179-218).
Here the always-on sink is a JSONL file under the run's output dir — greppable,
diffable, no services — and wandb attaches on top when installed and enabled.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, Optional


def git_provenance(auto_commit: bool = False, cwd: Optional[str] = None) -> Dict:
    """Run provenance à la reference ``check_and_commit_changes``
    (reference: utils.py:19-40): record the git SHA and dirty/untracked
    state of the working tree; with ``auto_commit`` additionally commit a
    dirty tree ("Run Auto commit") so every logged run maps to a commit.
    Degrades to ``{}`` outside a git checkout (a tree copied without its
    ``.git``) or without the git CLI. Uses the git CLI directly —
    GitPython is not a dependency of this framework.
    """

    def _git(*args):
        return subprocess.run(
            ("git",) + args, cwd=cwd, capture_output=True, text=True, timeout=30
        )

    try:
        sha = _git("rev-parse", "HEAD")
        if sha.returncode != 0:
            return {}
        status = _git("status", "--porcelain").stdout.splitlines()
        dirty = [l for l in status if not l.startswith("??")]
        untracked = [l for l in status if l.startswith("??")]
        if auto_commit and (dirty or untracked):
            _git("add", "-A")
            _git("commit", "-m", "Run Auto commit")
            # re-read instead of assuming success (commit can fail, e.g. no
            # configured identity) — provenance must stay honest
            sha = _git("rev-parse", "HEAD")
            status = _git("status", "--porcelain").stdout.splitlines()
            dirty = [l for l in status if not l.startswith("??")]
            untracked = [l for l in status if l.startswith("??")]
        return {
            "git_sha": sha.stdout.strip(),
            "git_dirty": bool(dirty),
            "git_untracked": len(untracked),
        }
    except (OSError, subprocess.SubprocessError):
        return {}


class RunLogger:
    def __init__(self, output_path: Optional[str], project: str = "mil_tpu",
                 title: str = "default", use_wandb: bool = False, config: Optional[Dict] = None):
        self.path = None
        self._f = None
        if output_path:
            os.makedirs(output_path, exist_ok=True)
            self.path = os.path.join(output_path, f"{title}_log.jsonl")
            self._f = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=title, config=config or {})
            except Exception as e:  # wandb missing or offline — degrade quietly
                print(f"[logger] wandb unavailable ({e}); JSONL only")

    def log(self, row: Dict, step: Optional[int] = None) -> None:
        rec = {"ts": time.time(), **({"step": step} if step is not None else {}), **row}
        if self._f:
            self._f.write(json.dumps(rec, default=float) + "\n")
            self._f.flush()
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def close(self) -> None:
        if self._f:
            self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
