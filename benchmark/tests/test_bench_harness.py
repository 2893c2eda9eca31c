"""The harness is driven by data, refuses to run without a card or without
the program, loads nothing of JAX, and writes only where it may."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cell

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[2]


def test_new_files_are_picked_up(checkout):
    """The tiny configurations, mixes, cells, limits and metric are new
    files only; the repository's own files are as they were."""
    before = (REPO / "BENCHMARK.json").read_text()
    for name in ("tiny_mhim_transmil_c16.tiny_train", "tiny_mhim_transmil_c16.tiny_serve"):
        result = cell.run_cell(name, 123, 0.2, True, CPU, checkout)
        assert result["correct"] and result["metrics"]["tiny_steps"]["value"] > 0, result
        assert list(result)[-1] == "checks" and result["device"]["platform"] == "cpu"
    result = cell.run_cell("tiny_transmil_c16.tiny_train", 123, 0.2, False, CPU, checkout)
    assert set(result["metrics"]) == {"train_bags_per_s", "setup_s"}
    assert (REPO / "BENCHMARK.json").read_text() == before


def _run(cwd, env=None, workload="transmil_c16.train_mix"):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(REPO / "benchmark"), str(tmp_path / "benchmark")], check=True)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


FORBIDDEN = ("jax", "jaxlib", "flax", "mhim_mil_tpu")
PROBE = """
import sys, json
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(imports: str):
    p = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_references_import_nothing_of_the_program():
    mods = _top_level("import benchmark.reference.mhim, benchmark.reference.transmil, benchmark.workcounts")
    assert not mods & set(FORBIDDEN) and "mhim_mil_torch" not in mods


def test_a_run_loads_nothing_of_jax(tmp_path):
    """A whole tiny run in a fresh process, checked by whole top-level names."""
    code = ("import torch\nfrom pathlib import Path\nfrom benchmark import cell\nfrom benchmark.tests import tiny\n"
            f"root = tiny.checkout(Path({str(tmp_path)!r}))\n"
            "for w in ('tiny_mhim_transmil_c16.tiny_train', 'tiny_mhim_transmil_c16.tiny_serve'):\n"
            "    assert cell.run_cell(w, 5, 0.2, True, torch.device('cpu'), root)['correct']\n"
            "assert not cell.forbidden_modules(), cell.forbidden_modules()")
    mods = _top_level(code)
    assert not mods & set(FORBIDDEN) and "mhim_mil_torch" in mods


def test_writes_only_in_its_places(tmp_path):
    """A tiny run with HOME, TMPDIR and XDG_CACHE_HOME of its own leaves
    nothing in /dev/shm and writes in the checkout only caches."""
    root = tmp_path / "co"
    home = {k: tmp_path / k for k in ("home", "tmp", "cache")}
    for d in home.values():
        d.mkdir()
    code = ("import torch, sys\nfrom pathlib import Path\nfrom benchmark import cell\nfrom benchmark.tests import tiny\n"
            f"root = tiny.checkout(Path({str(root)!r}).parent / 'made')\n"
            "import json; print(json.dumps(sorted(str(p) for p in root.rglob('*'))))\n"
            "cell.run_cell('tiny_transmil_c16.tiny_train', 5, 0.2, True, torch.device('cpu'), root)\n"
            "print(json.dumps(sorted(str(p) for p in root.rglob('*'))))\n")
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    env = {**os.environ, "HOME": str(home["home"]), "TMPDIR": str(home["tmp"]), "XDG_CACHE_HOME": str(home["cache"]),
           "PYTHONPATH": str(REPO), "PYTHONDONTWRITEBYTECODE": "1"}
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr
    before, after = (set(json.loads(x)) for x in p.stdout.strip().splitlines()[-2:])
    assert after == before
    new_shm = {f for f in (set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()) - shm
               if os.stat(os.path.join("/dev/shm", f)).st_uid == os.getuid()}
    assert not new_shm
    for path in cell.HERE.rglob("*.py"):
        if path.name != "test_bench_harness.py":
            text = path.read_text()
            assert "/dev/shm" not in text and '"/tmp' not in text and "'/tmp" not in text, path


@pytest.mark.cuda
def test_tiny_cells_on_the_card(checkout):
    """The tiny cells through the kernels on a card, each correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in ("tiny_mhim_transmil_c16.tiny_train", "tiny_transmil_c16.tiny_train",
                 "tiny_mhim_transmil_c16.tiny_serve"):
        result = cell.run_cell(name, 9, 0.5, True, torch.device("cuda", 0), checkout)
        assert result["device"]["platform"] == "gpu" and result["metrics"], result
