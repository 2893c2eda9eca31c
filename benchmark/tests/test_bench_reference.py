"""The plain references against the program at small widths on the CPU,
and the control (the reference with fp8 operands) failing the cells' limits."""

import json

import pytest
import torch

from benchmark import calibrate, cell, traffic

CPU = torch.device("cpu")
TRAIN = ("tiny_mhim_transmil_c16.tiny_train", "tiny_transmil_c16.tiny_train")


def _cell(root, name):
    man = cell.manifest(root)
    wl = next(c for c in man["workloads"] if c["name"] == name)
    conf = cell.load_json(root / next(c for c in man["configs"] if c["name"] == wl["config"])["file"])
    return conf, traffic.load(wl["traffic"], root / "benchmark" / "traffic")


@pytest.mark.parametrize("name", TRAIN)
def test_train_reference_follows_the_program(checkout, name):
    conf, mix = _cell(checkout, name)
    rows, _ = calibrate.train_readings(conf, mix, 7, CPU, True)
    numbers = rows[0][1]
    assert numbers["loss"] < 1e-5 and numbers["grad1"] < 1e-5 and numbers["change3"] < 1e-4, numbers
    if "teacher3" in numbers:
        assert numbers["teacher3"] < 1e-4 and numbers["global_q3"] < 1e-5 and numbers["keep"] == 0.0, numbers


def test_serve_reference_follows_the_program(checkout):
    conf, mix = _cell(checkout, "tiny_mhim_transmil_c16.tiny_serve")
    rows, _ = calibrate.serve_readings(conf, mix, 7, CPU, True, 0.3)
    assert rows[0][1]["logits"] < 1e-5


@pytest.mark.parametrize("name,real", [("tiny_mhim_transmil_c16.tiny_long", "mhim_transmil_c16.train_mix"),
                                       ("tiny_transmil_c16.tiny_train", "transmil_c16.train_mix"),
                                       ("tiny_mhim_transmil_c16.tiny_serve", "mhim_transmil_c16.serve_cohort")])
def test_control_fails_the_limits(checkout, name, real):
    """The reference computed with fp8 operands, in the program's place,
    fails at least one of the real cell's limits."""
    conf, mix = _cell(checkout, name)
    limits = json.loads((cell.HERE / "limits" / f"{real}.json").read_text())
    if mix["mode"] == "train":
        rows, _ = calibrate.train_readings(conf, mix, 8, CPU, False)
    else:
        rows, _ = calibrate.serve_readings(conf, mix, 8, CPU, False, 0.3)
    numbers = dict(rows)["control"]
    checks = cell.compare.judge(numbers, limits)
    assert not all(c["ok"] for c in checks.values()), checks
