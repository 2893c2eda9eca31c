"""Whole runs on the CPU with the timed path broken underneath: ``correct``
comes out false for each fault a cell can have (a state left unchanged,
half of the batch left out, an answer altered where it is produced), and
true without one. The cells run on one chip: there is no exchange between
chips to leave out."""

import pytest
import torch

from benchmark import cell, program

CPU = torch.device("cpu")


def _unchanged(orig):
    def train(self, spe, seed):
        state, step = orig(self, spe, seed)
        return state, lambda st, batch: {"loss": torch.zeros(())}
    return train


def _half(orig):
    def train(self, spe, seed):
        state, step = orig(self, spe, seed)

        def half(st, batch):
            b = batch["bag_valid"].shape[0]
            keep = torch.arange(b) < b // 2
            return step(st, dict(batch, bag_valid=batch["bag_valid"] & keep))
        return state, half
    return train


def _altered(orig):
    def scorer(self):
        s = orig(self)
        score = s.score

        def altered(x):
            out = score(x)
            return {"logits": out["logits"] + 1e-2}
        s.score = altered
        return s
    return scorer


@pytest.mark.parametrize("name,fault", [
    ("tiny_mhim_transmil_c16.tiny_train", None), ("tiny_mhim_transmil_c16.tiny_train", "unchanged"),
    ("tiny_mhim_transmil_c16.tiny_train", "half"), ("tiny_transmil_c16.tiny_train", "unchanged"),
    ("tiny_transmil_c16.tiny_train", "half"), ("tiny_mhim_transmil_c16.tiny_serve", None),
    ("tiny_mhim_transmil_c16.tiny_serve", "altered")])
def test_fault_is_not_correct(checkout, monkeypatch, name, fault):
    if fault in ("unchanged", "half"):
        monkeypatch.setattr(program.Program, "train", {"unchanged": _unchanged, "half": _half}[fault](
            program.Program.train))
    elif fault == "altered":
        monkeypatch.setattr(program.Program, "scorer", _altered(program.Program.scorer))
    result = cell.run_cell(name, 2 ** 33 + 5, 0.3, False, CPU, checkout)
    assert result["correct"] is (fault is None), result["checks"]
