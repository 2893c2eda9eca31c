"""Early stopping on a monitored quantity (reference: utils.py:229-294; a
copy of ``mhim_mil_tpu/utils/early_stopping.py``).

The driver feeds the NEGATIVE task metric (-AUC / -acc / -c-index) exactly
like the reference validate path (engines/metrics.py:196-204); validation
loss is an opt-in alternative (``--early_stop_on loss``).

Patience counter with an earliest-stop epoch; serialisable for crash-resume.
Tie semantics match the reference: a score EQUAL to the best resets the
patience counter (reference utils.py:258-267 — only ``score < best_score``
increments), which matters for plateauing metrics like AUC.
"""

from __future__ import annotations

import math


class EarlyStopping:
    def __init__(self, patience: int = 20, stop_epoch: int = 50, save_best_model_stage: float = 0.0):
        self.patience = patience
        self.stop_epoch = stop_epoch
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.val_loss_min = math.inf
        self.save_best_model_stage = save_best_model_stage

    def __call__(self, epoch: int, val_loss: float) -> bool:
        score = -val_loss if epoch >= self.save_best_model_stage else 0.0
        if self.best_score is None or score >= self.best_score:
            self.best_score = score
            self.val_loss_min = min(self.val_loss_min, val_loss)
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience and epoch > self.stop_epoch:
                self.early_stop = True
        return self.early_stop

    def state_dict(self):
        return {
            "patience": self.patience,
            "stop_epoch": self.stop_epoch,
            "counter": self.counter,
            "best_score": self.best_score,
            "early_stop": self.early_stop,
            "val_loss_min": self.val_loss_min,
        }

    def load_state_dict(self, d):
        for k, v in d.items():
            setattr(self, k, v)
