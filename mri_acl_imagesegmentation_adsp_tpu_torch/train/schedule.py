"""Learning-rate schedule: a host-side state machine stepped once per epoch.

The port's own copy of
``mri_acl_imagesegmentation_adsp_tpu/train/schedule.py:15-67``:
``torch.optim.lr_scheduler.ReduceLROnPlateau`` as the reference configures
it (mode "min", factor 0.5, patience 3, relative threshold 1e-4, cooldown
0, min_lr 0), on a plain ``lr`` value rather than an optimizer, with
``state_dict`` / ``load_state_dict``."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ReduceLROnPlateau:
    lr: float
    mode: str = "min"
    factor: float = 0.5
    patience: int = 3
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_lr: float = 0.0

    best: float = field(default=None, init=False)
    num_bad_epochs: int = field(default=0, init=False)
    cooldown_counter: int = field(default=0, init=False)

    def _is_better(self, a: float) -> bool:
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            if self.mode == "min":
                return a < self.best * (1.0 - self.threshold)
            return a > self.best * (1.0 + self.threshold)
        if self.mode == "min":
            return a < self.best - self.threshold
        return a > self.best + self.threshold

    def step(self, metric: float) -> float:
        """Feed this epoch's metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
        self.cooldown_counter = d["cooldown_counter"]
