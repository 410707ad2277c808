"""Early stopping on validation loss.

The port's own copy of
``mri_acl_imagesegmentation_adsp_tpu/train/early_stopping.py:18-58``, the
vendored classification suite's ``pytorchtools.EarlyStopping``: a loss is
an improvement when it is at most the running best minus ``delta`` (the
comparison is inclusive, so an equal loss counts); an improvement calls
``save_fn`` and resets the patience budget, and ``patience`` epochs in a
row without one set ``early_stop``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional


class EarlyStopping:
    """Callable tracker: feed it each epoch's validation loss.

    Attributes:
      early_stop: True once ``patience`` consecutive epochs failed to improve.
      counter: how many non-improving epochs have elapsed since the best.
    """

    def __init__(self, patience: int = 7, verbose: bool = False,
                 delta: float = 0.0,
                 save_fn: Optional[Callable[[], None]] = None,
                 trace_func: Callable = print):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.save_fn = save_fn
        self.trace_func = trace_func
        self.counter = 0
        self.early_stop = False
        self.best_loss = math.inf

    def __call__(self, val_loss: float) -> None:
        if val_loss <= self.best_loss - self.delta:
            self._improved(val_loss)
        else:
            self.counter += 1
            self.trace_func(f"EarlyStopping counter: {self.counter} "
                            f"out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True

    def _improved(self, val_loss: float) -> None:
        if self.verbose:
            self.trace_func(
                f"Validation loss improved ({self.best_loss:.6f} -> "
                f"{val_loss:.6f}); saving checkpoint")
        self.best_loss = val_loss
        self.counter = 0
        if self.save_fn is not None:
            self.save_fn()
