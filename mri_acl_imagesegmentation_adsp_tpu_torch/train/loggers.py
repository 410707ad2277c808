"""Training loggers: CSV files and a no-op sink.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/loggers.py:19-107,
160-211``. A run writes ``history_epoch.csv`` (epoch, time_s, train_loss,
val_loss, val_dice, val_iou, lr), ``history_step.csv`` (global_step, epoch,
lr, train_loss_step) and ``metrics.json``, the reference's run-artifact
layout. The TensorBoard sink is not ported yet, and asking for it raises.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, Sequence


class NoOpLogger:
    """Swallows everything (``--logger noop``)."""

    def log_steps(self, **kw): pass
    def log_epoch(self, **kw): pass
    def log_meta(self, meta): pass
    def close(self): pass


class _CsvSink:
    """One append-only CSV file with a fixed header, written once unless
    the file already has content. Every value is numeric: no quoting."""

    def __init__(self, path: Path, columns: Sequence[str]):
        self.path = path
        if not (path.exists() and path.stat().st_size > 0):
            path.write_text(",".join(columns) + "\n", encoding="utf-8")

    def append_many(self, rows: Iterable[Iterable[Any]]) -> None:
        text = "".join(",".join(str(v) for v in row) + "\n" for row in rows)
        with self.path.open("a", encoding="utf-8") as f:
            f.write(text)


class CSVLoggerAdapter:
    """The CSV run artifacts; ``log_steps`` writes an epoch's step losses
    in one append."""

    _EPOCH_COLS = ("epoch", "time_s", "train_loss", "val_loss",
                   "val_dice", "val_iou", "lr")
    _STEP_COLS = ("global_step", "epoch", "lr", "train_loss_step")

    def __init__(self, out_dir: str):
        root = Path(out_dir)
        root.mkdir(parents=True, exist_ok=True)
        self._epochs = _CsvSink(root / "history_epoch.csv", self._EPOCH_COLS)
        self._steps = _CsvSink(root / "history_step.csv", self._STEP_COLS)
        self._meta_path = root / "metrics.json"

    def log_steps(self, *, start_step: int, epoch: int, lr: float,
                  losses) -> None:
        self._steps.append_many(
            (start_step + i, epoch, lr, float(loss))
            for i, loss in enumerate(losses))

    def log_epoch(self, *, epoch: int, time_s: float, train_loss: float,
                  val_loss: float, val_dice: float, val_iou: float,
                  lr: float) -> None:
        self._epochs.append_many([(epoch, round(time_s, 2), train_loss,
                                   val_loss, val_dice, val_iou, lr)])

    def log_meta(self, meta: Dict[str, Any]) -> None:
        self._meta_path.write_text(json.dumps(meta, indent=2),
                                   encoding="utf-8")

    def close(self):
        pass  # each append opens and closes its file


def make_logger(kind: str, out_dir: str):
    """``noop`` or ``csv``; ``tb`` and ``csv+tb`` raise until the
    TensorBoard sink is ported."""
    parts = [p for p in kind.replace(",", "+").split("+") if p]
    if "tb" in parts:
        raise NotImplementedError(
            "the TensorBoard logger (train/loggers.py TensorBoardLogger) is "
            "not ported yet; use --logger csv or noop")
    for p in parts:
        if p not in ("csv", "noop"):
            raise ValueError(f"unknown logger kind {p!r}")
    if "csv" in parts:
        return CSVLoggerAdapter(out_dir)
    return NoOpLogger()
