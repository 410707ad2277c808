"""Training loggers: CSV files, TensorBoard event files and a no-op sink.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/loggers.py``
(:19-211). The CSV sink writes ``history_epoch.csv`` (epoch, time_s,
train_loss, val_loss, val_dice, val_iou, lr), ``history_step.csv``
(global_step, epoch, lr, train_loss_step) and ``metrics.json``, the
reference's run-artifact layout. The TensorBoard sink writes event files
under ``<out>/tb``: scalars under ``train/`` and ``val/``, the run's meta
as text, validation probability images. ``--logger csv+tb`` fans out to
both. Where ``torch.utils.tensorboard`` cannot be imported, ``tb`` warns
and writes the CSV files instead, as the JAX package's ``make_logger``
does.
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


class TensorBoardLogger:
    """Event files under ``<out_dir>/tb`` (``torch.utils.tensorboard``)."""

    def __init__(self, out_dir: str):
        from torch.utils.tensorboard import SummaryWriter
        self._w = SummaryWriter(log_dir=str(Path(out_dir) / "tb"))

    def log_steps(self, *, start_step: int, epoch: int, lr: float,
                  losses) -> None:
        for i, loss in enumerate(losses):
            self._w.add_scalar("train/loss_step", float(loss), start_step + i)

    def log_epoch(self, *, epoch: int, time_s: float, train_loss: float,
                  val_loss: float, val_dice: float, val_iou: float,
                  lr: float) -> None:
        for tag, v in (("train/loss", train_loss), ("val/loss", val_loss),
                       ("val/dice", val_dice), ("val/iou", val_iou),
                       ("train/lr", lr), ("time/epoch_s", time_s)):
            self._w.add_scalar(tag, v, epoch)

    def log_meta(self, meta: Dict[str, Any]) -> None:
        self._w.add_text("meta", json.dumps(meta, indent=2, default=str))

    def log_images(self, tag: str, images, step: int) -> None:
        """``images``: ``(N, H, W)`` floats in [0, 1]."""
        import numpy as np
        arr = np.asarray(images)
        for i in range(arr.shape[0]):
            self._w.add_image(f"{tag}/{i}", arr[i][None], step)

    def close(self):
        self._w.close()


class MultiLogger:
    """Every logging call to each of several sinks (``csv+tb``)."""

    def __init__(self, *loggers):
        self.loggers = loggers

    def _fan(self, name, *a, **kw):
        for lg in self.loggers:
            fn = getattr(lg, name, None)
            if fn is not None:
                fn(*a, **kw)

    def log_steps(self, **kw): self._fan("log_steps", **kw)
    def log_epoch(self, **kw): self._fan("log_epoch", **kw)
    def log_meta(self, meta): self._fan("log_meta", meta)
    def log_images(self, tag, images, step):
        self._fan("log_images", tag, images, step)
    def close(self): self._fan("close")


def make_logger(kind: str, out_dir: str):
    """``noop``, ``csv``, ``tb`` or ``csv+tb`` (``,`` also separates)."""
    parts = [p for p in kind.replace(",", "+").split("+") if p]
    sinks = []
    for p in parts:
        if p == "csv":
            sinks.append(CSVLoggerAdapter(out_dir))
        elif p == "tb":
            try:
                sinks.append(TensorBoardLogger(out_dir))
            except ImportError as exc:
                # the JAX package's rule: keep the run, log to CSV instead
                import warnings
                warnings.warn(f"TensorBoard logger unavailable ({exc}); "
                              "falling back to CSV for this sink")
                if "csv" not in parts:   # no doubled CSV rows on csv+tb
                    sinks.append(CSVLoggerAdapter(out_dir))
        elif p != "noop":
            raise ValueError(f"unknown logger kind {p!r}")
    if not sinks:
        return NoOpLogger()
    if len(sinks) == 1:
        return sinks[0]
    return MultiLogger(*sinks)
