"""The ConvNeXt classifier trained on synthetic DWI slices made in memory.

Counterpart: ``scripts/train_classify_synthetic.py``, whose data code is
copied here as it is (numpy only), so one seed gives its arrays bit for
bit: 2-channel 64x64 (b1500, ADC) slices of noise, the positives (35 %)
carrying a focal bright-b1500 / dark-ADC lesion, the diffusion-restriction
signature; 160 training slices (seed 3) and 48 validation slices (seed
77). The recipe is the script's ``ClassifierArgs``: tiny, 2-channel stem,
f32, AdamW lr 2e-4, exponentiallr gamma 0.97, batch 16, patience 5, up to
60 epochs, seed 42 (the weights' seed). The gate is the script's: best val
AUC above 0.9 *and* early stopping fired. ``summary.json`` has the script's
fields (its JAX record: ``runs/classify_synthetic/summary.json``, 18
epochs, best val AUC 1.0, on a CPU) plus ``seconds_per_epoch``. This is how
the classifier trains on a machine without h5py or a datasheet: it feeds
the trainer in memory.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.classify_synthetic \\
      --out-dir runs_port/classify_synthetic [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

from ..classify.trainer import ClassifierArgs, ClassifierTrainer

H = W = 64
POS_FRAC = 0.35
TRAIN = dict(n=160, seed=3)
VAL = dict(n=48, seed=77)


class SyntheticDWIDataset:
    """``(x: (2, H, W) float32 [b1500, ADC], y: float32)`` with the sheet
    datasets' ``weights`` and ``batches``."""

    def __init__(self, n: int, pos_frac: float, seed: int):
        rng = np.random.default_rng(seed)
        self.xs, self.labels = [], []
        for _ in range(n):
            label = int(rng.random() < pos_frac)
            b1500 = 0.3 + 0.1 * rng.standard_normal((H, W))
            adc = 1.2 + 0.15 * rng.standard_normal((H, W))
            if label:
                cy, cx = rng.uniform(0.3, 0.7, 2) * H
                rr = rng.uniform(4.0, 7.0)
                yy, xx = np.mgrid[:H, :W].astype(np.float32)
                blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                              / (2 * rr * rr))
                b1500 = b1500 + 0.9 * blob        # restriction: bright b1500
                adc = adc - 0.8 * blob            # ... and dark ADC
            self.xs.append(np.stack([b1500, adc]).astype(np.float32))
            self.labels.append(label)
        self.labels = np.asarray(self.labels)
        neg_weight = float(np.mean(self.labels))
        self.weights = [neg_weight, 1 - neg_weight]

    def __len__(self):
        return len(self.xs)

    def __getitem__(self, i):
        return self.xs[i], np.float32(self.labels[i])

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            chunk = order[start:start + batch_size]
            xs, ys = zip(*(self[int(i)] for i in chunk))
            yield np.stack(xs), np.stack(ys)


def make_datasets() -> tuple:
    """The recipe's (train, val) datasets."""
    return (SyntheticDWIDataset(TRAIN["n"], POS_FRAC, TRAIN["seed"]),
            SyntheticDWIDataset(VAL["n"], POS_FRAC, VAL["seed"]))


def recipe_args(out_dir: str, epochs: int = 60) -> ClassifierArgs:
    """The script's ``ClassifierArgs``; ``epochs`` past the useful horizon
    so that early stopping (patience 5) fires."""
    return ClassifierArgs(out_dir=out_dir, model="tiny", diff=True, lr=2e-4,
                          epochs=epochs, batch_size=16, patience=5, amp=False,
                          scheduler="exponentiallr", gamma=0.97)


def run(out_dir: str, device: str = "cuda") -> dict:
    """Train the recipe into ``out_dir`` and write its ``summary.json``;
    returns the summary (``ok``: the script's gate)."""
    os.makedirs(out_dir, exist_ok=True)
    train_ds, val_ds = make_datasets()
    args = recipe_args(out_dir)
    tr = ClassifierTrainer(args, train_ds, val_ds, device=device)
    t0 = time.time()
    hist = tr.fit()["history"]
    wall = time.time() - t0
    best_auc = max(h["val_auc"] for h in hist)
    stopped_early = len(hist) < args.epochs
    summary = {
        "config": {"H": H, "W": W, "model": args.model, "diff": True,
                   "train_slices": len(train_ds), "val_slices": len(val_ds),
                   "pos_frac": POS_FRAC, "patience": args.patience,
                   "epochs_max": args.epochs},
        "device": str(tr.device),
        "epochs_ran": len(hist),
        "early_stopping_fired": stopped_early,
        "best_val_auc": best_auc,
        "final_val_auc": hist[-1]["val_auc"],
        "final_val_loss": hist[-1]["val_loss"],
        "wall_s": wall,
        "seconds_per_epoch": wall / len(hist),
        "ok": bool(best_auc > 0.9 and stopped_early),
    }
    with open(os.path.join(out_dir, "summary.json"), "w",
              encoding="utf-8") as f:
        json.dump(summary, f, indent=1)
    return summary


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser("ConvNeXt on synthetic DWI slices")
    p.add_argument("--out-dir", default="runs_port/classify_synthetic")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    a = p.parse_args(argv)
    summary = run(a.out_dir, a.device)
    print(json.dumps(summary, indent=1), flush=True)
    print(f"separable AUC (>0.9) with early stop: {summary['ok']}",
          flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
