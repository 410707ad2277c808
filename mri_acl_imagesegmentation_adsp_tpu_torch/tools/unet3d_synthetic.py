"""The 3-D patch U-Net's quality reference, on the port.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.unet3d_synthetic \\
        --work /data/unet3d [--out unet3d.json] [--device cuda]

Counterpart: ``runs/unet3d_synthetic/``, a 6-epoch TPU run of the JAX
3-D trainer whose settings are its ``best3d.ckpt.args.json`` and whose
DiceCE val loss went 0.082 -> 0.044 (``train_log.csv``):

1. ``tools/make_corpus.py`` packs 16 synthetic 640x368 volumes of 36
   slices, every slice kept (the run's "full slice band"), 320x320;
   the JAX run's volume seeds were not recorded, so this is a corpus like
   its one, not the same one;
2. the launcher's seeded 80/20 split;
3. ``train/trainer3d.py``'s CLI at the run's settings (``JAX_FLAGS``: ROI
   160x160x32, batch 2, channels 32-320, device sampling, amp, lr 1e-3,
   weight decay 1e-4, 4 / 2 patches a volume, 6 epochs, seed 2024).

Prints one JSON line, also written to ``--out``: the port's val loss by
epoch beside JAX's, the best val loss against its bound (at most 1.5x
JAX's best, ``LOSS_FACTOR``, and below the port's own epoch 1: one seed and
another corpus on each side), seconds, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from pathlib import Path
from typing import Dict

import torch

from ..cli import launcher
from ..train import trainer3d
from ..utils.device import resolve_device
from .corpus_run import card_line, print_line
from .make_corpus import make_corpus

CORPUS = {"volumes": 16, "slices": 36, "height": 640, "width": 368}
# best3d.ckpt.args.json of the JAX run (a TPU run), as trainer3d flags
JAX_FLAGS = ["--roi", "160", "160", "32",
             "--channels", "32", "64", "128", "256", "320",
             "--classes", "1", "--batch-size", "2", "--epochs", "6",
             "--lr", "1e-3", "--weight-decay", "1e-4", "--workers", "4",
             "--amp", "--seed", "2024", "--pos-neg-ratio", "1.0",
             "--samples-per-vol-train", "4", "--samples-per-vol-val", "2",
             "--device-sampling"]
# its train_log.csv
JAX_VAL_LOSS = [0.082454, 0.070367, 0.063556, 0.070417, 0.059641, 0.044387]
LOSS_FACTOR = 1.5
SPLIT_SEED = 2024


def read_log(path: str) -> Dict[str, list]:
    """``train_log.csv``'s columns by name, as floats."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return {k: [float(r[k]) for r in rows] for k in rows[0]}


def run(work: str, device: str = "cuda") -> Dict:
    """Steps 1-3; returns the JSON line's object."""
    dev = resolve_device(device)
    packs = os.path.join(work, "packs")
    corpus = make_corpus(packs, **CORPUS, device=dev, slice_keep=(0.0, 1.0))
    lists = Path(work) / "lists"
    train, val = launcher.generate_split(Path(packs), lists, 0.8, SPLIT_SEED)
    out_dir = os.path.join(work, "run3d")
    flags = ["--train-list", str(train), "--val-list", str(val),
             "--out-dir", out_dir, *JAX_FLAGS, "--device", str(dev)]
    t1 = time.perf_counter()
    if trainer3d.main(flags) != 0:
        raise RuntimeError(f"trainer3d {flags} failed")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t1
    log = read_log(os.path.join(out_dir, "train_log.csv"))
    best = min(log["val_loss"])
    bound = LOSS_FACTOR * min(JAX_VAL_LOSS)
    return {
        "tool": "unet3d_synthetic", "device": str(dev), "flags": flags,
        "corpus": corpus,
        "train_volumes": len(Path(train).read_text().split()),
        "val_volumes": len(Path(val).read_text().split()),
        "val_loss_by_epoch": log["val_loss"],
        "train_loss_by_epoch": log["train_loss"],
        "jax_val_loss_by_epoch": JAX_VAL_LOSS,
        "best_val_loss": best, "jax_best_val_loss": min(JAX_VAL_LOSS),
        "loss_bound": bound,
        "loss_bound_met": bool(best <= bound and best < log["val_loss"][0]),
        "train_s": train_s, "run_dir": out_dir, "card": card_line(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True,
                    help="directory for the packs, lists and the run")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    ns = ap.parse_args(argv)
    print_line(run(ns.work, ns.device), ns.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
