"""The U-Net trained on real fastMRI knee slices, on the port.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.real_panels \\
        --work /data/real_panels [--out real_panels.json] [--device cuda]

Counterpart: ``scripts/train_real_panels.py:40-90``, the JAX package's one
training run on real data (``runs/fastmri_unet_realdata/``):

1. the six real 320x320 knee panels of
   ``tests/goldens/fastmri_real_panels.npz`` (``inputs / 255``) go through
   the port's ``MRIKneePreprocessor.preprocess_volume_images`` (every
   slice kept, 320x320), which runs both mask kernels on a card;
2. the mask gate: each panel's body mask must reach Dice >= 0.99 against
   the committed ``gt_masks`` (the script's :57-62);
3. panels 0-3 are packed as the train volume and 4-5 as the val volume;
4. the launcher's trainer trains at the JAX run's ``args.json``
   (``JAX_ARGS``: unet, resnet34 from scratch, dice_bce, light aug, amp,
   batch 2, lr 1e-3, weight decay 1e-4, 30 epochs, seed 2024).

Prints one JSON line, also written to ``--out``: the panels' mask Dice,
val Dice by epoch, the best val Dice against its bound (JAX's 0.97108 less
``DICE_MARGIN``, 0.01: two val slices and one seed on each side; a TPU run,
so a bound on quality, not a target), seconds, and the card's name and
power limit. The run directory goes under ``--work``.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..data.preprocess import MRIKneePreprocessor
from ..train.trainer import UNet2DArgs, UNet2DTrainer
from ..utils.device import resolve_device
from .corpus_run import card_line, print_line
from .make_corpus import mask_launches

PANELS = (Path(__file__).resolve().parents[2] / "tests" / "goldens"
          / "fastmri_real_panels.npz")
# the trainer settings of runs/fastmri_unet_realdata/args.json, a TPU run;
# the fields it does not name are UNet2DArgs' defaults
JAX_ARGS = dict(epochs=30, batch_size=2, lr=1e-3, weight_decay=1e-4,
                model="unet", encoder="resnet34", encoder_weights="none",
                loss="dice_bce", aug="light", k=1, imagenet_norm=False,
                classes=1, amp=True, seed=2024, logger="csv")
JAX_VAL_DICE = 0.971084713935852       # its summary.json, epoch 30
DICE_MARGIN = 0.01
MASK_DICE_MIN = 0.99
SPLITS = {"train": slice(0, 4), "val": slice(4, 6)}


def mask_dice(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(bool), b.astype(bool)
    return float(2.0 * (a & b).sum() / max(a.sum() + b.sum(), 1))


def panel_packs(device, panels: str | Path = PANELS):
    """The panels through the preprocess chain: ``(tensor (6, 1, 320,
    320) float32, masks (6, 320, 320) uint8, each mask's Dice against the
    committed one)``."""
    with np.load(panels) as z:
        inputs = z["inputs"].astype(np.float32) / 255.0
        gts = z["gt_masks"]
    pre = MRIKneePreprocessor(slice_keep=(0.0, 1.0), out_size=(320, 320),
                              device=resolve_device(device))
    out = pre.preprocess_volume_images(inputs)
    tensor = out["tensor"].cpu().numpy().astype(np.float32)
    masks = out["mask"].cpu().numpy().astype(np.uint8)
    return tensor, masks, [mask_dice(m, g) for m, g in zip(masks, gts)]


def run(work: str, device: str = "cuda",
        panels: str | Path = PANELS) -> Dict:
    """Steps 1-4; returns the JSON line's object. Raises when the mask
    gate fails, before any training."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    before = mask_launches()
    tensor, masks, dice = panel_packs(dev, panels)
    launches = {k: v - before[k] for k, v in mask_launches().items()}
    if min(dice) < MASK_DICE_MIN:
        raise RuntimeError(f"the mask gate failed: panel Dice {dice} "
                           f"against the committed masks (>= "
                           f"{MASK_DICE_MIN} each)")
    lists: Dict[str, str] = {}
    for name, rows in SPLITS.items():
        d = os.path.join(work, "artifacts", f"real_{name}")
        os.makedirs(d, exist_ok=True)
        np.savez_compressed(os.path.join(d, "volume.npz"), img=tensor[rows],
                            msk=masks[rows])
        lists[name] = os.path.join(work, f"{name}.txt")
        with open(lists[name], "w", encoding="utf-8") as f:
            f.write(os.path.join(d, "volume.npz") + "\n")
    preprocess_s = time.perf_counter() - t0
    args = UNet2DArgs(train_list=lists["train"], val_list=lists["val"],
                      out_dir=os.path.join(work, "run"), **JAX_ARGS)
    t1 = time.perf_counter()
    hist: List[dict] = UNet2DTrainer(args, device=dev).run()["history"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t1
    best = max(h["val_dice"] for h in hist)
    bound = JAX_VAL_DICE - DICE_MARGIN
    return {
        "tool": "real_panels", "device": str(dev),
        "mask_dice": dice, "mask_dice_min": MASK_DICE_MIN,
        "mask_gate_met": True, "mask_kernel_launches": launches,
        "train_slices": 4, "val_slices": 2,
        "val_dice_by_epoch": [h["val_dice"] for h in hist],
        "val_loss_by_epoch": [h["val_loss"] for h in hist],
        "best_val_dice": best,
        "best_epoch": max(hist, key=lambda h: h["val_dice"])["epoch"],
        "jax_val_dice": JAX_VAL_DICE, "dice_bound": bound,
        "dice_bound_met": bool(best >= bound),
        "preprocess_s": preprocess_s, "train_s": train_s,
        "run_dir": args.out_dir, "card": card_line(),
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
