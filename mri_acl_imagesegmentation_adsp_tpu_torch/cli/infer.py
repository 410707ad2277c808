"""Batch segmentation inference over packed volumes, and model loading.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/infer.py``:
``load_model_from_ckpt`` (:32-48), ``main`` (:57-148) and ``_run``
(:238-284). Per volume of the list it writes ``<out-dir>/<volume dir>/
pred_mask.npy`` (and ``probs.npz`` with ``--save-probs``), with
``--metrics`` the volume's Dice, IoU, HD95 and ASSD against the packed mask
(``infer/segment.py:evaluate_volume``), and ``<out-dir>/summary.json``.

Usage:
  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer \\
      --ckpt runs/unet2d/best.ckpt --list lists/val.txt --out-dir preds \\
      [--metrics] [--tta hflip] [--batch-size 16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.hbm_loader import read_list
from ..infer.segment import evaluate_volume, segment_volume_2d, threshold_probs
from ..models.factory import build_unet
from ..train import checkpoint as ckpt_lib
from ..utils.device import f32_on_card, resolve_device
from ..utils.imagenet import make_input_norm


def load_model_from_ckpt(ckpt_path: str, device: str | torch.device = "cuda"):
    """Rebuild the model from ``<ckpt>.args.json``, load its weights onto
    ``device`` in eval mode. Returns ``(model, args)``."""
    dev = resolve_device(device)
    with open(ckpt_path + ".args.json", "r", encoding="utf-8") as f:
        args = json.load(f)
    k = int(args.get("k", 1))
    in_ch = 3 if (k == 1 and args.get("imagenet_norm")) else k
    model = build_unet(args.get("model", "unet"),
                       args.get("encoder", "resnet34"), "none", in_ch=in_ch,
                       classes=int(args.get("classes", 1)))
    model.load_state_dict(ckpt_lib.load_best(ckpt_path))
    return model.to(dev).eval(), args


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "Whole-volume segmentation inference (PyTorch)", allow_abbrev=False,
        epilog="Not ported, so refused as unrecognized arguments: the JAX "
               "CLI's --quant, --qtree, --data-parallel, --ckpt3d and "
               "--spatial-parallel.")
    p.add_argument("--ckpt", required=True,
                   help="best checkpoint (train/checkpoint.py format) with "
                        "its .args.json beside it")
    p.add_argument("--list", dest="list_txt", required=True,
                   help="txt file of volume.npz paths")
    p.add_argument("--out-dir", default="preds")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--metrics", action="store_true",
                   help="compute dice/iou/hd95/assd vs the packed masks")
    p.add_argument("--save-probs", action="store_true")
    p.add_argument("--tta", choices=("none", "hflip"), default="none",
                   help="test-time augmentation: average probabilities "
                        "over the horizontal-flip orbit (2x compute)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model, margs = load_model_from_ckpt(args.ckpt, dev)
    norm = make_input_norm(bool(margs.get("imagenet_norm")))

    def apply_fn(x):
        return model(norm(x))

    with f32_on_card(dev):
        return _run(args, apply_fn, int(margs.get("k", 1)),
                    int(margs.get("classes", 1)), dev)


def _run(args, apply_fn, k: int, classes: int, dev: torch.device) -> int:
    out_root = Path(args.out_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    if args.metrics and classes != 1:
        print("[infer] WARNING: --metrics computes binary Dice/IoU/HD95/"
              "ASSD and is skipped for multiclass checkpoints "
              f"(classes={classes})")
    summary = []
    for path in read_list(args.list_txt):
        with np.load(path) as z:
            vol = z["img"].astype(np.float32)      # (S,1,H,W)
            gt = z["msk"].astype(np.uint8)
        probs = segment_volume_2d(apply_fn, torch.from_numpy(vol).to(dev),
                                  k=k, batch_size=args.batch_size,
                                  classes=classes, tta=args.tta)
        pred = threshold_probs(probs, classes, args.threshold)

        vol_dir = out_root / Path(path).parent.name
        vol_dir.mkdir(parents=True, exist_ok=True)
        np.save(vol_dir / "pred_mask.npy", pred.cpu().numpy())
        if args.save_probs:
            np.savez_compressed(vol_dir / "probs.npz",
                                probs=probs.cpu().numpy())

        entry = {"volume": path, "num_slices": int(vol.shape[0]),
                 "pred_path": str(vol_dir / "pred_mask.npy")}
        if args.metrics and classes == 1:
            entry.update(evaluate_volume(pred, torch.from_numpy(gt).to(dev)))
        summary.append(entry)
        msg = f"[infer] {Path(path).parent.name}: {vol.shape[0]} slices"
        if "dice" in entry:
            msg += f" dice {entry['dice']:.4f} hd95 {entry['hd95']:.2f}"
        print(msg)

    with (out_root / "summary.json").open("w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2)
    if args.metrics and summary and "dice" in summary[0]:
        means = {k: float(np.mean([s[k] for s in summary]))
                 for k in ("dice", "iou", "hd95", "assd")}
        print("[infer] means:", json.dumps(means))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
