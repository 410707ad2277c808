"""The main path end to end on the synthetic corpus, in one command.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.corpus_run \\
        --bar b8 --work /data/corpus [--volumes 125] \\
        [--out corpus_b8.json] [--device cuda]

1. ``tools/make_corpus.py`` packs the bar's corpus into ``<work>/packs``
   (resumable: a second bar of the same corpus reuses the packs);
2. the launcher splits it (its seeded 80/20 split) and trains at one of the
   JAX runs' settings (``BARS``): ``b8`` is
   ``runs/corpus_scale_b8/args.json`` (unet, resnet34, dice_bce, aug
   light, amp, bf16 store, batch 8, lr 1e-3, 2 epochs), ``b128`` the
   ``tuned-v5e`` preset of ``runs/corpus_scale/`` (batch 128, lr 4e-3, 4
   epochs, an async snapshot every 30 steps, 2 kept), both on 125
   volumes of 112 368x320 slices; ``synthetic16`` is
   ``runs/fastmri_unet_synthetic/`` (its README's command: f32 store,
   batch 8, lr 1e-3, 15 epochs) on 16 volumes of 36 640x368 slices, a
   corpus like the JAX run's, not the same one (its volume seeds were not
   recorded); the train steps of each epoch are timed with the card
   synchronized after them;
3. ``cli.infer --metrics`` on the val list (Dice, IoU, HD95, ASSD);
4. ``cli.quantize`` of the best checkpoint, then ``cli.infer --qtree``
   (int8) and ``--quant folded`` with ``--metrics``.

Prints one JSON line, also written to ``--out``: val Dice and IoU by
epoch, the best val Dice against its bound (the JAX run's minus
``DICE_MARGIN``; a TPU run, so a bound on quality, not a target), HD95 and
ASSD, int8 and folded Dice, seconds per epoch and of its train steps,
``train_slices_per_sec``, the corpus's seconds, and the card's name and
power limit. The packs hold each volume's tensor twice (``tensor.pt`` and
``volume.npz``): put ``--work`` outside the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from ..cli import infer, launcher, quantize
from .make_corpus import make_corpus

# the JAX runs' launcher settings, corpus and best val Dice (TPU runs,
# runs/corpus_scale_b8/, runs/corpus_scale/, runs/fastmri_unet_synthetic/)
CORPUS = {"volumes": 125, "slices": 112, "height": 368, "width": 320}
BARS = {
    "b8": {"flags": ["--epochs", "2", "--batch-size", "8", "--lr", "1e-3"],
           "jax_val_dice": 0.9933529496192932, "corpus": CORPUS},
    "b128": {"flags": ["--preset", "tuned-v5e", "--epochs", "4",
                       "--save-resume-steps", "30", "--resume-keep", "2",
                       "--ckpt-async"],
             "jax_val_dice": 0.9935413599014282, "corpus": CORPUS},
    "synthetic16": {"flags": ["--epochs", "15", "--batch-size", "8",
                              "--lr", "1e-3", "--store-dtype", "float32"],
                    "jax_val_dice": 0.9942474365234375,
                    "corpus": {"volumes": 16, "slices": 36, "height": 640,
                               "width": 368}},
}
COMMON_FLAGS = ["--model", "unet", "--encoder", "resnet34",
                "--encoder-weights", "none", "--loss", "dice_bce",
                "--aug", "light", "--amp", "--store-dtype", "bfloat16",
                "--seed", "2024", "--logger", "csv"]
DICE_MARGIN = 0.003


def card_line() -> str:
    """``nvidia-smi``'s name and power limit, or "not measured"."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def print_line(obj: Dict, out: str | None = None) -> None:
    """Print ``obj`` as one JSON line and, given ``out``, write it there."""
    line = json.dumps(obj)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line, flush=True)


def _infer_means(flags: List[str]) -> Dict[str, float]:
    out_dir = flags[flags.index("--out-dir") + 1]
    if infer.main(flags) != 0:
        raise RuntimeError(f"cli.infer {flags} failed")
    with open(os.path.join(out_dir, "summary.json"), encoding="utf-8") as f:
        summary = json.load(f)
    means = {k: float(np.mean([e[k] for e in summary]))
             for k in ("dice", "iou", "hd95", "assd")}
    if not summary or not all(np.isfinite(v) for v in means.values()):
        raise RuntimeError(f"cli.infer {flags}: {summary}")
    return {**means, "volumes": len(summary)}


def run(bar: str, work: str, volumes: int | None = None,
        device: str = "cuda", slices: int | None = None,
        epochs: int | None = None, quantized: bool = True) -> Dict:
    """Steps 1-4 for ``bar``; returns the JSON line's object. ``volumes``,
    ``slices`` and ``epochs`` override the bar's; without ``quantized``
    step 4 is left out."""
    dev = torch.device(device)
    shape = BARS[bar]["corpus"]
    volumes = shape["volumes"] if volumes is None else volumes
    packs = os.path.join(work, "packs")
    corpus = make_corpus(packs, volumes=volumes,
                         slices=shape["slices"] if slices is None else slices,
                         height=shape["height"], width=shape["width"],
                         device=dev)
    lists = os.path.join(work, "lists")
    run_dir = os.path.join(work, f"run_{bar}")
    flags = ["--skip-preprocess", "--artifact-dir", packs, "--list-dir",
             lists, "--out-dir", run_dir, *COMMON_FLAGS,
             *BARS[bar]["flags"], "--device", str(dev)]
    if epochs is not None:
        flags += ["--epochs", str(epochs)]
    if launcher.main(flags + ["--skip-train"]) != 0:
        raise RuntimeError("the launcher's split failed")
    parser = launcher.build_parser()
    ns = launcher.apply_preset(parser, parser.parse_args(flags), flags)
    trainer = launcher.build_trainer(os.path.join(lists, "train.txt"),
                                     os.path.join(lists, "val.txt"),
                                     run_dir, ns)
    steps_s: List[float] = []
    real = trainer.engine.train_steps

    def timed(store, perm, gen):
        t1 = time.perf_counter()
        out = real(store, perm, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        steps_s.append(time.perf_counter() - t1)
        return out
    trainer.engine.train_steps = timed
    t1 = time.perf_counter()
    result = trainer.run()
    train_s = time.perf_counter() - t1
    hist = result["history"]
    n_train = trainer.train_store.num_slices
    step_slices = n_train - n_train % ns.batch_size
    with open(os.path.join(run_dir, "history_epoch.csv"),
              encoding="utf-8") as f:
        wall = [float(r.split(",")[1]) for r in f.read().split()[1:]]
    epoch_s = list(np.diff([0.0] + wall))

    best = os.path.join(run_dir, "best.ckpt")
    val = os.path.join(lists, "val.txt")
    common = ["--list", val, "--metrics", "--device", str(dev)]
    t1 = time.perf_counter()
    metrics = _infer_means(["--ckpt", best, "--out-dir",
                            os.path.join(work, f"preds_{bar}"), *common])
    metrics["seconds"] = time.perf_counter() - t1
    int8 = folded = None
    if quantized:
        q = os.path.join(work, f"quant_{bar}.npz")
        if quantize.main(["--ckpt", best, "--list", val, "--out", q,
                          "--device", str(dev)]) != 0:
            raise RuntimeError("cli.quantize failed")
        int8 = _infer_means(["--qtree", q, "--out-dir",
                             os.path.join(work, f"preds_{bar}_int8"),
                             *common])
        folded = _infer_means(["--ckpt", best, "--quant", "folded",
                               "--out-dir",
                               os.path.join(work, f"preds_{bar}_folded"),
                               *common])
    best_dice = max(h["val_dice"] for h in hist)
    bound = BARS[bar]["jax_val_dice"] - DICE_MARGIN
    return {
        "bar": bar, "flags": flags, "volumes": volumes,
        "run_dir": run_dir, "lists": lists,
        "train_slices": n_train, "val_volumes": metrics["volumes"],
        "val_dice_by_epoch": [h["val_dice"] for h in hist],
        "val_iou_by_epoch": [h["val_iou"] for h in hist],
        "val_loss_by_epoch": [h["val_loss"] for h in hist],
        "best_val_dice": best_dice, "jax_val_dice": BARS[bar][
            "jax_val_dice"], "dice_bound": bound,
        "dice_bound_met": bool(best_dice >= bound),
        "infer_metrics": metrics, "int8": int8, "folded": folded,
        "epoch_s": epoch_s, "train_steps_s": steps_s,
        "train_slices_per_sec": [step_slices / s for s in steps_s],
        "train_s": train_s, "corpus": corpus, "card": card_line(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bar", choices=sorted(BARS), required=True)
    ap.add_argument("--work", required=True,
                    help="directory for the packs, lists and runs")
    ap.add_argument("--volumes", type=int,
                    help="default: the bar's (125, synthetic16 16)")
    ap.add_argument("--slices", type=int,
                    help="default: the bar's (112, synthetic16 36)")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    print_line(run(ns.bar, ns.work, ns.volumes, ns.device, ns.slices),
               ns.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
