"""2-D / 2.5-D U-Net trainer: slice stores -> Engine -> best checkpoint and
run artifacts.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/trainer.py``:
``UNet2DArgs`` (:49-98) with the same fields and defaults, so a JAX run's
``args.json`` replays unchanged, and ``UNet2DTrainer`` (:126-263, :395-432,
:469-633):

- ``args.json`` in the run directory; the train and val stores on the
  device; ``in_ch`` 3 when ``k == 1`` and ``imagenet_norm``, else ``k``;
- AdamW(lr, weight_decay) after a clip at ``max_grad_norm``, the learning
  rate set each epoch by ReduceLROnPlateau(min, 0.5, 3) fed ``val_loss``;
- train batches from a seeded permutation (drop last), validation in order
  at ``batch_size // 2``;
- the best checkpoint by val Dice (one class) or -val_loss, in
  ``best.ckpt`` and ``best.ckpt.args.json``; samples at epoch 1 and every
  5th; ``history.json``, ``summary.json`` and, from the CSV logger,
  ``history_epoch.csv``, ``history_step.csv`` and ``metrics.json``.

Randomness comes from ``args.seed``: the weights from a CPU generator, the
permutations and the augmentation from two generators on the device.
``device`` is an argument of the trainer, not a field of ``UNet2DArgs``.
The JAX package's TPU extensions that have no port yet raise when set away
from their defaults (``check_args``).
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ..data.hbm_loader import SliceStore, epoch_permutation, gather_batch
from ..models.factory import build_unet
from ..models.unet2d import init_weights
from ..utils.device import resolve_device
from ..utils.imagenet import make_input_norm
from . import checkpoint as ckpt_lib
from .engine import Engine
from .loggers import make_logger
from .losses import LossManager
from .optim import make_optimizer
from .schedule import ReduceLROnPlateau


@dataclass
class UNet2DArgs:
    """The JAX package's ``UNet2DArgs``: the reference's fields, then its
    TPU extensions (see ``check_args`` for those the port runs)."""
    # data/model
    train_list: str = ""
    val_list: str = ""
    out_dir: str = "runs/unet2d"
    k: int = 1
    aug: str = "light"                       # none|light|medium|heavy
    model: str = "unet"                      # unet|unetpp
    encoder: str = "resnet34"
    encoder_weights: str = "none"
    classes: int = 1
    imagenet_norm: bool = False

    # train
    batch_size: int = 12
    epochs: int = 40
    lr: float = 1e-3
    weight_decay: float = 1e-4
    workers: int = 4                         # threads reading the packs
    loss: str = "dice_bce"
    amp: bool = False                        # True -> bf16 autocast
    seed: int = 2024

    # logging/save
    logger: str = "csv"                      # noop|csv
    save_val_probs: bool = False

    # misc
    max_grad_norm: float = 5.0

    # --- TPU extensions (defaults preserve reference replay) ---
    data_parallel: int = 1
    store_dtype: str = "float32"             # float32|bfloat16 slice store
    resume: bool = False
    save_resume_every: int = 0
    save_resume_steps: int = 0
    resume_keep: int = 0
    ckpt_async: bool = False
    profile_epochs: int = 0
    store_sharded: bool = False
    multihost: bool = False
    remat: bool = False
    accum_steps: int = 1                     # microbatches per update
    ckpt_backend: str = "msgpack"
    preempt_save: bool = False


# extensions the port does not have yet, with the default that keeps them
# off
_NOT_PORTED = {
    "multihost": False, "store_sharded": False, "remat": False,
    "ckpt_async": False, "ckpt_backend": "msgpack", "resume": False,
    "save_resume_every": 0, "save_resume_steps": 0, "resume_keep": 0,
    "preempt_save": False, "profile_epochs": 0,
}


def check_args(args: UNet2DArgs) -> None:
    """Raise ``ValueError`` naming the flag of any setting the port cannot
    run yet: the TPU extensions away from their defaults,
    ``data_parallel > 1``, pretrained ``encoder_weights``, and a store
    dtype other than float32 / bfloat16."""
    def refuse(name, value, why="is not ported yet"):
        raise ValueError(f"--{name.replace('_', '-')} {value!r} {why}; the "
                         "port trains on one device from a fresh start")
    for name, default in _NOT_PORTED.items():
        if getattr(args, name) != default:
            refuse(name, getattr(args, name))
    if args.data_parallel > 1:
        refuse("data_parallel", args.data_parallel)
    if str(args.encoder_weights).lower() not in ("none", "null"):
        refuse("encoder_weights", args.encoder_weights,
               "(a pretrained encoder, models/torch_import.py) is not "
               "ported yet")
    if args.store_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--store-dtype {args.store_dtype!r}: float32 or "
                         "bfloat16")


class UNet2DTrainer:
    """``UNet2DTrainer(args, device).run()`` trains and writes the run
    directory ``args.out_dir``."""

    def __init__(self, args: UNet2DArgs,
                 device: str | torch.device = "cuda"):
        check_args(args)
        self.args = args
        self.device = resolve_device(device)
        self.out_dir = Path(args.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        with (self.out_dir / "args.json").open("w", encoding="utf-8") as f:
            json.dump(asdict(args), f, indent=2)

        self._build_stores()
        self._build_engine()

        self.logger = make_logger(args.logger, str(self.out_dir))
        self.best_metric = float("-inf")
        self.best_ckpt_path = self.out_dir / "best.ckpt"
        self.best_snapshot: Dict[str, Any] = {}
        self.history: list = []
        self.global_step = 0
        self.scheduler = ReduceLROnPlateau(
            lr=args.lr, mode="min", factor=0.5, patience=3)

    def _build_stores(self) -> None:
        a = self.args
        dt = torch.bfloat16 if a.store_dtype == "bfloat16" else torch.float32
        train_src = SliceStore.from_list(a.train_list, workers=a.workers)
        val_src = SliceStore.from_list(a.val_list, workers=a.workers)
        self.train_store = train_src.to_device(a.k, dt, self.device)
        self.val_store = val_src.to_device(a.k, dt, self.device)

    def _build_engine(self) -> None:
        a = self.args
        in_ch = 3 if (a.k == 1 and a.imagenet_norm) else a.k
        model = build_unet(a.model, a.encoder, "none", in_ch=in_ch,
                           classes=a.classes)
        self.model = init_weights(
            model, torch.Generator().manual_seed(a.seed)).to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), a.lr,
                                        a.weight_decay, a.max_grad_norm)
        self.engine = Engine(
            self.model, LossManager(classes=a.classes, name=a.loss),
            self.optimizer, classes=a.classes, aug=a.aug,
            input_transform=(make_input_norm(True) if a.imagenet_norm
                             else None),
            accum_steps=a.accum_steps, amp=a.amp)
        dev = self.device
        self.perm_gen = torch.Generator(device=dev).manual_seed(a.seed)
        self.aug_gen = torch.Generator(device=dev).manual_seed(a.seed + 1)

    # ------------------------------------------------------------------

    def _metric_key(self, val_loss: float, val_dice: float) -> float:
        return val_dice if self.args.classes == 1 else -val_loss

    def _save_val_probs(self) -> None:
        """``val_preds.npz``: the val store's probabilities and targets."""
        store = self.val_store
        bs = max(1, self.args.batch_size // 2)
        probs, gts = [], []
        for start in range(0, store.num_slices, bs):
            idx = torch.arange(start, min(start + bs, store.num_slices),
                               device=self.device)
            x, y = gather_batch(store, idx)
            probs.append(self.engine.predict_probs(x).cpu().numpy())
            y = y.cpu().numpy()
            gts.append(y[:, None].astype(np.float32)
                       if self.args.classes == 1 else y)
        np.savez_compressed(self.out_dir / "val_preds.npz",
                            probs=np.concatenate(probs, 0),
                            gts=np.concatenate(gts, 0))

    def run(self) -> Dict[str, Any]:
        a = self.args
        t0 = time.time()
        n_train = self.train_store.num_slices
        val_bs = max(1, a.batch_size // 2)

        for ep in range(1, a.epochs + 1):
            perm = epoch_permutation(self.perm_gen, n_train, a.batch_size,
                                     drop_last=True)
            lr_now = self.scheduler.lr
            self.optimizer.lr = lr_now
            # the steps are issued without a read-back; validation's
            # results are the epoch's first sync, and the step losses
            # come back with it
            losses_dev = self.engine.train_steps(self.train_store, perm,
                                                 self.aug_gen)
            val_loss, val_dice, val_iou = self.engine.validate(
                self.val_store, val_bs)
            step_losses = self.engine.check_epoch_losses(
                losses_dev, self.engine.step, a.accum_steps)
            train_loss = float(step_losses.sum() * a.batch_size / n_train)
            self.logger.log_steps(start_step=self.global_step, epoch=ep,
                                  lr=lr_now, losses=step_losses)
            self.global_step += len(step_losses)

            self.scheduler.step(val_loss)
            lr = self.scheduler.lr
            elapsed = time.time() - t0
            print(f"Epoch {ep:03d}/{a.epochs} | "
                  f"train {train_loss:.4f} | val {val_loss:.4f} | "
                  f"dice {val_dice:.4f} | iou {val_iou:.4f} | "
                  f"lr {lr:.2e} | {elapsed:.1f}s")
            self.logger.log_epoch(
                epoch=ep, time_s=elapsed, train_loss=train_loss,
                val_loss=val_loss, val_dice=val_dice, val_iou=val_iou, lr=lr)
            record = {"epoch": ep, "train_loss": train_loss,
                      "val_loss": val_loss, "val_dice": val_dice,
                      "val_iou": val_iou, "lr": lr}
            self.history.append(record)

            metric_key = self._metric_key(val_loss, val_dice)
            if metric_key > self.best_metric:
                self.best_metric = metric_key
                self.best_snapshot = dict(record)
                ckpt_lib.save_best(str(self.best_ckpt_path),
                                   self.model.state_dict(), asdict(a))
                if a.save_val_probs:
                    self._save_val_probs()

            if ep == 1 or ep % 5 == 0:
                self.engine.save_samples(self.val_store, str(self.out_dir),
                                         max_samples=6)

        summary = {
            "best": self.best_snapshot,
            "final": self.history[-1] if self.history else {},
            "best_ckpt": str(self.best_ckpt_path),
            "epochs": int(a.epochs),
        }
        with (self.out_dir / "history.json").open("w", encoding="utf-8") as f:
            json.dump(self.history, f, indent=2)
        with (self.out_dir / "summary.json").open("w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2)
        self.logger.log_meta({
            "best_ckpt": str(self.best_ckpt_path),
            "epochs": a.epochs,
            "batch_size": a.batch_size,
            "lr_init": a.lr,
            "weight_decay": a.weight_decay,
            "scheduler": "ReduceLROnPlateau",
            "model": a.model,
            "encoder": a.encoder,
            "encoder_weights": a.encoder_weights,
            "classes": a.classes,
            "k_2p5d": a.k,
            "imagenet_norm": bool(a.imagenet_norm),
            "aug": a.aug,
            "seed": a.seed,
        })
        self.logger.close()
        print("Done. Best ckpt:", self.best_ckpt_path)
        return {"best_ckpt": str(self.best_ckpt_path),
                "history": self.history, "summary": summary}
