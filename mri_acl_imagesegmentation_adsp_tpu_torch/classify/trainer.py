"""ConvNeXt classification trainer (T2 / DWI).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/classify/trainer.py``
(the vendored ``train_t2.py``, ``train_dwi.py`` and
``model/extra_model_utils.py``):

* ``roc_auc`` (:38-62): the rank statistic with ties averaged, a numpy
  copy;
* ``ClassifierArgs`` (:66-87): the same fields and defaults;
* ``ClassifierTrainer`` (:90-334): an epoch of training and one of
  validation with the class-weighted BCE (each split weighed by its own
  weights) and ROC-AUC; optax's optimizers (``train/optim.py``: AdamW,
  the AMSGrad chain, SGD with momentum), the learning rate set each epoch
  to ``lr * sched(ep - 1) * plateau.lr`` (the primary scheduler of
  ``classify/trainer_utils.py`` times the always-on secondary
  ReduceLROnPlateau, factor 0.5, patience 2, on the val loss);
  EarlyStopping on the val loss saving the best checkpoint
  (``classifier_best.ckpt`` + ``.args.json``, the port's format);
  ``history.json``; resume snapshots in the port's format, preemption,
  and ``evaluate`` (the vendored ``test.py``), which rebuilds the model
  from the checkpoint's ``.args.json`` when its configuration differs.

The model (``models/convnext.py``) is built, and its weights drawn from a
CPU generator seeded with ``args.seed``, when the trainer is made: the
classifier global-pools, so nothing about it waits for the first batch.
It computes in bf16 under ``amp`` and in f32 otherwise, TF32 off on a card
(``utils/device.py:f32_on_card``). Batches are NCHW. The losses and logits
stay on the device until the epoch ends.

``data_parallel`` (JAX :83, :118-133): each rank of a ``parallel.DataGroup``
(``group``; ``cli/train_classify.py`` spawns them) reads the same batches,
runs its contiguous share of each batch's rows and averages its gradients
and loss with the others' in one all-reduce (the ConvNeXt's LayerNorm is
per sample and the loss a mean, so the average is the global batch's); a
batch the world does not divide runs whole on every rank. The logits are
gathered on every rank, so the ROC-AUC and the validation loss are the
whole split's, as one rank computes them. Rank 0 alone writes the run
directory.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, fields as dc_fields
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.convnext import ConvNeXt, init_convnext_weights
from ..train import checkpoint as ckpt_lib
from ..train.early_stopping import EarlyStopping
from ..train.optim import ClippedAdamW, SGDMomentum
from ..train.schedule import ReduceLROnPlateau
from ..train.trainer import _preempt_signals
from ..parallel.mesh import (
    DataGroup, any_rank, average_flat, barrier, gather_rows, row_slice)
from ..utils.device import f32_on_card, resolve_device, upload
from .dataset import weighted_bce_loss
from .trainer_utils import make_scheduler


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve (rank statistic, ties averaged): sklearn's
    ``roc_auc_score`` on binary labels."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes present")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    sorted_scores = scores[order]
    ranks[order] = np.arange(1, len(scores) + 1, dtype=np.float64)
    i = 0
    while i < len(sorted_scores):              # average ranks over ties
        j = i
        while (j + 1 < len(sorted_scores)
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


@dataclass
class ClassifierArgs:
    out_dir: str = "runs/classifier"
    model: str = "tiny"            # tiny | convnext
    diff: bool = False             # 2-channel (b1500, ADC) stem
    optimizer: str = "adam"        # sgd | adam
    amsgrad: bool = False          # adam -> the AMSGrad chain
    scheduler: str = "exponentiallr"  # exponentiallr|multistep|cosine|plat|none
    lr: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    gamma: float = 0.95
    lr_decay_steps: tuple = (10, 20)
    epochs: int = 30
    batch_size: int = 8
    patience: int = 7
    seed: int = 42
    amp: bool = True
    data_parallel: int = 1         # ranks (their group is the trainer's)
    resume_keep: int = 0           # keep newest N resume snapshots (0 = all)


def build_classifier(a) -> ConvNeXt:
    """The one ConvNeXt construction path, shared by training and serving:
    ``a`` is a :class:`ClassifierArgs` or a saved args dict
    (``classifier_best.ckpt.args.json``; missing fields take the
    defaults)."""
    if not isinstance(a, ClassifierArgs):
        known = {f.name for f in dc_fields(ClassifierArgs)}
        a = ClassifierArgs(**{k: v for k, v in dict(a).items() if k in known})
    return ConvNeXt(variant=a.model, in_chans=2 if a.diff else 1,
                    num_classes=1,
                    dtype=torch.bfloat16 if a.amp else torch.float32)


def make_classifier_optimizer(args: ClassifierArgs, params):
    """optax's optimizer of the JAX trainer's ``_make_tx``: ``sgd`` with
    momentum, else AdamW, as the AMSGrad chain under ``amsgrad``."""
    if args.optimizer == "sgd":
        return SGDMomentum(params, args.lr, args.momentum)
    return ClippedAdamW(params, args.lr, args.weight_decay, 0.0,
                        amsgrad=bool(args.amsgrad))


class ClassifierTrainer:
    """``ClassifierTrainer(args, train_ds, val_ds, device=...).fit()``; a
    dataset has ``weights``, ``__len__`` and ``batches(batch_size,
    shuffle, seed)`` yielding NCHW float32 ``x`` and labels ``y``."""

    def __init__(self, args: ClassifierArgs, train_ds, val_ds,
                 device: str | torch.device = "cuda",
                 group: Optional[DataGroup] = None):
        world = group.world if group is not None else 1
        if int(getattr(args, "data_parallel", 1) or 1) != world:
            raise ValueError(
                f"data_parallel {args.data_parallel} on {world} rank(s): "
                "start the ranks with cli.train_classify --data-parallel "
                "(or parallel.spawn, passing each rank's group)")
        self.args = args
        self.group = group
        self.primary = group is None or group.primary
        self.device = (group.device if group is not None
                       else resolve_device(device))
        os.makedirs(args.out_dir, exist_ok=True)
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.model = init_convnext_weights(
            build_classifier(args),
            torch.Generator().manual_seed(int(args.seed))).to(self.device)
        self.optimizer = make_classifier_optimizer(
            args, self.model.parameters())
        self.weights = tuple(train_ds.weights)
        self.sched = make_scheduler(args)
        # a multiplicative factor: the secondary scheduler
        self.plateau = ReduceLROnPlateau(lr=1.0, factor=0.5, patience=2)
        self.epoch = 0
        self.best_path = os.path.join(args.out_dir, "classifier_best.ckpt")
        self.history: List[Dict[str, Any]] = []
        self.early = EarlyStopping(patience=args.patience,
                                   save_fn=self._save_best,
                                   trace_func=lambda *a, **k: None)
        self._preempt = False

    # ------------------------------------------------------------------

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> tuple:
        """One optimizer step on a device batch; returns the loss and the
        logits from before the update, on the device (under a group: of the
        global batch, this rank running its rows)."""
        self.model.train()
        b = int(x.shape[0])
        rows = row_slice(b, self.group)
        if rows is not None:
            x, y = x[rows], y[rows]
        with f32_on_card(self.device):
            logits = self.model(x)
            loss = weighted_bce_loss(logits, y, self.weights)
            grads = torch.autograd.grad(loss, self.optimizer.params)
        loss = loss.detach()
        if self.group is not None:
            *grads, loss = average_flat(list(grads) + [loss], self.group)
        self.optimizer.step(grads)
        return loss, gather_rows(logits.detach(), b, self.group)

    @torch.no_grad()
    def eval_step(self, x: torch.Tensor, y: torch.Tensor,
                  weights: tuple) -> tuple:
        self.model.eval()
        rows = row_slice(int(x.shape[0]), self.group)
        with f32_on_card(self.device):
            logits = self.model(x if rows is None else x[rows])
        logits = gather_rows(logits, int(x.shape[0]), self.group)
        return weighted_bce_loss(logits, y, weights), logits

    def _epoch_pass(self, train: bool, ds=None) -> tuple:
        """``(mean batch loss, ROC-AUC)`` of one pass; a split's loss
        weighs it with its own class weights (the vendored ``train_t2.py``
        weighs the val loss by the val set's)."""
        if ds is None:
            ds = self.train_ds if train else self.val_ds
        weights = tuple(ds.weights)
        losses, outs, labels = [], [], []
        for x, y in ds.batches(self.args.batch_size, shuffle=train,
                               seed=self.args.seed + self.epoch):
            xb = upload(np.asarray(x, np.float32), self.device)
            yb = upload(np.asarray(y, np.float32), self.device)
            loss, logits = (self.train_step(xb, yb) if train
                            else self.eval_step(xb, yb, weights))
            losses.append(loss)
            outs.append(logits.reshape(-1))
            labels.append(np.asarray(y).ravel())
        if not outs:   # an empty split: as evaluate()'s n == 0 guard
            return float("nan"), float("nan")
        total = 0.0
        for v in torch.stack(losses).cpu().tolist():
            total += v
        logits = torch.cat(outs).float().cpu().numpy()
        scores = 1.0 / (1.0 + np.exp(-logits))
        try:
            auc = roc_auc(np.concatenate(labels), scores)
        except ValueError:
            auc = float("nan")
        return total / len(losses), auc

    # ------------------------------------------------------------------

    def request_preempt(self) -> None:
        """Snapshot at the next epoch boundary and stop (the SIGTERM /
        SIGUSR1 handler under ``preempt_save``)."""
        self._preempt = True

    def _save_resume(self, epoch: int) -> None:
        host = {
            "epoch": int(epoch),
            "early": {"counter": self.early.counter,
                      "best_loss": float(self.early.best_loss),
                      "early_stop": bool(self.early.early_stop)},
            "plateau": self.plateau.state_dict(),
            "history": self.history,
        }
        if self.primary:
            ckpt_lib.save_resume(self.args.out_dir, epoch,
                                 {"model": self.model.state_dict(),
                                  "optimizer": self.optimizer.state_dict()},
                                 host, keep=self.args.resume_keep)
        barrier(self.group)

    def try_resume(self) -> bool:
        """Restore the newest snapshot in ``out_dir``, if there is one."""
        d = ckpt_lib.latest_resume_dir(self.args.out_dir)
        if d is None:
            return False
        tensors, host = ckpt_lib.load_train_state(d, self.device)
        self.model.load_state_dict(tensors["model"])
        self.optimizer.load_state_dict(tensors["optimizer"])
        self.epoch = int(host["epoch"])
        self.history = list(host["history"])
        self.early.counter = int(host["early"]["counter"])
        self.early.best_loss = float(host["early"]["best_loss"])
        self.early.early_stop = bool(host["early"]["early_stop"])
        self.plateau.load_state_dict(host["plateau"])
        print(f"[clf] resumed {d} at epoch {self.epoch}")
        return True

    def fit(self, resume: bool = False, save_resume_every: int = 0,
            preempt_save: bool = False) -> Dict[str, Any]:
        """Shuffles are seeded by epoch, so an epoch-boundary resume
        continues the stream of an uninterrupted run; EarlyStopping and
        the plateau ride the snapshot."""
        with _preempt_signals(preempt_save, self.request_preempt):
            return self._fit(resume, save_resume_every)

    def _fit(self, resume: bool, save_resume_every: int) -> Dict[str, Any]:
        a = self.args
        if resume and not self.try_resume():
            print(f"[clf] resume requested but no snapshot in "
                  f"{a.out_dir}; starting fresh")
        for ep in range(self.epoch + 1, a.epochs + 1):
            self.epoch = ep
            lr = a.lr * self.sched(ep - 1) * self.plateau.lr
            self.optimizer.lr = lr
            t0 = time.time()
            tr_loss, tr_auc = self._epoch_pass(train=True)
            vl_loss, vl_auc = self._epoch_pass(train=False)
            self.plateau.step(vl_loss)
            if self.primary:
                print(f"[clf] epoch {ep:03d} train {tr_loss:.4f}/"
                      f"{tr_auc:.3f} val {vl_loss:.4f}/{vl_auc:.3f} "
                      f"lr {lr:.2e} ({time.time() - t0:.1f}s)", flush=True)
            self.history.append({"epoch": ep, "train_loss": tr_loss,
                                 "train_auc": tr_auc, "val_loss": vl_loss,
                                 "val_auc": vl_auc, "lr": lr})
            self.early(vl_loss)
            if self.early.early_stop:
                print("[clf] early stopping")
                break
            if save_resume_every and ep % save_resume_every == 0:
                self._save_resume(ep)
            self._preempt = any_rank(self._preempt, self.group)
            if self._preempt:
                self._save_resume(ep)
                print(f"[preempt] resume snapshot saved (epoch {ep} done);"
                      " stopping")
                break
        if self.primary:
            with open(os.path.join(a.out_dir, "history.json"), "w",
                      encoding="utf-8") as f:
                json.dump(self.history, f, indent=2)
        barrier(self.group)
        return {"best_ckpt": self.best_path, "history": self.history}

    def _save_best(self) -> None:
        if self.primary:
            ckpt_lib.save_best(self.best_path, self.model.state_dict(),
                               asdict(self.args))

    def evaluate(self, ds, ckpt_path: Optional[str] = None
                 ) -> Dict[str, float]:
        """Loss and AUC of a (saved) model on ``ds``, the vendored
        ``test.py``. A checkpoint whose ``.args.json`` names another
        (model, diff, amp) than this trainer's is loaded into a model
        rebuilt from it."""
        if len(ds) == 0:
            return {"loss": float("nan"), "auc": float("nan"), "n": 0}
        if ckpt_path and os.path.exists(ckpt_path + ".args.json"):
            with open(ckpt_path + ".args.json", encoding="utf-8") as f:
                saved = json.load(f)
            a = self.args
            cfg = (saved.get("model", a.model), bool(saved.get("diff", a.diff)),
                   bool(saved.get("amp", a.amp)))
            if cfg != (a.model, a.diff, a.amp):
                self.model = build_classifier(
                    {"model": cfg[0], "diff": cfg[1], "amp": cfg[2]}
                ).to(self.device)
        if ckpt_path:
            self.model.load_state_dict(ckpt_lib.load_best(ckpt_path,
                                                          self.device))
        loss, auc = self._epoch_pass(train=False, ds=ds)
        return {"loss": loss, "auc": auc, "n": len(ds)}
