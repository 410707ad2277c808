"""3-D patch U-Net trainer: ROI patches -> ResidualUNet3D -> DiceCE ->
best checkpoint by val loss.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/trainer3d.py``:
``KneeNPZ3D`` (:39-122), ``UNet3DArgs`` (:124-168) with the same fields and
defaults, ``UNet3DTrainer`` (:171-434) and its CLI (:441-510), the
reference's ``src/train/train_unet3d.py``.

- ``KneeNPZ3D`` is numpy only and copied as it is: the same
  ``default_rng`` stream, the ROI order ``(Y, X, D)``, the positive-biased
  centre, the centre clipping, zero-padding to the full ROI and the bounded
  LRU cache of z-scored volumes, so one seed gives the JAX sampler's
  patches bit for bit. Its batches are NCDHW ``(B, 1, D, Y, X)`` here.
- ``UNet3DTrainer``: the model of ``models/unet3d.py`` (bf16 compute under
  ``amp``), AdamW without a clip (``train/optim.py``), the binary or
  multiclass DiceCE loss, ``accum_steps`` microbatches per update with the
  ragged tail applied as the mean of what it holds, validation at batch 1,
  the best checkpoint by val loss in ``best3d.ckpt`` with
  ``best3d.ckpt.args.json``, and ``train_log.csv`` appended with the header
  ``epoch,train_loss,val_loss,lr``. ``device_sampling`` draws the train
  patches on the device (``data/volume3d.py``), from a store padded to the
  ROI's depth, so its patches have the host sampler's shape. The JAX trainer draws one
  probe patch from the train sampler to initialize its model; this one
  draws it too, so the sampler's stream stays the JAX one.
- Resume: snapshots at epoch ends (``save_resume_every``, pruned to
  ``resume_keep``) hold the model, the optimizer, both host samplers'
  bit-generator states and the device sampler's generator state;
  ``resume`` continues from the newest bit for bit; ``preempt_save`` turns
  SIGTERM / SIGUSR1, and ``request_preempt()`` always, into a snapshot at
  the epoch's end and a clean stop.

- ``data_parallel`` (JAX :150-163, :216-231): each rank of a
  ``parallel.DataGroup`` (the CLI spawns them: ``--data-parallel N`` on
  ``cuda:0`` .. ``cuda:N-1``, or CPU ranks with ``--device cpu``) draws the
  same patch batches, runs its contiguous share of each batch's rows and
  averages its gradients and loss with the others' in one all-reduce. The
  InstanceNorm is per sample and DiceCE a mean of per-sample terms, so the
  average of the ranks' losses is the global batch's. A batch the world
  does not divide (the batch-1 validation) runs whole on every rank. Rank 0
  alone writes the run directory.

The weights come from a CPU generator seeded with ``args.seed``; ``device``
is an argument of the trainer. Refused, naming the flag:
``spatial_parallel`` above 1 (depth sharding, ROADMAP Queue 1 item 7b)
and ``ckpt_backend="orbax"`` (a JAX library; the port's snapshots take its
place).
"""

from __future__ import annotations

import argparse
import os
from collections import OrderedDict
from dataclasses import asdict, dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..data.hbm_loader import read_list
from ..data.volume3d import DeviceVolumeStore
from ..models.factory import build_unet3d
from ..models.unet3d import init_weights3d
from ..parallel.mesh import (
    DataGroup, any_rank, average_flat, barrier, mesh_devices, row_slice,
    spawn)
from ..utils.device import resolve_device
from . import checkpoint as ckpt_lib
from .losses import dice_ce_loss_3d_binary, dice_ce_loss_3d_multiclass
from .optim import make_optimizer
from .trainer import _preempt_signals


class KneeNPZ3D:
    """Random-crop 3-D patch sampler (reference KneeNPZ3D semantics)."""

    def __init__(self, list_txt: str, roi: Tuple[int, int, int] = (160, 160, 64),
                 pos_neg_ratio: float = 1.0, samples_per_vol: int = 12,
                 train: bool = True, seed: int = 0, cache_volumes: int = 8):
        self.files = read_list(list_txt)
        self.roi = tuple(roi)
        self.r = float(pos_neg_ratio)
        self.n = int(samples_per_vol)
        self.train = bool(train)
        self.rng = np.random.default_rng(seed)
        # a bounded LRU of z-scored volumes (the reference reloads the npz
        # on every __getitem__)
        self.cache_volumes = max(1, int(cache_volumes))
        self._cache: "OrderedDict[int, Tuple[np.ndarray, np.ndarray]]" = \
            OrderedDict()

    def _load(self, fidx: int):
        if fidx in self._cache:
            self._cache.move_to_end(fidx)
        else:
            z = np.load(self.files[fidx])
            x = z["img"].astype(np.float32)          # (S,1,H,W)
            y = z["msk"].astype(np.int64)            # (S,H,W)
            mu, sd = float(x.mean()), float(x.std() + 1e-6)
            self._cache[fidx] = ((x - mu) / sd, y)
            while len(self._cache) > self.cache_volumes:
                self._cache.popitem(last=False)
        return self._cache[fidx]

    def _sample(self, x: np.ndarray, y: np.ndarray, positive: bool):
        S, _, H, W = x.shape
        D, Y, X = self.roi[2], self.roi[0], self.roi[1]
        D, Y, X = min(D, S), min(Y, H), min(X, W)
        if positive and y.max() > 0:
            zs, ys, xs = np.where(y > 0)
            k = self.rng.integers(0, len(zs))
            cz, cy, cx = int(zs[k]), int(ys[k]), int(xs[k])
        else:
            cz = int(self.rng.integers(0, S))
            cy = int(self.rng.integers(0, H))
            cx = int(self.rng.integers(0, W))
        z0 = int(np.clip(cz - D // 2, 0, max(0, S - D)))
        y0 = int(np.clip(cy - Y // 2, 0, max(0, H - Y)))
        x0 = int(np.clip(cx - X // 2, 0, max(0, W - X)))
        px = x[z0:z0 + D, 0, y0:y0 + Y, x0:x0 + X]   # (D,Y,X)
        py = y[z0:z0 + D, y0:y0 + Y, x0:x0 + X]
        # a volume smaller than the ROI gives a clipped patch: zero-pad it
        # back to the full ROI, so every patch has one shape
        tgt = (self.roi[2], self.roi[0], self.roi[1])
        if px.shape != tgt:
            pad = tuple((0, t - s) for t, s in zip(tgt, px.shape))
            px = np.pad(px, pad)
            py = np.pad(py, pad)
        return px, py

    def __len__(self):
        return len(self.files) * (self.n if self.train else 2)

    def __getitem__(self, i: int):
        fidx = i // (self.n if self.train else 2)
        x, y = self._load(fidx)
        if self.train:
            pos = self.rng.random() < (self.r / (1.0 + self.r))
        else:
            pos = bool(y.max() > 0)
        return self._sample(x, y, pos)

    def batches(self, batch_size: int, shuffle: bool
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """``(B, 1, D, Y, X)`` float32 patches and ``(B, D, Y, X)`` int64
        masks, the last batch ragged."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            chunk = order[start:start + batch_size]
            xs, ys = zip(*(self[int(i)] for i in chunk))
            yield np.stack(xs)[:, None], np.stack(ys)


@dataclass
class UNet3DArgs:
    """The JAX package's ``UNet3DArgs``: the reference's fields, then its
    TPU extensions."""
    train_list: str = ""
    val_list: str = ""
    out_dir: str = "runs/unet3d_balanced"
    roi: Tuple[int, int, int] = (160, 160, 64)
    channels: Tuple[int, ...] = (32, 64, 128, 256, 320)
    classes: int = 1
    batch_size: int = 2
    epochs: int = 80
    lr: float = 1e-3
    weight_decay: float = 1e-4
    workers: int = 4
    amp: bool = True
    seed: int = 2024
    pos_neg_ratio: float = 1.0
    samples_per_vol_train: int = 12
    samples_per_vol_val: int = 2
    device_sampling: bool = False   # device store + on-device patches
    accum_steps: int = 1            # microbatches per optimizer update
    data_parallel: int = 1
    spatial_parallel: int = 1
    resume: bool = False            # resume from the newest snapshot
    save_resume_every: int = 0      # epochs between resume snapshots
    resume_keep: int = 0            # keep newest N snapshots (0 = all)
    preempt_save: bool = False      # SIGTERM/SIGUSR1 -> snapshot + stop
    ckpt_backend: str = "msgpack"   # the port's own snapshot format


def check_args3d(args: UNet3DArgs) -> None:
    """Raise ``ValueError`` naming the flag of a setting the port cannot
    run."""
    if args.spatial_parallel > 1:
        raise ValueError(
            f"--spatial-parallel {args.spatial_parallel} is not ported: "
            "depth-sharded 3-D training waits for the model-parallel slice "
            "(ROADMAP.md Queue 1 item 7b)")
    if args.data_parallel < 1:
        raise ValueError(f"--data-parallel {args.data_parallel} is below 1")
    if args.ckpt_backend != "msgpack":
        raise ValueError(f"--ckpt-backend {args.ckpt_backend!r} is not "
                         "ported: orbax is a JAX library; the port's own "
                         "snapshots (train/checkpoint.py) take its place")
    for name in ("save_resume_every", "resume_keep"):
        if getattr(args, name) < 0:
            raise ValueError(f"--{name.replace('_', '-')} "
                             f"{getattr(args, name)} is negative")


class UNet3DTrainer:
    """``UNet3DTrainer(args, device).fit()`` trains and writes
    ``args.out_dir``; with ``group`` (of ``data_parallel`` ranks), one rank
    of a data-parallel run on ``group.device``."""

    def __init__(self, args: UNet3DArgs,
                 device: str | torch.device = "cuda",
                 group: Optional[DataGroup] = None):
        check_args3d(args)
        if (group.world if group is not None else 1) != args.data_parallel:
            raise ValueError(
                f"--data-parallel {args.data_parallel} on "
                f"{group.world if group is not None else 1} rank(s): start "
                "the ranks with this module's CLI (or parallel.spawn, "
                "passing each rank's group)")
        self.args = args
        self.group = group
        self.primary = group is None or group.primary
        self.device = (group.device if group is not None
                       else resolve_device(device))
        os.makedirs(args.out_dir, exist_ok=True)

        self.train_ds = KneeNPZ3D(args.train_list, roi=args.roi,
                                  pos_neg_ratio=args.pos_neg_ratio,
                                  samples_per_vol=args.samples_per_vol_train,
                                  train=True, seed=args.seed)
        self.val_ds = KneeNPZ3D(args.val_list, roi=args.roi,
                                pos_neg_ratio=args.pos_neg_ratio,
                                samples_per_vol=args.samples_per_vol_val,
                                train=False, seed=args.seed + 1)

        dtype = torch.bfloat16 if args.amp else torch.float32
        model = build_unet3d(in_ch=1, classes=args.classes,
                             channels=args.channels, dtype=dtype)
        init_weights3d(model, torch.Generator().manual_seed(args.seed))
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(self.params, args.lr,
                                        args.weight_decay, 0.0)  # no clip
        self.loss_fn = (dice_ce_loss_3d_binary if args.classes == 1
                        else dice_ce_loss_3d_multiclass)
        # the JAX trainer initializes its model on one probe patch drawn
        # from the train sampler: draw it too, to keep the sampler's stream
        self.train_ds[0]

        self.device_store = None
        self.sample_gen = torch.Generator(device=self.device).manual_seed(
            args.seed + 7)
        if args.device_sampling:
            self.device_store = DeviceVolumeStore(
                args.train_list, seed=args.seed, device=self.device,
                min_depth=args.roi[2])

        self.best_val = float("inf")
        self.best_path = os.path.join(args.out_dir, "best3d.ckpt")
        self.log_csv = os.path.join(args.out_dir, "train_log.csv")
        if self.primary and not os.path.exists(self.log_csv):
            with open(self.log_csv, "w", encoding="utf-8") as f:
                f.write("epoch,train_loss,val_loss,lr\n")

        self.start_epoch = 1
        self._preempt = False
        if args.resume:
            self._try_resume()

    # ------------------------------------------------------------------

    def _to_device(self, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(x, np.ndarray):
            x, y = torch.from_numpy(x), torch.from_numpy(y)
        return x.to(self.device), y.to(self.device)

    def _loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        logits = self.model(x)
        tg = y[:, None].float() if self.args.classes == 1 else y.long()
        return self.loss_fn(logits, tg)

    def grads_one(self, x: torch.Tensor, y: torch.Tensor
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The loss of one batch and the gradients of every parameter; under
        a group, of the global batch ``x``, ``y`` (this rank runs its rows),
        equal on every rank."""
        self.model.train()
        rows = row_slice(int(x.shape[0]), self.group)
        if rows is not None:
            x, y = x[rows], y[rows]
        loss = self._loss(x, y)
        grads = list(torch.autograd.grad(loss, self.params))
        if self.group is None:
            return loss.detach(), grads
        out = average_flat(grads + [loss.detach()], self.group)
        return out[-1], out[:-1]

    def train_one_epoch(self) -> float:
        accum = max(1, int(self.args.accum_steps))
        losses: List[torch.Tensor] = []
        gsum, in_group = None, 0
        for x, y in self._train_batches():
            loss, grads = self.grads_one(*self._to_device(x, y))
            losses.append(loss)
            if accum == 1:
                self.optimizer.step(grads)
                continue
            if gsum is None:
                gsum = grads
            else:
                torch._foreach_add_(gsum, grads)
            in_group += 1
            if in_group == accum:
                self.optimizer.step(torch._foreach_div(gsum, float(accum)))
                gsum, in_group = None, 0
        if in_group:   # a ragged tail still updates, with its own mean
            self.optimizer.step(torch._foreach_div(gsum, float(in_group)))
        return _mean_of(losses)

    def _train_batches(self):
        a = self.args
        if self.device_store is None:
            yield from self.train_ds.batches(a.batch_size, shuffle=True)
            return
        # the store is padded to the ROI's depth; H and W are clipped to
        # its extent, as the host sampler clips them to each volume's
        _, s_max, h, w = self.device_store.images.shape
        roi = (min(a.roi[0], h), min(a.roi[1], w), min(a.roi[2], s_max))
        for _ in range(max(1, len(self.train_ds) // a.batch_size)):
            yield self.device_store.sample_batch(
                self.sample_gen, a.batch_size, roi, a.pos_neg_ratio)

    @torch.no_grad()
    def validate(self) -> float:
        self.model.eval()
        losses = [self._loss(*self._to_device(x, y))
                  for x, y in self.val_ds.batches(1, shuffle=False)]
        return _mean_of(losses)

    def request_preempt(self) -> None:
        """Snapshot at the next epoch end and stop (the SIGTERM / SIGUSR1
        handler under ``preempt_save``)."""
        self._preempt = True

    def _save_resume(self, epoch: int) -> None:
        tensors = {"model": self.model.state_dict(),
                   "optimizer": self.optimizer.state_dict(),
                   "sample_gen": self.sample_gen.get_state()}
        # the host samplers' numpy states make a resumed run draw the
        # uninterrupted run's patches and shuffles
        host = {"epoch": int(epoch), "best_val": float(self.best_val),
                "train_rng": self.train_ds.rng.bit_generator.state,
                "val_rng": self.val_ds.rng.bit_generator.state}
        if self.primary:
            ckpt_lib.save_resume(self.args.out_dir, epoch, tensors, host,
                                 keep=self.args.resume_keep)
        barrier(self.group)

    def _try_resume(self) -> None:
        d = ckpt_lib.latest_resume_dir(self.args.out_dir)
        if d is None:
            return
        tensors, host = ckpt_lib.load_train_state(d)
        self.model.load_state_dict(tensors["model"])
        self.optimizer.load_state_dict(tensors["optimizer"])
        self.sample_gen.set_state(tensors["sample_gen"])
        self.best_val = float(host["best_val"])
        self.start_epoch = int(host["epoch"]) + 1
        self.train_ds.rng.bit_generator.state = host["train_rng"]
        self.val_ds.rng.bit_generator.state = host["val_rng"]
        print(f"[resume3d] restored {d}, continuing at epoch "
              f"{self.start_epoch}")

    def fit(self) -> Dict[str, Any]:
        a = self.args
        with _preempt_signals(a.preempt_save, self.request_preempt):
            for ep in range(self.start_epoch, a.epochs + 1):
                tr = self.train_one_epoch()
                vl = self.validate()
                lr = self.optimizer.lr
                if self.primary:
                    print(f"Epoch {ep:03d}/{a.epochs} | train {tr:.4f} | "
                          f"val {vl:.4f} | lr {lr:.2e}")
                    with open(self.log_csv, "a", encoding="utf-8") as f:
                        f.write(f"{ep},{tr:.6f},{vl:.6f},{lr:.6e}\n")
                if vl < self.best_val:
                    self.best_val = vl
                    if self.primary:
                        ckpt_lib.save_best(self.best_path,
                                           self.model.state_dict(), asdict(a))
                        print("  >> saved best")
                if a.save_resume_every and ep % a.save_resume_every == 0:
                    self._save_resume(ep)
                self._preempt = any_rank(self._preempt, self.group)
                if self._preempt:
                    if not (a.save_resume_every
                            and ep % a.save_resume_every == 0):
                        self._save_resume(ep)
                    print(f"[preempt] resume snapshot saved (epoch {ep} "
                          f"done); stopping")
                    break
        barrier(self.group)
        if self.primary:
            print("Done. Best:", self.best_path)
        return {"best_ckpt": self.best_path,
                "best_val_loss": float(self.best_val)}


def _mean_of(losses: List[torch.Tensor]) -> float:
    """The mean of the step losses, summed on the host in float64 in step
    order as the JAX trainer sums them; one device read."""
    if not losses:
        return 0.0
    vals = torch.stack(losses).float().cpu().tolist()
    run = 0.0
    for v in vals:
        run += v
    return run / len(vals)


# ---------------------------------------------------------------------------
# CLI (the JAX parse_args surface, plus --device)
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Train 3D U-Net (class runner, PyTorch)")
    p.add_argument("--train-list", required=True)
    p.add_argument("--val-list", required=True)
    p.add_argument("--out-dir", default="runs/unet3d_balanced")
    p.add_argument("--roi", type=int, nargs=3, default=[160, 160, 64])
    p.add_argument("--channels", type=int, nargs="+",
                   default=[32, 64, 128, 256, 320])
    p.add_argument("--classes", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--amp", action="store_true")
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--pos-neg-ratio", type=float, default=1.0)
    p.add_argument("--samples-per-vol-train", type=int, default=12)
    p.add_argument("--samples-per-vol-val", type=int, default=2)
    p.add_argument("--device-sampling", action="store_true",
                   help="device-resident volume store + on-device patches")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="microbatches per optimizer update")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="ranks to train on, one card each (CPU ranks "
                        "with --device cpu)")
    p.add_argument("--spatial-parallel", type=int, default=1,
                   help="only 1 is ported")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest snapshot in out-dir")
    p.add_argument("--save-resume-every", type=int, default=0,
                   help="write a resume snapshot every N epochs")
    p.add_argument("--resume-keep", type=int, default=0,
                   help="keep only the newest N resume snapshots (0 = all)")
    p.add_argument("--preempt-save", action="store_true",
                   help="SIGTERM/SIGUSR1 -> resume snapshot at the next "
                        "epoch end, clean stop; rerun with --resume")
    p.add_argument("--ckpt-backend", default="msgpack",
                   choices=["msgpack", "orbax"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    return p


def _args_of(a: argparse.Namespace) -> UNet3DArgs:
    return UNet3DArgs(
        train_list=a.train_list, val_list=a.val_list, out_dir=a.out_dir,
        roi=tuple(a.roi), channels=tuple(a.channels), classes=a.classes,
        batch_size=a.batch_size, epochs=a.epochs, lr=a.lr,
        weight_decay=a.weight_decay, workers=a.workers, amp=a.amp,
        seed=a.seed, pos_neg_ratio=a.pos_neg_ratio,
        samples_per_vol_train=a.samples_per_vol_train,
        samples_per_vol_val=a.samples_per_vol_val,
        device_sampling=a.device_sampling, accum_steps=a.accum_steps,
        data_parallel=a.data_parallel, spatial_parallel=a.spatial_parallel,
        resume=a.resume, save_resume_every=a.save_resume_every,
        resume_keep=a.resume_keep,
        preempt_save=a.preempt_save, ckpt_backend=a.ckpt_backend,
    )


def parse_args(argv=None) -> UNet3DArgs:
    """The JAX ``parse_args``: the command line's ``UNet3DArgs``."""
    return _args_of(build_parser().parse_args(argv))


def _fit_rank(group: DataGroup, args: UNet3DArgs) -> Dict[str, Any]:
    """One spawned rank of ``--data-parallel``."""
    return UNet3DTrainer(args, group.device, group).fit()


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    args = _args_of(ns)
    if args.data_parallel > 1:
        check_args3d(args)
        devices = mesh_devices(args.data_parallel, ns.device)
        spawn(_fit_rank, args.data_parallel, devices, args=(args,),
              timeout_s=1e6)
        return 0
    UNet3DTrainer(args, ns.device).fit()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
