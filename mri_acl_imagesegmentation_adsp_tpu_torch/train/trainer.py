"""2-D / 2.5-D U-Net trainer: slice stores -> Engine -> best checkpoint and
run artifacts.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/trainer.py``:
``UNet2DArgs`` (:49-98) with the same fields and defaults, so a JAX run's
``args.json`` replays unchanged, and ``UNet2DTrainer`` (:126-263, :395-460,
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
  ``history_epoch.csv``, ``history_step.csv`` and ``metrics.json``;
- ``test``: Dice and IoU of a checkpoint on the val store or a listed split;
- ``encoder_weights``: a torchvision-layout ResNet checkpoint imported into
  the encoder after the seeded init (``models/torch_import.py``);
- resume (:101, :265-390, :462-596): snapshots at epoch ends
  (``save_resume_every``) and, with ``save_resume_steps``, between chunks
  of that many steps inside an epoch, the oldest pruned past
  ``resume_keep``; ``resume`` continues from the newest one bit for bit
  (``train/checkpoint.py``); ``preempt_save`` turns SIGTERM / SIGUSR1, and
  ``request_preempt()`` always, into a snapshot at the next chunk or epoch
  end and a clean stop; ``ckpt_async`` (JAX :276-324, :470-485) copies
  each snapshot's tensors off and writes it in the background, publishing
  it before the next one starts, at the end of the run and, when the run
  raises, before the exception goes on. JAX takes ``ckpt_async`` only
  with the orbax backend (its msgpack writer blocks); the port takes it
  with its one format, the one argument rule that differs;
- ``profile_epochs``: a ``torch.profiler`` trace of the first epochs' steps
  in ``<out_dir>/profile/epoch_NNN.pt.trace.json``;
- ``remat``: the U-Net's encoder and decoder blocks recomputed in the
  backward pass (``models/norm.py:remat``; BatchNorm's running statistics
  still move once a step); as in JAX, the UNet++ ignores it.

Randomness comes from ``args.seed``: the weights from a CPU generator, the
permutations and the augmentation from two generators on the device. A
snapshot holds both generators' states, the epoch's permutation when it is
taken mid-epoch, the model's state_dict (BatchNorm statistics included),
the optimizer's moments and count, the plateau schedule, the counters and
the history, which is all a continuation needs to be the uninterrupted
run. ``device`` is an argument of the trainer, not a field of
``UNet2DArgs``. The JAX package's TPU extensions that have no port raise
when set away from their defaults (``check_args``).

Data parallelism (JAX :142-157): the trainer runs on each rank of a
``parallel.DataGroup`` given as ``group`` (``cli/launcher.py`` spawns
``data_parallel`` ranks; ``multihost`` joins the group torchrun
describes), on that rank's device. Every rank draws the same permutations
and augmentation, steps through ``train/engine.py``'s data-parallel step
and validates on the global batches, so every rank holds the same weights
and history; ``store_sharded`` keeps ``1/world`` of each store on a rank.
The primary rank (0) alone writes the run directory, which is the one a
single rank writes, and the others wait for it at each snapshot and at the
end; a preemption asked of any rank stops them all at the same step.
"""

from __future__ import annotations

import json
import signal
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.hbm_loader import SliceStore, epoch_permutation, gather_batch
from ..models.factory import build_unet, validate_encoder_weights
from ..models.torch_import import apply_encoder_weights
from ..models.unet2d import init_weights
from ..parallel.mesh import DataGroup, any_rank, barrier, env_group
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
    remat: bool = False                      # per-block backward remat (unet)
    accum_steps: int = 1                     # microbatches per update
    ckpt_backend: str = "msgpack"
    preempt_save: bool = False


# extensions the port does not have, with the default that keeps them off:
# the orbax backend is a JAX library; "msgpack" names the default snapshot
# format, which here is the port's own
_NOT_PORTED = {"ckpt_backend": "msgpack"}
_COUNTS = ("save_resume_every", "save_resume_steps", "resume_keep",
           "profile_epochs")


def check_args(args: UNet2DArgs) -> None:
    """Raise ``ValueError`` naming the flag of any setting the port cannot
    run: the TPU extensions above away from their defaults, a
    ``data_parallel`` below 1, a negative snapshot or profile count, an
    ``encoder_weights`` that is neither "none" nor a checkpoint file, and a
    store dtype other than float32 / bfloat16."""
    def refuse(name, value, why="is not ported"):
        raise ValueError(f"--{name.replace('_', '-')} {value!r} {why}")
    for name, default in _NOT_PORTED.items():
        if getattr(args, name) != default:
            refuse(name, getattr(args, name))
    if args.data_parallel < 1:
        refuse("data_parallel", args.data_parallel, "is below 1")
    for name in _COUNTS:
        if getattr(args, name) < 0:
            refuse(name, getattr(args, name), "is negative")
    try:
        validate_encoder_weights(args.encoder_weights)
    except ValueError as exc:
        refuse("encoder_weights", args.encoder_weights, f"is refused: {exc}")
    if args.store_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--store-dtype {args.store_dtype!r}: float32 or "
                         "bfloat16")


@contextmanager
def _preempt_signals(enabled: bool, callback):
    """SIGTERM and SIGUSR1 call ``callback`` inside the block, and the
    previous handlers come back after it. Off the main thread no handler
    can be installed, and ``request_preempt()`` is the only way in."""
    if not enabled:
        yield
        return
    prev = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                prev[sig] = signal.signal(sig, lambda *_: callback())
            except ValueError:
                break
        yield
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


def _rank_group(args: UNet2DArgs, device: torch.device,
                group: Optional[DataGroup]) -> Optional[DataGroup]:
    """The data-parallel group a run trains on: ``group`` (its world must
    be ``data_parallel``), torchrun's under ``multihost``, else none; a
    ``data_parallel`` above 1 without a group raises."""
    if group is None and args.multihost:
        group = env_group(device.type)
    if group is None:
        if args.data_parallel > 1:
            raise ValueError(
                f"--data-parallel {args.data_parallel} trains on that many "
                "ranks: start them with cli.launcher (or parallel.spawn, "
                "passing each rank's group)")
        return None
    if not args.multihost and group.world != args.data_parallel:
        raise ValueError(f"--data-parallel {args.data_parallel} on a group "
                         f"of {group.world} ranks")
    return group


class UNet2DTrainer:
    """``UNet2DTrainer(args, device).run()`` trains and writes the run
    directory ``args.out_dir``; with ``group``, one rank of a
    data-parallel run on ``group.device``."""

    def __init__(self, args: UNet2DArgs,
                 device: str | torch.device = "cuda",
                 group: Optional[DataGroup] = None):
        check_args(args)
        self.args = args
        self.group = _rank_group(args, resolve_device(device), group)
        self.device = (self.group.device if self.group is not None
                       else resolve_device(device))
        self.primary = self.group is None or self.group.primary
        self.out_dir = Path(args.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.snapshots = ckpt_lib.ResumeWriter(
            str(self.out_dir), args.resume_keep, args.ckpt_async, self.group)
        if self.primary:
            with (self.out_dir / "args.json").open("w",
                                                   encoding="utf-8") as f:
                json.dump(asdict(args), f, indent=2)

        self._build_stores()
        self._build_engine()

        self.logger = make_logger(args.logger if self.primary else "noop",
                                  str(self.out_dir))
        self.best_metric = float("-inf")
        self.best_ckpt_path = self.out_dir / "best.ckpt"
        self.best_snapshot: Dict[str, Any] = {}
        self.history: list = []
        self.start_epoch = 1
        self.global_step = 0
        self.scheduler = ReduceLROnPlateau(
            lr=args.lr, mode="min", factor=0.5, patience=3)
        # set by request_preempt(): snapshot at the next chunk or epoch end
        # and stop
        self._preempt = False
        # the mid-epoch position of the snapshot resumed from, if any
        self._mid_resume: Optional[Dict[str, Any]] = None
        if args.resume:
            self._try_resume()

    def _build_stores(self) -> None:
        a = self.args
        dt = torch.bfloat16 if a.store_dtype == "bfloat16" else torch.float32
        train_src = SliceStore.from_list(a.train_list, workers=a.workers)
        val_src = SliceStore.from_list(a.val_list, workers=a.workers)
        self.train_store = train_src.to_device(
            a.k, dt, self.device, group=self.group, shard=a.store_sharded)
        self.val_store = val_src.to_device(
            a.k, dt, self.device, group=self.group, shard=a.store_sharded)

    def _build_engine(self) -> None:
        a = self.args
        in_ch = 3 if (a.k == 1 and a.imagenet_norm) else a.k
        extra = ({"remat": True} if a.remat and a.model.lower() == "unet"
                 else {})
        model = build_unet(a.model, a.encoder, "none", in_ch=in_ch,
                           classes=a.classes, **extra)
        init_weights(model, torch.Generator().manual_seed(a.seed))
        ew_path = validate_encoder_weights(a.encoder_weights)
        if ew_path is not None:
            # smp's encoder_weights: only the encoder comes from the file
            apply_encoder_weights(model, ew_path, a.encoder)
            print(f"[trainer] encoder initialized from torch checkpoint "
                  f"{ew_path}")
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(), a.lr,
                                        a.weight_decay, a.max_grad_norm)
        self.engine = Engine(
            self.model, LossManager(classes=a.classes, name=a.loss),
            self.optimizer, classes=a.classes, aug=a.aug,
            input_transform=(make_input_norm(True) if a.imagenet_norm
                             else None),
            accum_steps=a.accum_steps, amp=a.amp, group=self.group)
        dev = self.device
        self.perm_gen = torch.Generator(device=dev).manual_seed(a.seed)
        self.aug_gen = torch.Generator(device=dev).manual_seed(a.seed + 1)

    # ------------------------------------------------------------------
    # Resume
    # ------------------------------------------------------------------

    def _tensor_state(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generators": {"perm": self.perm_gen.get_state(),
                               "aug": self.aug_gen.get_state()}}

    def _host_state(self) -> Dict[str, Any]:
        return {"epoch_next": self.start_epoch,
                "global_step": self.global_step,
                "best_metric": self.best_metric,
                "best_snapshot": self.best_snapshot,
                "history": self.history,
                "scheduler": self.scheduler.state_dict()}

    def _save_resume(self, epoch: int) -> None:
        """The snapshot after ``epoch`` epochs."""
        self.start_epoch = epoch + 1
        self.snapshots.save(epoch, self._tensor_state(), self._host_state())

    def _save_mid_resume(self, epoch: int, steps_done: int,
                         perm: torch.Tensor, losses: np.ndarray) -> None:
        """The snapshot ``steps_done`` steps into ``epoch``: besides the
        state it holds the epoch's permutation and the step losses so far,
        the data iterator's position."""
        tensors = self._tensor_state()
        tensors["mid_epoch_perm"] = perm
        host = self._host_state()
        host["epoch_next"] = epoch
        host["mid_epoch"] = {"epoch": int(epoch),
                             "steps_done": int(steps_done),
                             "losses": [float(v) for v in losses]}
        self.snapshots.save(epoch - 1, tensors, host, step=steps_done)

    def _try_resume(self) -> None:
        d = ckpt_lib.latest_resume_dir(str(self.out_dir))
        if d is None:
            return
        tensors, host = ckpt_lib.load_train_state(d)
        self.model.load_state_dict(tensors["model"])
        self.optimizer.load_state_dict(tensors["optimizer"])
        self.perm_gen.set_state(tensors["generators"]["perm"])
        self.aug_gen.set_state(tensors["generators"]["aug"])
        self.start_epoch = host["epoch_next"]
        self.global_step = host["global_step"]
        self.best_metric = host["best_metric"]
        self.best_snapshot = host["best_snapshot"]
        self.history = host["history"]
        self.scheduler.load_state_dict(host["scheduler"])
        self._mid_resume = host.get("mid_epoch")
        at = f"epoch {self.start_epoch}"
        if self._mid_resume:
            self._mid_resume["perm"] = tensors["mid_epoch_perm"].to(
                self.device)
            at += f" step {self._mid_resume['steps_done']}"
        print(f"[resume] restored {d}, continuing at {at}")

    def request_preempt(self) -> None:
        """Snapshot at the next chunk or epoch end and stop. The handler of
        SIGTERM and SIGUSR1 under ``preempt_save``; callable directly."""
        self._preempt = True

    def _train_epoch_chunked(self, ep: int, perm: torch.Tensor,
                             mid: Optional[Dict[str, Any]]):
        """One epoch in chunks of ``save_resume_steps`` steps (a multiple
        of ``accum_steps``) with a snapshot between chunks: the same steps
        on the same generator as the whole-epoch dispatch, so the same
        result bit for bit. ``mid`` (a resumed snapshot's position) skips
        the rows already taken and starts from their losses. Returns the
        step losses and whether a preemption cut the epoch."""
        a = self.args
        accum = max(1, a.accum_steps)
        chunk = max(accum, (a.save_resume_steps // accum) * accum)
        total = int(perm.shape[0]) - int(perm.shape[0]) % accum
        done, parts = 0, []
        if mid is not None:
            done = min(int(mid["steps_done"]), total)
            parts.append(np.asarray(mid["losses"], np.float32))
        while done < total:
            n = min(chunk, total - done)
            losses_dev = self.engine.train_steps(
                self.train_store, perm[done:done + n], self.aug_gen)
            parts.append(self.engine.check_epoch_losses(
                losses_dev, self.engine.step, a.accum_steps))
            done += n
            if done < total:
                self._save_mid_resume(ep, done, perm, np.concatenate(parts))
                if any_rank(self._preempt, self.group):
                    self._preempt = True
                    return np.concatenate(parts), True
        return (np.concatenate(parts) if parts
                else np.zeros(0, np.float32)), False

    def _train_epoch_profiled(self, ep: int, perm: torch.Tensor):
        """The whole-epoch dispatch under ``torch.profiler`` (the device's
        kernels too on a card), its trace in ``<out_dir>/profile``; the
        primary's alone under a group."""
        if not self.primary:
            return self.engine.train_steps(self.train_store, perm,
                                           self.aug_gen)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            losses_dev = self.engine.train_steps(self.train_store, perm,
                                                 self.aug_gen)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        out = self.out_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"epoch_{ep:03d}.pt.trace.json"))
        return losses_dev

    def _log_val_images(self, epoch: int) -> None:
        """Validation probabilities to a sink that takes images (TB): the
        primary's sinks decide, every rank gathers (the gather of a sharded
        store is collective)."""
        if not any_rank(hasattr(self.logger, "log_images"), self.group):
            return
        take = min(4, self.val_store.num_slices)
        x, _ = gather_batch(self.val_store, torch.arange(
            take, device=self.device))
        probs = self.engine.predict_probs(x).cpu().numpy()
        self.logger.log_images("val/pred", np.clip(probs[:, 0], 0, 1), epoch)

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
        if not self.primary:
            return
        np.savez_compressed(self.out_dir / "val_preds.npz",
                            probs=np.concatenate(probs, 0),
                            gts=np.concatenate(gts, 0))

    def test(self, ckpt_path: Optional[str] = None,
             list_txt: Optional[str] = None) -> Dict[str, float]:
        """Dice and IoU in eval mode, after loading ``ckpt_path`` when given,
        on the split listed in ``list_txt`` or else the val store; batches
        of ``batch_size // 2`` as in validation."""
        a = self.args
        if ckpt_path:
            self.model.load_state_dict(ckpt_lib.load_best(ckpt_path))
        store = self.val_store
        if list_txt:
            dt = (torch.bfloat16 if a.store_dtype == "bfloat16"
                  else torch.float32)
            store = SliceStore.from_list(list_txt, workers=a.workers
                                         ).to_device(a.k, dt, self.device,
                                                     group=self.group,
                                                     shard=a.store_sharded)
        _, dice, iou = self.engine.validate(store, max(1, a.batch_size // 2))
        return {"dice": dice, "iou": iou}

    def run(self) -> Dict[str, Any]:
        with _preempt_signals(self.args.preempt_save, self.request_preempt):
            with self.snapshots.publishing("trainer"):
                return self._run()

    def _run(self) -> Dict[str, Any]:
        a = self.args
        t0 = time.time()
        n_train = self.train_store.num_slices
        val_bs = max(1, a.batch_size // 2)
        first_epoch = self.start_epoch   # profiling counts from here

        for ep in range(self.start_epoch, a.epochs + 1):
            mid = None
            if self._mid_resume and int(self._mid_resume["epoch"]) == ep:
                # the permutation was drawn before the snapshot, which holds
                # it and the generators' states after it
                mid, self._mid_resume = self._mid_resume, None
                perm = mid["perm"]
            else:
                self._mid_resume = None
                perm = epoch_permutation(self.perm_gen, n_train,
                                         a.batch_size, drop_last=True)
            lr_now = self.scheduler.lr
            self.optimizer.lr = lr_now
            if ep - first_epoch < a.profile_epochs:
                losses_dev = self._train_epoch_profiled(ep, perm)
                val_loss, val_dice, val_iou = self.engine.validate(
                    self.val_store, val_bs)
                step_losses = self.engine.check_epoch_losses(
                    losses_dev, self.engine.step, a.accum_steps)
            elif a.save_resume_steps > 0:
                step_losses, cut = self._train_epoch_chunked(ep, perm, mid)
                if cut:
                    print(f"[preempt] mid-epoch snapshot saved (epoch {ep},"
                          f" {len(step_losses)} steps done); stopping")
                    break
                val_loss, val_dice, val_iou = self.engine.validate(
                    self.val_store, val_bs)
            else:
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
            if self.primary:
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
                if self.primary:
                    ckpt_lib.save_best(str(self.best_ckpt_path),
                                       self.model.state_dict(), asdict(a))
                if a.save_val_probs:
                    self._save_val_probs()

            if ep == 1 or ep % 5 == 0:
                self.engine.save_samples(self.val_store, str(self.out_dir),
                                         max_samples=6)
                self._log_val_images(ep)
            self._preempt = any_rank(self._preempt, self.group)
            if self._preempt or (a.save_resume_every
                                 and ep % a.save_resume_every == 0):
                self._save_resume(ep)
            if self._preempt:
                print(f"[preempt] resume snapshot saved (epoch {ep} done); "
                      "stopping")
                break

        summary = {
            "best": self.best_snapshot,
            "final": self.history[-1] if self.history else {},
            "best_ckpt": str(self.best_ckpt_path),
            "epochs": int(a.epochs),
        }
        if self._preempt:       # absent from a run that was not cut
            summary["preempted"] = True
        if self.primary:
            with (self.out_dir / "history.json").open(
                    "w", encoding="utf-8") as f:
                json.dump(self.history, f, indent=2)
            with (self.out_dir / "summary.json").open(
                    "w", encoding="utf-8") as f:
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
        barrier(self.group)
        if self.primary:
            print("Done. Best ckpt:", self.best_ckpt_path)
        return {"best_ckpt": str(self.best_ckpt_path),
                "history": self.history, "summary": summary}
