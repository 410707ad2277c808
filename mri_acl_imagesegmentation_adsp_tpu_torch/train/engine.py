"""Training and evaluation of one (model, loss, optimizer) on one device, or
on each rank of a data-parallel group.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/engine.py:80-578``:
the train step (``_grads_one`` + ``_train_step``, :187-207), gradient
accumulation (:257-282), ``check_epoch_losses`` (:409-427), ``validate``
with ``_eval_batches`` (:284-308, :429-457), ``predict_probs`` (:506-514)
and ``save_samples`` (:544-578). The JAX engine runs an epoch as one
``lax.scan``; here a Python loop issues each step's work to the device and
reads nothing back until the caller asks for the epoch's losses, so the
host runs ahead of the card.

A step: gather the batch from the device store, augment, the input
transform, the train-mode forward (under bf16 autocast when ``amp``), the
loss on f32 logits against ``(B, 1, H, W)`` f32 targets (one class) or
``(B, H, W)`` labels, the backward, then the clipped AdamW update. With
``accum_steps`` N, N microbatch gradients are summed and scaled by 1/N
into one update; BatchNorm's running stats move once per microbatch, and
losses are kept per microbatch.

Data parallelism (``group``, a ``parallel.DataGroup``; JAX
``engine.py:17-19``, where a sharded batch gives all of this for free): a
step's batch is the *global* batch, whole on every rank (a sharded store
gathers it). Each rank augments its contiguous share of the rows with the
global batch's parameters, its BatchNorm layers normalize with the global
batch's statistics (``models/norm.py:synced``) and its Dice sums are the
global batch's (``train/losses.py``). Each rank's gradient then carries
the gradient of every rank's loss through those sums, so the ranks'
gradients and losses, *averaged* by one all-reduce an update (after the
``accum_steps`` microbatches), are the global batch's: clip and AdamW then
move every rank's parameters alike. A batch the world does not divide
runs whole on every rank with no sums across ranks (``divisible_spec``'s
replication); its gradients are averaged all the same, which keeps the
ranks' parameters equal where the card's kernels are not deterministic.
Validation splits each batch's rows over the ranks and gathers the logits
(``parallel.gather_rows``), so its loss and metrics are computed on the
whole batch as one rank computes them. ``validate_volume_sharded`` is JAX
``engine.py:459-497``: whole volumes to ranks, per-slice Dice, duplicates
dropped by slice id.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.hbm_loader import DeviceSliceStore, gather_batch
from ..models.norm import at_least_f32, synced
from ..parallel.mesh import (
    DataGroup, all_reduce_, average_flat, gather_rows, row_slice,
    volume_affine_shards)
from ..utils.png import write_png
from .augment import augment_batch, check_recipe
from .metrics import bin_dice_iou
from .optim import ClippedAdamW


class Engine:
    """Owns the step, validation and sample writing for one model."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer: ClippedAdamW, classes: int = 1,
                 aug: str = "light",
                 input_transform: Optional[Callable] = None,
                 accum_steps: int = 1, amp: bool = False,
                 group: Optional[DataGroup] = None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.params = optimizer.params
        self.classes = int(classes)
        check_recipe(aug)
        self.aug = aug
        # applied after augmentation, as the reference normalizes after its
        # albumentations pipeline
        self.input_transform = input_transform or (lambda x: x)
        self.accum_steps = max(1, int(accum_steps))
        self.amp = bool(amp)
        self.group = group

    @property
    def step(self) -> int:
        """Optimizer updates taken (the JAX ``TrainState.step``)."""
        return self.optimizer.count

    @property
    def primary(self) -> bool:
        """Whether this rank writes files (always, without a group)."""
        return self.group is None or self.group.primary

    # ------------------------------------------------------------------
    # Core math
    # ------------------------------------------------------------------

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            return at_least_f32(self.model(self.input_transform(x)))

    def _loss_from_logits(self, logits: torch.Tensor, y: torch.Tensor,
                          group: Optional[DataGroup] = None) -> torch.Tensor:
        targets = y[:, None].float() if self.classes == 1 else y.long()
        if group is None:
            return self.loss_fn(logits, targets)
        return self.loss_fn(logits, targets, group=group)

    def _local_grads(self, x: torch.Tensor, y: torch.Tensor,
                     generator: Optional[torch.Generator]
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """This rank's loss and gradients of its share of the global batch
        ``x``, ``y`` (the whole batch without a group): not yet averaged
        over the ranks."""
        self.model.train()
        b = int(x.shape[0])
        rows = row_slice(b, self.group)
        group = None if rows is None else self.group
        if rows is not None:
            x, y = x[rows], y[rows]
        x, y = augment_batch(x, y, generator, self.aug, rows=rows, batch=b)
        with synced(self.model, group):
            loss = self._loss_from_logits(self._forward(x), y, group)
            grads = torch.autograd.grad(loss, self.params)
        return loss.detach(), list(grads)

    def _average(self, grads: List[torch.Tensor],
                 losses: List[torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The gradients and losses averaged over the ranks in one
        all-reduce (as they are without a group)."""
        if self.group is None:
            return grads, losses
        out = average_flat(grads + [torch.stack(losses)], self.group)
        return out[:-1], list(out[-1].unbind())

    def grads_one(self, x: torch.Tensor, y: torch.Tensor,
                  generator: Optional[torch.Generator]
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One microbatch in train mode: augment, forward, backward. Returns
        the detached loss and the gradients of ``params`` (of the global
        batch under a group, equal on every rank); BatchNorm's running
        stats move as a side effect."""
        loss, grads = self._local_grads(x, y, generator)
        grads, (loss,) = self._average(grads, [loss])
        return loss, grads

    def train_steps(self, store: DeviceSliceStore, perm: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        """Run the rows of ``perm`` ``(steps, batch)`` as steps, drawing the
        augmentation from ``generator``. A ragged tail of fewer than
        ``accum_steps`` rows is dropped. Returns the per-microbatch losses
        ``(steps,)``, still on the device."""
        accum = self.accum_steps
        steps = int(perm.shape[0]) - int(perm.shape[0]) % accum
        losses = []
        for s0 in range(0, steps, accum):
            gsum, micro = None, []
            for j in range(accum):
                x, y = gather_batch(store, perm[s0 + j])
                loss, grads = self._local_grads(x, y, generator)
                micro.append(loss)
                if gsum is None:
                    gsum = grads
                else:
                    torch._foreach_add_(gsum, grads)
            if accum > 1:
                torch._foreach_mul_(gsum, 1.0 / accum)
            gsum, micro = self._average(gsum, micro)
            losses.extend(micro)
            self.optimizer.step(gsum)
        if not losses:
            return torch.zeros(0, device=perm.device)
        return torch.stack(losses)

    @staticmethod
    def check_epoch_losses(losses_dev: torch.Tensor,
                           step: Optional[int] = None,
                           accum_steps: int = 1) -> np.ndarray:
        """Copy an epoch's step losses to the host; raise on a non-finite
        one, naming its global optimizer step when ``step`` (the updates
        taken after the epoch) is given, else its index."""
        losses = losses_dev.detach().float().cpu().numpy()
        if not np.all(np.isfinite(losses)):
            bad = int(np.argmax(~np.isfinite(losses.ravel())))
            value = losses.ravel()[bad]
            if step is not None:
                accum = max(accum_steps, 1)
                bad = step - losses.size // accum + bad // accum
            raise RuntimeError(f"Non-finite loss at step {bad}: {value}")
        return losses

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    @torch.no_grad()
    def validate(self, store: DeviceSliceStore,
                 batch_size: int) -> Tuple[float, float, float]:
        """Eval-mode pass over the store in order, in batches of
        ``batch_size`` and a remainder batch. Returns ``(loss, dice, iou)``:
        the loss is ``sum(loss * len(batch)) / n``, Dice and IoU the mean
        of the batches' batch-global values (0 for several classes)."""
        self.model.eval()
        n = store.num_slices
        dev = store.images.device
        loss_sums, dices, ious = [], [], []
        for start in range(0, n, batch_size):
            idx = torch.arange(start, min(start + batch_size, n), device=dev)
            x, y = gather_batch(store, idx)
            logits = self._eval_logits(x)
            loss_sums.append(self._loss_from_logits(logits, y) * len(idx))
            if self.classes == 1:
                preds = (torch.sigmoid(logits) > 0.5).float()
                d, i = bin_dice_iou(preds, y[:, None].float())
                dices.append(d)
                ious.append(i)
        vloss = float(torch.stack(loss_sums).sum() / n)
        if not dices:
            return vloss, 0.0, 0.0
        return (vloss, float(torch.stack(dices).mean()),
                float(torch.stack(ious).mean()))

    def _eval_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of the whole batch ``x``: under a group each rank runs
        its rows and the logits are gathered on every rank."""
        rows = row_slice(int(x.shape[0]), self.group)
        if rows is None:
            return self._forward(x)
        return gather_rows(self._forward(x[rows]), int(x.shape[0]),
                           self.group)

    def per_slice_dice_iou(self, store: DeviceSliceStore, idx: torch.Tensor
                           ) -> torch.Tensor:
        """``(B, 2)`` Dice and IoU of each slice ``idx`` in eval mode, one
        class (JAX ``_eval_per_slice``)."""
        return self._score_slices(*gather_batch(store, idx))

    @torch.no_grad()
    def _score_slices(self, x: torch.Tensor, y: torch.Tensor
                      ) -> torch.Tensor:
        """``(B, 2)`` Dice and IoU of each slice of the batch ``x``,
        ``y``."""
        self.model.eval()
        preds = (torch.sigmoid(self._forward(x)[:, 0]) > 0.5).float()
        m = y.float()
        inter = (preds * m).sum(dim=(1, 2))
        dice = (2.0 * inter + 1e-7) / (preds.sum(dim=(1, 2))
                                       + m.sum(dim=(1, 2)) + 1e-7)
        iou = (inter + 1e-7) / ((preds + m - preds * m).sum(dim=(1, 2))
                                + 1e-7)
        return torch.stack([dice, iou], dim=1)

    def validate_volume_sharded(self, store: DeviceSliceStore,
                                vol_sizes: Sequence[int], n_shards: int,
                                batch_size: int
                                ) -> Tuple[float, float, np.ndarray]:
        """Volume-affine sharded validation, one class (the VolumeSampler
        contract): whole volumes to ``n_shards`` shards padded to equal
        length (``parallel.volume_affine_shards``), each shard's slices
        scored in batches (a short shard wraps around), the duplicates
        dropped by slice id. Under a group rank ``r`` scores shard ``r``
        (``n_shards`` must be the world) and the scores meet in one
        all-reduce; without one the shards run in turn. Returns (mean Dice
        over volumes, mean IoU over volumes, per-volume Dice)."""
        group = self.group
        if group is not None and n_shards != group.world:
            raise ValueError(f"{n_shards} shards on {group.world} ranks: "
                             "one shard a rank")
        shards = []
        for shard in volume_affine_shards(vol_sizes, n_shards):
            pad = (-len(shard)) % batch_size
            shards.append(np.resize(shard, len(shard) + pad) if pad
                          else shard)
        dev = store.images.device
        scores = torch.zeros((n_shards, len(shards[0]), 2), device=dev)
        mine = range(n_shards) if group is None else [group.rank]
        for start in range(0, len(shards[0]), batch_size):
            if store.sharded:   # every rank gathers all, scores its own
                idx = torch.from_numpy(np.concatenate(
                    [s[start:start + batch_size] for s in shards])).to(dev)
                x, y = gather_batch(store, idx)
                for i in mine:
                    rows = slice(i * batch_size, (i + 1) * batch_size)
                    scores[i, start:start + batch_size] = \
                        self._score_slices(x[rows], y[rows])
                continue
            for i in mine:
                idx = torch.from_numpy(shards[i][start:start + batch_size])
                scores[i, start:start + batch_size] = \
                    self.per_slice_dice_iou(store, idx.to(dev))
        if group is not None:
            all_reduce_(scores, group)
        scores = scores.cpu().numpy()
        dice_by_slice: Dict[int, float] = {}
        iou_by_slice: Dict[int, float] = {}
        for i, shard in enumerate(shards):
            for j, s in enumerate(shard):    # duplicates just overwrite
                dice_by_slice[int(s)] = float(scores[i, j, 0])
                iou_by_slice[int(s)] = float(scores[i, j, 1])
        vol_of = np.repeat(np.arange(len(vol_sizes)), vol_sizes)
        n = int(vol_of.shape[0])
        if len(dice_by_slice) != n:
            raise AssertionError(f"sharded eval missed slices: "
                                 f"{len(dice_by_slice)} of {n}")
        dice = np.asarray([dice_by_slice[s] for s in range(n)])
        iou = np.asarray([iou_by_slice[s] for s in range(n)])
        per_vol = np.asarray([dice[vol_of == v].mean()
                              for v in range(len(vol_sizes))])
        per_vol_iou = np.asarray([iou[vol_of == v].mean()
                                  for v in range(len(vol_sizes))])
        return float(per_vol.mean()), float(per_vol_iou.mean()), per_vol

    @torch.no_grad()
    def predict_probs(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, k, H, W)`` -> ``(B, C, H, W)`` probabilities in eval mode
        (sigmoid for one class, softmax over classes)."""
        self.model.eval()
        logits = self._forward(x)
        if self.classes == 1:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=1)

    # ------------------------------------------------------------------
    # Sample grids
    # ------------------------------------------------------------------

    @staticmethod
    def _to_uint8(a: np.ndarray) -> np.ndarray:
        a = (a - a.min()) / (a.max() - a.min() + 1e-6)
        return (a * 255).astype(np.uint8)

    _MC_PALETTE = [
        (0, 0, 0), (255, 0, 0), (0, 180, 0), (0, 0, 255), (255, 140, 0),
        (180, 0, 180), (0, 160, 160), (200, 200, 0), (255, 105, 180),
        (128, 64, 0),
    ]

    @classmethod
    def _colorize_mc(cls, mask: np.ndarray) -> np.ndarray:
        out = np.zeros((*mask.shape, 3), np.uint8)
        for c in np.unique(mask):
            # by class id, so a class keeps its colour across panels
            out[mask == c] = cls._MC_PALETTE[int(c) % len(cls._MC_PALETTE)]
        return out

    @staticmethod
    def _overlay(gray_u8: np.ndarray, mask_u8: np.ndarray,
                 alpha: float = 0.45) -> np.ndarray:
        rgb = np.stack([gray_u8] * 3, axis=-1).astype(np.float32)
        color = np.zeros_like(rgb)
        color[..., 1] = mask_u8
        return np.clip(rgb + alpha * color, 0, 255).astype(np.uint8)

    def save_samples(self, store: DeviceSliceStore, out_dir: str,
                     max_samples: int = 8, save_probs: bool = False) -> None:
        """``<out_dir>/samples/sample_XXXX.png``: Input | GT | Pred | Overlay
        of the store's first slices (and ``sample_XXXX_prob.npy`` with
        ``save_probs``). Under a group every rank gathers and predicts
        (a sharded store's gather is collective) and the primary writes."""
        take = min(max_samples, store.num_slices)
        idx = torch.arange(take, device=store.images.device)
        x, y = gather_batch(store, idx)
        probs = self.predict_probs(x).cpu().numpy()
        if not self.primary:
            return
        os.makedirs(f"{out_dir}/samples", exist_ok=True)
        x_np = x.cpu().numpy()
        y_np = y.cpu().numpy()
        for sid in range(take):
            img = self._to_uint8(x_np[sid, 0])
            gray = np.stack([img] * 3, -1)
            if self.classes == 1:
                pr = (probs[sid, 0] > 0.5).astype(np.uint8) * 255
                gt = (y_np[sid] > 0.5).astype(np.uint8) * 255
                cols = [gray, np.stack([gt] * 3, -1),
                        np.stack([pr] * 3, -1), self._overlay(img, pr)]
                if save_probs:
                    np.save(f"{out_dir}/samples/sample_{sid:04d}_prob.npy",
                            probs[sid, 0])
            else:
                pr_rgb = self._colorize_mc(
                    np.argmax(probs[sid], axis=0).astype(np.uint8))
                over = np.clip(gray.astype(np.float32) + 0.45 * pr_rgb,
                               0, 255).astype(np.uint8)
                cols = [gray, self._colorize_mc(y_np[sid]), pr_rgb, over]
            write_png(f"{out_dir}/samples/sample_{sid:04d}.png",
                      np.concatenate(cols, axis=1))
