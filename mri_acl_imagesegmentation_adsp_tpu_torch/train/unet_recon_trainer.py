"""The baseline U-Net reconstruction trainer (image-domain L1).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/
unet_recon_trainer.py``, the prostate code's ``unet_module.py``: fastMRI's
U-Net (``chans`` 32, 4 pools; ``models/fastmri_unet.py``) trained with the
L1 loss on instance-normalized magnitude images, optax's RMSprop
(``train/optim.py:RMSprop``, eps inside the root) with StepLR by epoch, the
train set shuffled each epoch by ``default_rng(seed + epoch)``, and the best
checkpoint by validation loss (``unet_recon_best.ckpt`` + ``.args.json``, the
port's format). ``UnetSample`` and ``unet_transform`` are numpy and copied
as they are.

The weights come from a CPU generator seeded with ``args.seed`` (Flax's
He-normal init), the compute dtype is bf16 under ``amp`` and f32 otherwise
(TF32 off on a card), and each epoch's train and validation losses stay on
the device until its end.
"""

from __future__ import annotations

import os
import time
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from ..models.fastmri_unet import FastMRIUnet, init_fastmri_weights
from ..utils.device import f32_on_card, resolve_device
from . import checkpoint as ckpt_lib
from .optim import RMSprop
from .trainer3d import _mean_of


class UnetSample(NamedTuple):
    """Image-domain sample: the instance-normalized input and the target
    normalized by the input's statistics (fastMRI's ``UnetDataTransform``)."""
    image: np.ndarray        # (H, W) normalized magnitude
    target: np.ndarray       # (H, W) normalized target
    mean: float
    std: float
    fname: str
    slice_num: int
    max_value: float


def unet_transform(image: np.ndarray, target: np.ndarray, fname: str,
                   slice_num: int, max_value: float,
                   clamp: float = 6.0) -> UnetSample:
    """Instance-normalize by the input's stats, clamp to +-6 (fastMRI)."""
    mean = float(image.mean())
    std = float(image.std()) + 1e-11
    img = np.clip((image - mean) / std, -clamp, clamp)
    tgt = np.clip((target - mean) / std, -clamp, clamp)
    return UnetSample(img.astype(np.float32), tgt.astype(np.float32),
                      mean, std, fname, slice_num, max_value)


@dataclass
class UnetReconArgs:
    out_dir: str = "runs/unet_recon"
    in_chans: int = 1
    out_chans: int = 1
    chans: int = 32
    num_pool_layers: int = 4
    drop_prob: float = 0.0
    lr: float = 0.001
    lr_step_size: int = 40
    lr_gamma: float = 0.1
    weight_decay: float = 0.0
    epochs: int = 50
    batch_size: int = 1
    seed: int = 42
    amp: bool = True


class UnetReconTrainer:
    """``UnetReconTrainer(args, train_ds, val_ds, device=...).fit()``; the
    datasets are sequences of :class:`UnetSample`."""

    def __init__(self, args: UnetReconArgs, train_ds: List[UnetSample],
                 val_ds: List[UnetSample],
                 device: str | torch.device = "cuda"):
        self.args = args
        self.device = resolve_device(device)
        os.makedirs(args.out_dir, exist_ok=True)
        self.train_ds = train_ds
        self.val_ds = val_ds
        model = FastMRIUnet(args.in_chans, args.out_chans, args.chans,
                            args.num_pool_layers, args.drop_prob,
                            torch.bfloat16 if args.amp else torch.float32)
        init_fastmri_weights(model, torch.Generator().manual_seed(args.seed))
        self.model = model.to(self.device)
        self.optimizer = RMSprop(self.model.parameters(), args.lr,
                                 decay=0.99, eps=1e-8)
        self.epoch = 0
        self.best_val = float("inf")
        self.best_path = os.path.join(args.out_dir, "unet_recon_best.ckpt")

    def _lr_now(self) -> float:
        return self.args.lr * (self.args.lr_gamma
                               ** (self.epoch // self.args.lr_step_size))

    def _batches(self, ds, shuffle: bool):
        """``(B, 1, H, W)`` inputs and targets on the device, the last batch
        ragged; shuffled by ``default_rng(seed + epoch)``."""
        order = np.arange(len(ds))
        if shuffle:
            np.random.default_rng(self.args.seed + self.epoch).shuffle(order)
        bs = self.args.batch_size
        for start in range(0, len(order), bs):
            chunk = [ds[int(i)] for i in order[start:start + bs]]
            x = np.stack([s.image for s in chunk])[:, None]
            y = np.stack([s.target for s in chunk])[:, None]
            yield (torch.from_numpy(x).to(self.device),
                   torch.from_numpy(y).to(self.device))

    def loss_and_grads(self, x: torch.Tensor, y: torch.Tensor) -> tuple:
        """The L1 loss (a device scalar) and its gradients, in the
        optimizer's parameter order."""
        self.model.train()
        with f32_on_card(self.device):
            loss = torch.mean(torch.abs(self.model(x) - y))
            grads = torch.autograd.grad(loss, self.optimizer.params)
        return loss.detach(), grads

    def step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One RMSprop step on the L1 loss; the loss as a device scalar."""
        loss, grads = self.loss_and_grads(x, y)
        self.optimizer.lr = self._lr_now()
        self.optimizer.step(grads)
        return loss

    @torch.no_grad()
    def val_loss(self) -> float:
        self.model.eval()
        with f32_on_card(self.device):
            return _mean_of([torch.mean(torch.abs(self.model(x) - y))
                             for x, y in self._batches(self.val_ds, False)])

    def fit(self) -> Dict[str, Any]:
        history = []
        for ep in range(self.epoch + 1, self.args.epochs + 1):
            self.epoch = ep
            t0 = time.time()
            tr = _mean_of([self.step(x, y)
                           for x, y in self._batches(self.train_ds, True)])
            vl = self.val_loss()
            print(f"[unet-recon] epoch {ep:03d} train {tr:.4f} val {vl:.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
            history.append({"epoch": ep, "train_loss": tr, "val_loss": vl})
            if vl < self.best_val:
                self.best_val = vl
                ckpt_lib.save_best(self.best_path, self.model.state_dict(),
                                   asdict(self.args))
        return {"best_ckpt": self.best_path, "history": history}
