"""Driver entry points of the port: the flagship forward, and a
data-parallel dry run that checks itself.

Counterpart: ``__graft_entry__.py`` at the repository root:

- :func:`entry` (:30-44): the ResNet34-encoder U-Net in bf16 at 320x320,
  eval mode, with seeded random weights; returns ``(fn, example_args)``.
- :func:`dryrun_multichip` (:47-176, :354-383): one data-parallel train
  step and one validation of a narrow U-Net (ResNet18 encoder, 2.5-D
  ``k = 3``, light augmentation, 32x32, a row-sharded slice store, two
  samples a rank) on ``n`` ranks, and, for an even ``n``, one epoch of the
  tiny ConvNeXt classifier with its batches split over the ranks; each
  held to the same work on one device (the JAX tolerances: train loss
  1e-4, validation loss 5e-4, classifier losses 1e-4), every rank to rank
  0's result. The model-parallel parts of the JAX dry run (VarNet's
  (data, coil) mesh and its pipeline, the depth-sharded 3-D U-Net and the
  slice-sharded T2 recon) are not ported yet (ROADMAP.md Queue 1 item
  7b): the dry run names them in its printout and in its result.

The ranks take one card each over NCCL where there are ``n`` cards; where
there are fewer, they share the cards over gloo and the printout says so.
They run on the CPU only when ``device="cpu"`` asks for it.
"""

from __future__ import annotations

import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .classify.trainer import ClassifierArgs, ClassifierTrainer
from .data.hbm_loader import SliceStore, epoch_permutation
from .models.factory import build_unet
from .models.unet2d import init_weights
from .parallel.mesh import DataGroup, choose_backend, spawn
from .train.engine import Engine
from .train.losses import LossManager
from .train.optim import make_optimizer
from .utils.device import f32_on_card, resolve_device

NOT_PORTED = ("varnet (data, coil) tensor parallel",
              "varnet cascade pipeline (GPipe)",
              "unet3d depth-sharded spatial parallel",
              "t2 slice-sharded recon")
TRAIN_TOL, VAL_TOL, CLASSIFY_TOL = 1e-4, 5e-4, 1e-4


def entry(device: str | torch.device = "cuda"
          ) -> Tuple[Callable, Tuple[torch.Tensor]]:
    """The flagship forward (sigmoid probabilities) and its example input,
    a ``(1, 1, 320, 320)`` batch."""
    dev = resolve_device(device)
    model = init_weights(build_unet("unet", "resnet34", in_ch=1, classes=1),
                         torch.Generator().manual_seed(0)).to(dev).eval()

    @torch.inference_mode()
    def fn(x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            return torch.sigmoid(model(x).float())

    return fn, (torch.zeros((1, 1, 320, 320), device=dev),)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def _unet_step(world: int, dev: torch.device,
               group: Optional[DataGroup]) -> Dict[str, float]:
    """One train step and one validation of the dry run's U-Net, on
    ``group`` or (None) on one device holding the whole batch."""
    rng = np.random.default_rng(0)
    n = 4 * world
    src = SliceStore(
        images=rng.standard_normal((n, 32, 32)).astype(np.float32),
        masks=(rng.random((n, 32, 32)) > 0.5).astype(np.int32),
        vol_starts=np.asarray([0, n // 2]),
        vol_sizes=np.asarray([n // 2, n - n // 2]),
        files=["synthetic_a", "synthetic_b"])
    store = src.to_device(3, device=dev, group=group, shard=True)
    model = init_weights(build_unet("unet", "resnet18", in_ch=3, classes=1),
                         torch.Generator().manual_seed(0)).to(dev)
    engine = Engine(model, LossManager(classes=1, name="dice_bce"),
                    make_optimizer(model.parameters(), 1e-3, 1e-4, 5.0),
                    classes=1, aug="light", group=group)
    batch = 2 * world
    perm = epoch_permutation(torch.Generator(device=dev).manual_seed(1), n,
                             batch)[:1]
    with f32_on_card(dev):
        losses = engine.train_steps(store, perm, torch.Generator(
            device=dev).manual_seed(2))
        vloss, vdice, viou = engine.validate(store, batch)
    return {"train_loss": float(losses[0]), "val_loss": vloss,
            "val_dice": vdice, "val_iou": viou}


class _TinyClassifyDS:
    """Seeded 1-channel 32x32 slices with labels, both classes present."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.y = (np.arange(n) % 2).astype(np.float32)
        self.x = (rng.standard_normal((n, 1, 32, 32))
                  + self.y[:, None, None, None]).astype(np.float32)
        pos = float(self.y.sum())
        self.weights = (1.0, (n - pos) / pos)

    def __len__(self) -> int:
        return len(self.y)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        idx = np.arange(len(self.y))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for i in range(0, len(idx), batch_size):
            j = idx[i:i + batch_size]
            yield self.x[j], self.y[j]


def _classifier_epoch(world: int, dev: torch.device,
                      group: Optional[DataGroup]) -> Dict[str, float]:
    """One epoch of the tiny ConvNeXt in f32 (batches of two a rank)."""
    with tempfile.TemporaryDirectory(prefix="dryrun_clf_") as td:
        args = ClassifierArgs(out_dir=td, model="tiny", epochs=1,
                              batch_size=2 * world, amp=False,
                              data_parallel=world if group else 1)
        h = ClassifierTrainer(args, _TinyClassifyDS(4 * world, 6),
                              _TinyClassifyDS(2 * world, 7), device=dev,
                              group=group).fit()["history"][0]
    return {"train_loss": h["train_loss"], "val_loss": h["val_loss"]}


def dryrun_rank(group: DataGroup, classify: bool) -> Dict[str, dict]:
    """The dry run's work on one rank of its group: the U-Net step and
    validation, and the classifier's epoch where ``classify``."""
    out = {"unet": _unet_step(group.world, group.device, group)}
    if classify:
        out["classifier"] = _classifier_epoch(group.world, group.device,
                                              group)
    return out


def dryrun_devices(n: int, device: str = "cuda"
                   ) -> Tuple[List[torch.device], str]:
    """``n`` rank devices: a card each where there are enough, else the
    cards shared round-robin; and what the printout says of them."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n, f"{n} CPU ranks"
    have = torch.cuda.device_count()
    devices = [torch.device("cuda", i % have) for i in range(n)]
    if have >= n:
        return devices, f"{n} ranks on {n} cards"
    return devices, f"{n} ranks sharing {have} card(s)"


def dryrun_check(ranks: List[dict], devices: List[torch.device],
                 where: str) -> dict:
    """Hold each rank's :func:`dryrun_rank` result to the same work on one
    device (``devices[0]``) and print both; raises where they disagree.
    Returns what ran, its numbers and what is not ported."""
    n_devices = len(ranks)
    backend = choose_backend(devices)
    classify = "classifier" in ranks[0]
    ref = {"unet": _unet_step(n_devices, devices[0], None)}
    if classify:
        ref["classifier"] = _classifier_epoch(n_devices, devices[0], None)
    tols = {"train_loss": TRAIN_TOL, "val_loss": VAL_TOL}
    for part, want in ref.items():
        for r, got in enumerate(ranks):
            for key, tol in tols.items():
                tol = CLASSIFY_TOL if part == "classifier" else tol
                if not abs(got[part][key] - want[key]) < tol:
                    raise AssertionError(
                        f"dryrun_multichip({n_devices}) {part} {key}: rank "
                        f"{r} {got[part][key]!r} != one device "
                        f"{want[key]!r} (tolerance {tol})")
    u, ur = ranks[0]["unet"], ref["unet"]
    print(f"dryrun_multichip({n_devices}) [{where}, {backend}]: "
          f"train_loss={u['train_loss']:.6f} val_loss={u['val_loss']:.6f} "
          f"val_dice={u['val_dice']:.4f} | one device "
          f"train_loss={ur['train_loss']:.6f} "
          f"val_loss={ur['val_loss']:.6f} (sharded == replicated within "
          f"{TRAIN_TOL}/{VAL_TOL})", flush=True)
    if classify:
        c, cr = ranks[0]["classifier"], ref["classifier"]
        print(f"dryrun_classifier_dp({n_devices} ranks): "
              f"train_loss={c['train_loss']:.6f} "
              f"val_loss={c['val_loss']:.6f} == one device "
              f"{cr['train_loss']:.6f}/{cr['val_loss']:.6f}", flush=True)
    print(f"dryrun_multichip({n_devices}) not ported yet (ROADMAP.md Queue "
          f"1 item 7b): {', '.join(NOT_PORTED)}", flush=True)
    return {"ran": ["unet_dp_sharded_store"]
            + (["classifier_dp"] if classify else []),
            "where": where, "backend": backend, "ranks": ranks[0],
            "one_device": ref, "not_ported": list(NOT_PORTED)}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The data-parallel dry run on ``n_devices`` ranks (module
    docstring); raises where sharded and one-device results disagree.
    Returns what it ran, its numbers and what it did not run."""
    devices, where = dryrun_devices(n_devices, device)
    ranks = spawn(dryrun_rank, n_devices, devices,
                  args=(n_devices % 2 == 0,), timeout_s=900.0)
    return dryrun_check(ranks, devices, where)
