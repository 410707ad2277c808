"""Driver entry points of the port: the flagship forward, and a
data-parallel dry run that checks itself.

Counterpart: ``__graft_entry__.py`` at the repository root:

- :func:`entry` (:30-44): the ResNet34-encoder U-Net in bf16 at 320x320,
  eval mode, with seeded random weights; returns ``(fn, example_args)``.
- :func:`dryrun_multichip` (:47-176, :178-238, :354-411): one
  data-parallel train step and one validation of a narrow U-Net (ResNet18
  encoder, 2.5-D ``k = 3``, light augmentation, 32x32, a row-sharded slice
  store, two samples a rank) on ``n`` ranks, and, for an even ``n``, one
  epoch of the tiny ConvNeXt classifier with its batches split over the
  ranks, one loss-and-gradient step of a one-cascade VarNet on a ``(data,
  coil)`` grid of the ranks (``_dryrun_varnet_tp``: 4 coil ranks where
  ``n`` is a multiple of 4, else 2), the T2 recon with its slices spread
  over ``n`` devices (``_dryrun_t2_sharded_recon``), one loss-and-gradient
  step of a two-cascade VarNet pipelined over pipes of two ranks
  (``_dryrun_varnet_pp``, :241-281) and one epoch of the 3-D U-Net
  trainer at ``spatial_parallel`` 2 (``_dryrun_unet3d_spatial``, :284-328;
  the ranks beyond two on the data axis); each held to the same work on
  one device (the JAX tolerances: train loss 1e-4, validation loss 5e-4,
  classifier losses 1e-4, VarNet loss 1e-5 and gradient drift 1e-3, T2
  rtol / atol 1e-5, the pipelined VarNet's loss 1e-6 and gradient drift
  1e-3, the 3-D train loss 1e-4), every rank to one device.
  ``NOT_PORTED`` is empty: the dry run runs every part of JAX's.

The ranks take one card each over NCCL where there are ``n`` cards; where
there are fewer, they share the cards over gloo and the printout says so.
They run on the CPU only when ``device="cpu"`` asks for it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .classify.trainer import ClassifierArgs, ClassifierTrainer
from .data.hbm_loader import SliceStore, epoch_permutation
from .models.factory import build_unet
from .models.fastmri_unet import init_fastmri_weights
from .models.unet2d import init_weights
from .parallel.mesh import (DataGroup, ReconGrid, average_flat,
                            choose_backend, grid_average, make_recon_grid,
                            spawn)
from .parallel.pipeline import pipeline_grads, varnet_apply_pipelined
from .recon.t2 import t2_reconstruction
from .recon.varnet import VarNet
from .train.engine import Engine
from .train.losses import LossManager
from .train.optim import make_optimizer
from .train.trainer3d import UNet3DArgs, UNet3DTrainer
from .utils.device import f32_on_card, resolve_device

NOT_PORTED: Tuple[str, ...] = ()
TRAIN_TOL, VAL_TOL, CLASSIFY_TOL = 1e-4, 5e-4, 1e-4
VARNET_LOSS_TOL, VARNET_DRIFT_TOL, T2_TOL = 1e-5, 1e-3, 1e-5
PP_LOSS_TOL, SPATIAL_TOL = 1e-6, 1e-4


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


def varnet_grid_shape(n: int) -> Tuple[int, int]:
    """``(n_data, n_coil)`` of the dry run's VarNet grid on ``n`` ranks."""
    n_coil = 4 if n % 4 == 0 else 2
    return n // n_coil, n_coil


def _varnet_tp(n_devices: int, dev: torch.device,
               grid: Optional[ReconGrid]) -> Dict[str, object]:
    """One loss-and-gradient step of a one-cascade f32 VarNet, ``loss =
    mean(|image|^2)`` over the global batch, on ``grid`` (its gradients
    averaged over the grid) or on one device."""
    n_data, n_coil = varnet_grid_shape(n_devices)
    rng = np.random.default_rng(3)
    shape = (max(2, n_data), 2 * n_coil, 1, 16, 16, 2)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    model = VarNet(aves=1, num_cascades=1, sens_chans=4, sens_pools=2,
                   chans=4, pools=2, mesh=grid)
    init_fastmri_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev)
    params = dict(model.named_parameters())
    with f32_on_card(dev):
        out = model(k.to(dev), e.to(dev))
        loss = torch.mean(out * out)
        grads = list(torch.autograd.grad(loss, list(params.values())))
        if grid is not None:
            *grads, loss = grid_average(grads + [loss.detach()], grid)
    return {"loss": float(loss.detach()),
            "grads": {n: g.detach().cpu().numpy()
                      for n, g in zip(params, grads)}}


def _varnet_pp(dev: torch.device, pipe: Optional[DataGroup]
               ) -> Dict[str, object]:
    """One loss-and-gradient step of a two-cascade f32 VarNet, ``loss =
    mean(|image|^2)`` over a batch of 2 (2 microbatches), its cascades
    pipelined over ``pipe`` (its gradients averaged over the pipe) or on
    one device."""
    rng = np.random.default_rng(4)
    k, e = (torch.from_numpy(rng.standard_normal(
        (2, 2, 1, 16, 16, 2)).astype(np.float32)).to(dev) for _ in range(2))
    model = VarNet(aves=1, num_cascades=2, sens_chans=4, sens_pools=2,
                   chans=4, pools=2)
    init_fastmri_weights(model, torch.Generator().manual_seed(0))
    model = model.to(dev)
    params = dict(model.named_parameters())
    with f32_on_card(dev):
        out = varnet_apply_pipelined(model, k, e, pipe, n_microbatches=2)
        loss = torch.mean(out * out)
        grads = pipeline_grads(loss, list(params.values()))
        if pipe is not None:
            *grads, loss = average_flat(grads + [loss.detach()], pipe)
    return {"loss": float(loss.detach()),
            "grads": {n: g.detach().cpu().numpy()
                      for n, g in zip(params, grads)}}


def _unet3d_spatial(dev: torch.device, group: Optional[DataGroup]
                    ) -> float:
    """One epoch's train loss of the (4, 8) 3-D U-Net trainer on a seeded
    8x16x16 volume (ROI 16x16x8, batch 2, two steps), on a ``(n / 2, 2)``
    (data, depth) grid of ``group`` or on one device."""
    rng = np.random.default_rng(5)
    img = rng.standard_normal((8, 1, 16, 16)).astype(np.float32)
    msk = np.zeros((8, 16, 16), np.uint8)
    msk[2:6, 4:12, 4:12] = 1
    with tempfile.TemporaryDirectory(prefix="dryrun_3d_") as td:
        os.makedirs(os.path.join(td, "v0"))
        vol = os.path.join(td, "v0", "volume.npz")
        np.savez_compressed(vol, img=img, msk=msk)
        lst = os.path.join(td, "list.txt")
        with open(lst, "w", encoding="utf-8") as f:
            f.write(vol + "\n")
        sp = 2 if group is not None else 1
        args = UNet3DArgs(train_list=lst, val_list=lst,
                          out_dir=os.path.join(td, "run"), roi=(16, 16, 8),
                          channels=(4, 8), classes=1, batch_size=2,
                          epochs=1, amp=False, samples_per_vol_train=2,
                          samples_per_vol_val=1, seed=23,
                          data_parallel=group.world // sp if group else 1,
                          spatial_parallel=sp)
        with f32_on_card(dev):
            return float(UNet3DTrainer(args, dev, group).train_one_epoch())


def _t2_sharded(devices: List[torch.device]) -> float:
    """The T2 recon of a seeded 2-slice case with its slices spread over
    ``devices`` against ``devices[0]`` alone; the largest difference."""
    rng = np.random.default_rng(8)
    s, c, h, w = 2, 2, 24, 20
    full = (rng.standard_normal((s, c, h, w))
            + 1j * rng.standard_normal((s, c, h, w)))
    under = full.copy()
    under[..., 1::2] = 0
    under[..., w // 2 - 4:w // 2 + 4] = full[..., w // 2 - 4:w // 2 + 4]
    kspace = np.stack([under] * 3)                  # (avg = 3, S, C, H, W)
    calib = full[..., w // 2 - 6:w // 2 + 6]        # (S, C, H, 12)
    want = t2_reconstruction(kspace, calib, device=devices[0])
    got = t2_reconstruction(kspace, calib, mesh=devices, device=devices[0])
    np.testing.assert_allclose(got["reconstruction_rss"],
                               want["reconstruction_rss"], rtol=T2_TOL,
                               atol=T2_TOL)
    return float(np.abs(got["reconstruction_rss"]
                        - want["reconstruction_rss"]).max())


def dryrun_rank(group: DataGroup, classify: bool) -> Dict[str, dict]:
    """The dry run's work on one rank of its group: the U-Net step and
    validation, and, where ``classify`` (an even world), the classifier's
    epoch, the VarNet step on a ``(data, coil)`` grid of the ranks, the
    pipelined VarNet step on pipes of two ranks and the 3-D trainer's
    epoch on a ``(n / 2, 2)`` (data, depth) grid."""
    out = {"unet": _unet_step(group.world, group.device, group)}
    if classify:
        out["classifier"] = _classifier_epoch(group.world, group.device,
                                              group)
        grid = make_recon_grid(group, *varnet_grid_shape(group.world))
        out["varnet_tp"] = _varnet_tp(group.world, group.device, grid)
        pipe = make_recon_grid(group, group.world // 2, 2).coil
        out["varnet_pp"] = _varnet_pp(group.device, pipe)
        out["unet3d_spatial"] = _unet3d_spatial(group.device, group)
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
    Returns what ran and its numbers (``not_ported`` is empty)."""
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
    ran = ["unet_dp_sharded_store"]
    if classify:
        c, cr = ranks[0]["classifier"], ref["classifier"]
        print(f"dryrun_classifier_dp({n_devices} ranks): "
              f"train_loss={c['train_loss']:.6f} "
              f"val_loss={c['val_loss']:.6f} == one device "
              f"{cr['train_loss']:.6f}/{cr['val_loss']:.6f}", flush=True)
        ref["varnet_tp"] = _check_varnet_tp(ranks, devices[0])
        ranks = [{**r, "varnet_tp": {"loss": r["varnet_tp"]["loss"]}}
                 for r in ranks]
        ref["t2_sharded_recon"] = {"max_abs_diff": _t2_sharded(devices)}
        print(f"dryrun_t2_sharded_recon({n_devices}-way slice mesh): "
              f"reconstruction_rss == unsharded (max difference "
              f"{ref['t2_sharded_recon']['max_abs_diff']:.1e}, rtol / atol "
              f"{T2_TOL})", flush=True)
        ref["varnet_pp"] = _check_varnet_pp(ranks, devices[0])
        ref["unet3d_spatial"] = {"train_loss": _check_unet3d_spatial(
            ranks, devices[0])}
        ranks = [{**r, "varnet_pp": {"loss": r["varnet_pp"]["loss"]}}
                 for r in ranks]
        ran += ["classifier_dp", "varnet_tp", "t2_sharded_recon",
                "varnet_pp", "unet3d_spatial"]
    return {"ran": ran, "where": where, "backend": backend,
            "ranks": ranks[0], "one_device": ref,
            "not_ported": list(NOT_PORTED)}


def _max_drift(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
               ) -> float:
    """The largest gradient distance by norm relative to its own (JAX's
    dry-run measure)."""
    return max(float(np.linalg.norm(got[n] - g) / (np.linalg.norm(g) + 1e-8))
               for n, g in want.items())


def _check_varnet_tp(ranks: List[dict], dev: torch.device) -> dict:
    """Hold every rank's grid VarNet step to one device: the loss within
    VARNET_LOSS_TOL, each gradient's relative distance (by norm) within
    VARNET_DRIFT_TOL, as JAX's ``_dryrun_varnet_tp`` holds them."""
    n = len(ranks)
    want = _varnet_tp(n, dev, None)
    drift = 0.0
    for r, got in enumerate(ranks):
        got = got["varnet_tp"]
        if not abs(got["loss"] - want["loss"]) < VARNET_LOSS_TOL:
            raise AssertionError(f"dryrun_varnet_tp rank {r}: loss "
                                 f"{got['loss']!r} != one device "
                                 f"{want['loss']!r}")
        drift = max(drift, _max_drift(got["grads"], want["grads"]))
    if not drift < VARNET_DRIFT_TOL:
        raise AssertionError(f"dryrun_varnet_tp: gradient drift "
                             f"{drift:.2e} >= {VARNET_DRIFT_TOL}")
    n_data, n_coil = varnet_grid_shape(n)
    print(f"dryrun_varnet_tp({n_data}x{n_coil} data x coil): "
          f"loss={ranks[0]['varnet_tp']['loss']:.6f} == one device "
          f"{want['loss']:.6f}, max grad drift {drift:.1e}", flush=True)
    return {"loss": want["loss"], "max_grad_drift": drift}


def _check_varnet_pp(ranks: List[dict], dev: torch.device) -> dict:
    """Hold every rank's pipelined VarNet step to one device: the loss
    within PP_LOSS_TOL, each gradient's drift within VARNET_DRIFT_TOL, as
    JAX's ``_dryrun_varnet_pp`` holds them."""
    want = _varnet_pp(dev, None)
    drift = 0.0
    for r, got in enumerate(ranks):
        got = got["varnet_pp"]
        if not abs(got["loss"] - want["loss"]) < PP_LOSS_TOL:
            raise AssertionError(f"dryrun_varnet_pp rank {r}: loss "
                                 f"{got['loss']!r} != one device "
                                 f"{want['loss']!r}")
        drift = max(drift, _max_drift(got["grads"], want["grads"]))
    if not drift < VARNET_DRIFT_TOL:
        raise AssertionError(f"dryrun_varnet_pp: gradient drift "
                             f"{drift:.2e} >= {VARNET_DRIFT_TOL}")
    print(f"dryrun_varnet_pp(2-stage pipe, 2 microbatches): "
          f"loss={ranks[0]['varnet_pp']['loss']:.6f} == one device "
          f"{want['loss']:.6f}, max grad drift {drift:.1e}", flush=True)
    return {"loss": want["loss"], "max_grad_drift": drift}


def _check_unet3d_spatial(ranks: List[dict], dev: torch.device) -> float:
    """Hold every rank's depth-sharded 3-D train loss to one device within
    SPATIAL_TOL (JAX's ``_dryrun_unet3d_spatial``); returns one device's."""
    want = _unet3d_spatial(dev, None)
    for r, got in enumerate(ranks):
        if not abs(got["unet3d_spatial"] - want) < SPATIAL_TOL:
            raise AssertionError(f"dryrun_unet3d_spatial rank {r}: train "
                                 f"loss {got['unet3d_spatial']!r} != one "
                                 f"device {want!r}")
    print(f"dryrun_unet3d_spatial(2-way depth axis): train_loss="
          f"{ranks[0]['unet3d_spatial']:.6f} == one device {want:.6f}",
          flush=True)
    return want


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The dry run on ``n_devices`` ranks (module docstring); raises where
    sharded and one-device results disagree. Returns what it ran and its
    numbers."""
    devices, where = dryrun_devices(n_devices, device)
    ranks = spawn(dryrun_rank, n_devices, devices,
                  args=(n_devices % 2 == 0,), timeout_s=900.0)
    return dryrun_check(ranks, devices, where)
