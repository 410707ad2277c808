"""Batch segmentation inference over packed volumes, and model loading.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/infer.py``:
``load_model_from_ckpt`` (:32-48), ``main`` (:57-148) and ``_run``
(:238-284). Per volume of the list it writes ``<out-dir>/<volume dir>/
pred_mask.npy`` (and ``probs.npz`` with ``--save-probs``), with
``--metrics`` the volume's Dice, IoU, HD95 and ASSD against the packed mask
(``infer/segment.py:evaluate_volume``), and ``<out-dir>/summary.json``.

A checkpoint trained with ``amp`` runs in bf16 (``torch.autocast``), as the
JAX CLI builds its model with ``dtype=bfloat16``; any other runs in f32
with TF32 off. ``--quant int8|folded`` quantizes the checkpoint on the
first listed volume's first 16 slices (``infer/quant.py``); ``--qtree``
serves a ``cli.quantize`` artifact, with no checkpoint needed, and an
explicit ``--quant`` overrides the artifact's mode. ``--data-parallel N``
runs each batch split over ``N`` model replicas in this process, on
``cuda:0`` .. ``cuda:N-1`` (fewer cards raise), or ``N`` CPU replicas with
``--device cpu`` (``infer/segment.py:ReplicatedApply``); 2-D only.
``--ckpt3d --spatial-parallel N`` spawns ``N`` ranks
(``parallel/mesh.py:spawn``, ``cuda:0`` .. ``cuda:N-1``, or CPU ranks with
``--device cpu``; fewer cards raise "requested N devices, have M"), each
running its depth band of every padded whole volume through the 3-D U-Net
(``parallel/spatial.py:unet3d_depth_sharded_apply``, halo exchanges
between neighbouring ranks); rank 0 receives the logits and writes the
files, as JAX's GSPMD run gathers them.

Usage:
  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer \\
      --ckpt runs/unet2d/best.ckpt --list lists/val.txt --out-dir preds \\
      [--metrics] [--tta hflip] [--batch-size 16] [--device cuda] \\
      [--quant none|int8|folded] [--qtree quant_int8.npz]
  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.infer \\
      --ckpt3d runs/unet3d/best3d.ckpt --list lists/val.txt --metrics
"""

from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from ..data.hbm_loader import read_list
from ..infer.quant import QuantConfig, QuantizedUNet2D
from ..infer.segment import (
    ReplicatedApply, evaluate_volume, segment_volume_2d, threshold_probs,
    tree_to)
from ..models.factory import build_unet, build_unet3d
from ..parallel.mesh import DataGroup, mesh_devices, spawn
from ..parallel.spatial import unet3d_depth_sharded_apply
from ..train import checkpoint as ckpt_lib
from ..utils.device import f32_on_card, resolve_device
from ..utils.imagenet import make_input_norm


def load_model_from_ckpt(ckpt_path: str, device: str | torch.device = "cuda"):
    """Rebuild the model from ``<ckpt>.args.json``, load its weights onto
    ``device`` in eval mode. Returns ``(model, args)``; the model's
    ``compute_dtype`` is bf16 for an ``amp`` checkpoint, else f32, and
    :func:`model_apply_fn` runs it so."""
    dev = resolve_device(device)
    with open(ckpt_path + ".args.json", "r", encoding="utf-8") as f:
        args = json.load(f)
    k = int(args.get("k", 1))
    in_ch = 3 if (k == 1 and args.get("imagenet_norm")) else k
    model = build_unet(args.get("model", "unet"),
                       args.get("encoder", "resnet34"), "none", in_ch=in_ch,
                       classes=int(args.get("classes", 1)))
    model.load_state_dict(ckpt_lib.load_best(ckpt_path))
    model.compute_dtype = (torch.bfloat16 if args.get("amp")
                           else torch.float32)
    return model.to(dev).eval(), args


def model_apply_fn(model: torch.nn.Module, norm: Callable) -> Callable:
    """``x -> f32 logits`` of ``model`` on normalized ``x`` in its
    ``compute_dtype``: under bf16 autocast for bf16 (convolutions, the
    BatchNorm affine and the activations in bf16), plain f32 otherwise.
    The autocast is entered in the calling thread, so the function runs as
    well on a serving worker thread."""
    bf16 = getattr(model, "compute_dtype", torch.float32) == torch.bfloat16
    dev_type = next(model.parameters()).device.type

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(dev_type, dtype=torch.bfloat16, enabled=bf16):
            return model(norm(x)).float()
    return apply_fn


def replicated(make: Callable[[torch.device, int], Callable],
               devices: Sequence[torch.device]) -> Callable:
    """``make(device, i)`` on one device, else a :class:`ReplicatedApply`
    of one ``make(devices[i], i)`` a device."""
    if len(devices) == 1:
        return make(devices[0], 0)
    return ReplicatedApply([make(d, i) for i, d in enumerate(devices)],
                           devices)


def model_replicas(model: torch.nn.Module, norm: Callable,
                   devices: Sequence[torch.device]) -> Callable:
    """:func:`model_apply_fn` of ``model`` (on ``devices[0]``) and of a copy
    of it on each further device."""
    return replicated(lambda d, i: model_apply_fn(
        model if i == 0 else copy.deepcopy(model).to(d), norm), devices)


def qtree_replicas(eng: QuantizedUNet2D, qtree, norm: Callable,
                   devices: Sequence[torch.device]) -> Callable:
    """The quantized ``eng`` on ``qtree`` (on ``devices[0]``) and on a copy
    of the tree on each further device."""
    def make(d, i):
        tree = qtree if i == 0 else tree_to(qtree, d)
        return lambda x: eng.apply(tree, norm(x))
    return replicated(make, devices)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "Whole-volume segmentation inference (PyTorch)", allow_abbrev=False)
    p.add_argument("--ckpt", help="best checkpoint (train/checkpoint.py "
                                  "format) with its .args.json beside it; "
                                  "optional with --qtree or --ckpt3d")
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
    p.add_argument("--quant", choices=("none", "int8", "folded"),
                   default="none",
                   help="post-training quantized inference "
                        "(infer/quant.py): int8 = w8a8 convs with int32 "
                        "sums, folded = BN-folded convs in the compute "
                        "dtype")
    p.add_argument("--qtree",
                   help="quantized artifact from cli.quantize; serves "
                        "without the checkpoint")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="model replicas to split each batch over, one card "
                        "each (CPU replicas with --device cpu)")
    p.add_argument("--ckpt3d",
                   help="3-D checkpoint (trainer3d best3d.ckpt): whole-"
                        "volume 3-D inference instead of 2-D slices")
    p.add_argument("--spatial-parallel", type=int, default=1,
                   help="with --ckpt3d: ranks to depth-shard each whole "
                        "volume over, one card each (CPU ranks with "
                        "--device cpu)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.data_parallel < 1:
        p.error(f"--data-parallel {args.data_parallel} is below 1")
    if args.spatial_parallel < 1:
        p.error(f"--spatial-parallel {args.spatial_parallel} is below 1")
    if args.spatial_parallel > 1 and not args.ckpt3d:
        p.error(f"--spatial-parallel {args.spatial_parallel} depth-shards a "
                "--ckpt3d volume; 2-D batches split with --data-parallel")
    if args.ckpt3d and args.data_parallel != 1:
        p.error(f"--data-parallel {args.data_parallel} splits 2-D batches; "
                "--ckpt3d infers a whole volume at once")
    if args.ckpt3d and args.spatial_parallel > 1:
        n = args.spatial_parallel
        spawn(run_3d_rank, n, mesh_devices(n, args.device), args=(args,),
              timeout_s=1e6)
        return 0
    if args.ckpt3d:
        dev = resolve_device(args.device)
        with f32_on_card(dev):
            return _run_3d(args, dev)
    if not args.ckpt and not args.qtree:
        p.error("one of --ckpt / --qtree / --ckpt3d is required")

    dev = resolve_device(args.device)
    devices = [dev]
    if args.data_parallel > 1:
        devices = mesh_devices(args.data_parallel, args.device)
        dev = devices[0]
    if args.qtree:
        from .quantize import load_engine
        eng, qtree, meta = load_engine(args.qtree, dev)
        if args.quant not in ("none", meta["mode"]):
            # an explicit --quant overrides the artifact's mode
            eng = QuantizedUNet2D(
                meta["encoder"], meta["classes"],
                tuple(meta["decoder_channels"]),
                QuantConfig(mode=args.quant,
                            compute_dtype=eng.config.compute_dtype),
                arch=meta["arch"])
        k, classes = int(meta["k"]), int(meta["classes"])
        norm = make_input_norm(bool(meta["imagenet_norm"]))
        apply_fn = qtree_replicas(eng, qtree, norm, devices)
    else:
        model, margs = load_model_from_ckpt(args.ckpt, dev)
        k, classes = int(margs.get("k", 1)), int(margs.get("classes", 1))
        norm = make_input_norm(bool(margs.get("imagenet_norm")))
        if args.quant != "none":
            if margs.get("model", "unet") not in ("unet", "unetpp"):
                raise SystemExit("--quant supports the unet/unetpp families")
            from .quantize import calibration_batches
            calib = calibration_batches(args.list_txt, k, norm, 1, 16, dev)
            eng, qtree = QuantizedUNet2D.from_model(
                model, calib, QuantConfig(mode=args.quant,
                                          compute_dtype=model.compute_dtype))
            apply_fn = qtree_replicas(eng, qtree, norm, devices)
        else:
            apply_fn = model_replicas(model, norm, devices)

    with f32_on_card(dev):
        return _run(args, apply_fn, k, classes, dev)


def load_model3d_from_ckpt(ckpt_path: str,
                           device: str | torch.device = "cuda"):
    """The 3-D model of ``<ckpt>.args.json`` (bf16 compute for an ``amp``
    checkpoint) with its weights, on ``device`` in eval mode; returns
    ``(model, args)``."""
    with open(ckpt_path + ".args.json", "r", encoding="utf-8") as f:
        margs = json.load(f)
    model = build_unet3d(
        channels=tuple(margs.get("channels", (32, 64, 128, 256, 320))),
        classes=int(margs.get("classes", 1)),
        dtype=torch.bfloat16 if margs.get("amp") else torch.float32)
    model.load_state_dict(ckpt_lib.load_best(ckpt_path))
    return model.to(resolve_device(device)).eval(), margs


def run_3d_rank(group: DataGroup, args) -> int:
    """One spawned rank of ``--ckpt3d --spatial-parallel``."""
    with f32_on_card(group.device):
        return _run_3d(args, group.device, group)


def _run_3d(args, dev: torch.device, group: DataGroup | None = None) -> int:
    """Whole-volume 3-D inference, on one device or as one rank of
    ``group`` (each volume depth-sharded over its ranks; rank 0 writes)."""
    model, margs = load_model3d_from_ckpt(args.ckpt3d, dev)
    runner = unet3d_depth_sharded_apply(model, group)
    classes = int(margs.get("classes", 1))
    primary = group is None or group.primary
    out_root = Path(args.out_dir)
    if primary:
        out_root.mkdir(parents=True, exist_ok=True)
    summary = []
    for path in read_list(args.list_txt):
        with np.load(path) as z:
            vol = z["img"].astype(np.float32)      # (S,1,H,W)
            gt = z["msk"].astype(np.uint8)
        s0, h0, w0 = vol.shape[0], vol.shape[2], vol.shape[3]
        with torch.inference_mode():
            logits = runner(torch.from_numpy(_volume_input(vol)).to(dev))[
                0, :, :s0, :h0, :w0]
            if not primary:
                continue
            if classes == 1:
                probs = torch.sigmoid(logits[0])            # (S,H,W)
                pred = (probs > args.threshold).to(torch.uint8)
            else:
                probs = torch.softmax(logits, dim=0).permute(1, 2, 3, 0)
                pred = probs.argmax(dim=-1).to(torch.uint8)

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
        msg = (f"[infer3d] {Path(path).parent.name}: whole volume "
               f"{vol.shape[0]} slices"
               + (f" over {group.world} shards" if group is not None
                  else ""))
        if "dice" in entry:
            msg += f" dice {entry['dice']:.4f}"
        print(msg)

    if primary:
        with (out_root / "summary.json").open("w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2)
    return 0


def _volume_input(vol: np.ndarray) -> np.ndarray:
    """A packed ``(S, 1, H, W)`` volume as the 3-D model's ``(1, 1, S, H,
    W)`` input: the per-volume z-score of the 3-D sampler
    (``train/trainer3d.py``), zero-padded (S, H, W) to the model's 2^4
    stride (the caller crops the logits back)."""
    vol = vol.astype(np.float32)
    mu, sd = float(vol.mean()), float(vol.std() + 1e-6)
    x = ((vol - mu) / sd)[None, :, 0][:, None]   # (1,1,S,H,W)
    pads = [(0, -d % 16) for d in x.shape[2:]]
    if any(p[1] for p in pads):
        x = np.pad(x, [(0, 0), (0, 0), *pads])
    return x


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
