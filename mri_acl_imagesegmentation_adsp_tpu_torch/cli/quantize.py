"""Export a post-training-quantized serving artifact.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/cli/quantize.py``:
``calibration_batches`` (:33), ``main`` (:50-94) and ``load_engine``
(:97). It folds BatchNorm, calibrates the activation scales on the head of
the listed packed volumes, quantizes to per-channel int8, and writes one
``.npz`` (``infer/quant.py:save_qtree``, the JAX package's layout) and a
``.meta.json`` sidecar with everything needed to rebuild the engine
without the checkpoint. Either package's ``load_engine`` reads either
package's artifact.

Usage:
  python -m mri_acl_imagesegmentation_adsp_tpu_torch.cli.quantize \\
      --ckpt runs/unet2d/best.ckpt --list lists/val.txt \\
      --out runs/unet2d/quant_int8.npz [--mode int8] \\
      [--calib-batches 4] [--calib-batch-size 16] [--device cuda]

Serve it with ``cli.infer --qtree <out>.npz`` or ``cli.serve --qtree``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.hbm_loader import read_list
from ..infer.quant import (DTYPES, QuantConfig, QuantizedUNet2D, dtype_name,
                           load_qtree, save_qtree)
from ..infer.segment import _neighbor_stack
from ..utils.device import resolve_device
from ..utils.imagenet import make_input_norm
from .infer import load_model_from_ckpt


def calibration_batches(list_txt: str, k: int, norm, n_batches: int,
                        batch_size: int, device: str | torch.device = "cpu"
                        ) -> list:
    """NCHW batches from the head of the listed packed volumes, one a
    volume: its first ``batch_size`` neighbour stacks, normalized as
    inference normalizes them."""
    batches = []
    for path in read_list(list_txt):
        if len(batches) >= n_batches:
            break
        with np.load(path) as z:
            vol = torch.from_numpy(z["img"].astype(np.float32)).to(device)
        x = _neighbor_stack(vol[:, 0], k)[:batch_size]
        batches.append(norm(x).float())
    if not batches:
        raise SystemExit(f"no volumes in {list_txt}")
    return batches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "Quantize a trained 2-D U-Net for serving (PyTorch)",
        allow_abbrev=False)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--list", dest="list_txt", required=True,
                   help="txt file of volume.npz paths (calibration data)")
    p.add_argument("--out", required=True, help="output .npz artifact path")
    p.add_argument("--mode", choices=("int8", "folded"), default="int8")
    p.add_argument("--calib-batches", type=int, default=4)
    p.add_argument("--calib-batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    args = p.parse_args(argv)

    # np.savez appends .npz to the data file, so the sidecar pairs with the
    # data under one name only if the suffix is fixed up front
    if not args.out.endswith(".npz"):
        args.out += ".npz"

    dev = resolve_device(args.device)
    model, margs = load_model_from_ckpt(args.ckpt, dev)
    if margs.get("model", "unet") not in ("unet", "unetpp"):
        raise SystemExit("quantize supports the unet/unetpp families")
    k = int(margs.get("k", 1))
    norm = make_input_norm(bool(margs.get("imagenet_norm")))
    calib = calibration_batches(args.list_txt, k, norm, args.calib_batches,
                                args.calib_batch_size, dev)
    eng, qtree = QuantizedUNet2D.from_model(
        model, calib, QuantConfig(mode=args.mode,
                                  compute_dtype=model.compute_dtype))
    save_qtree(args.out, qtree)

    meta = {
        "arch": eng.arch, "encoder": eng.encoder, "classes": eng.classes,
        "decoder_channels": list(eng.decoder_channels), "mode": args.mode,
        "compute_dtype": dtype_name(model.compute_dtype),
        "k": k, "imagenet_norm": bool(margs.get("imagenet_norm")),
        "calib": {"list": args.list_txt, "batches": len(calib),
                  "batch_size": args.calib_batch_size},
        "source_ckpt": args.ckpt,
    }
    with open(args.out + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    n_int8 = sum(int(leaf["w_q"].numel()) for leaf in qtree.values())
    print(f"[quantize] {args.out}: {len(qtree)} convs, "
          f"{n_int8 / 1e6:.1f} M int8 weights, mode={args.mode}")
    return 0


def load_engine(qtree_path: str, device: str | torch.device = "cpu"):
    """``(engine, qtree, meta)`` from an artifact and its sidecar, the tree
    on ``device``. The path may omit the ``.npz`` suffix."""
    if not qtree_path.endswith(".npz"):
        qtree_path += ".npz"
    with open(qtree_path + ".meta.json", "r", encoding="utf-8") as f:
        meta = json.load(f)
    eng = QuantizedUNet2D(
        meta["encoder"], meta["classes"], tuple(meta["decoder_channels"]),
        QuantConfig(mode=meta["mode"],
                    compute_dtype=DTYPES[meta["compute_dtype"]]),
        arch=meta["arch"])
    return eng, load_qtree(qtree_path, device), meta


if __name__ == "__main__":
    raise SystemExit(main())
