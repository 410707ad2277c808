"""One-record end-to-end smoke check.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/utils/smoke.py`` (the
reference's ``src/utils/main.py:12-60``): one record of a fastMRI
single-coil ``.h5`` directory through the adapter, the preprocess chain at
320x320, a ResNet34 U-Net forward (eval mode, weights drawn from a CPU
generator seeded 0) and the dice_bce loss against the body mask, on
``--device`` (default ``cuda``). Reading ``.h5`` needs h5py; without it the
adapter raises an ImportError that names it.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.utils.smoke \\
      --root <h5 dir> [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from ..data.adapters import FastMRISinglecoilAdapter
from ..data.preprocess import MRIKneePreprocessor
from ..models.factory import build_unet
from ..models.unet2d import init_weights
from ..train.losses import LossManager
from .device import resolve_device


def run_smoke(root: str, device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    adapter = FastMRISinglecoilAdapter(root_dir=root)
    records = adapter.discover_records()
    print(f"discovered {len(records)} slice records")
    record = adapter.load_record(records[len(records) // 2])
    out = MRIKneePreprocessor(out_size=(320, 320), device=dev
                              ).preprocess_record(record)
    print(f"preprocessed: img_z {tuple(out['img_z'].shape)} mask "
          f"{tuple(out['mask'].shape)} source={out['source']}")

    model = init_weights(build_unet("unet", "resnet34", "none", classes=1),
                         torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        logits = model(out["img_z"][None, None].float())
        y = out["mask"].float()[None, None]
        loss = float(LossManager(classes=1, name="dice_bce")(logits, y))
        pred_px = int((torch.sigmoid(logits[0, 0]) > 0.5).sum())
    print(f"forward: logits {tuple(logits.shape)} loss {loss:.4f} "
          f"pred px {pred_px}")
    return {"loss": loss, "pred_px": pred_px,
            "img_shape": tuple(out["img_z"].shape)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("one-record smoke check")
    p.add_argument("--root", required=True, help="dir of fastMRI .h5 files")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises")
    args = p.parse_args(argv)
    run_smoke(args.root, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
