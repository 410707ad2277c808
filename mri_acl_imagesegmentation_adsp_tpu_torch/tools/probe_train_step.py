"""Probe how far one full-width train step's gradients can agree.

    python -m mri_acl_imagesegmentation_adsp_tpu_torch.tools.probe_train_step \\
        --out chiprun_out/probe_step.json

The step of ``chip_smoke.py`` phase 6's card-vs-CPU check: the reference
ResNet34 U-Net (320x320, seeded random weights), the dice_bce loss, two
slices of a synthetic volume packed on the card. Its gradients are
computed several ways and each is held against a float64 reference on the
CPU:

- ``card_f64``: float64 on the card; the same function, so it should agree
  to float64 rounding (``chip_smoke.py`` holds it to 1e-6);
- ``cpu_f64_ulp``: float64 on the CPU with the input moved by one float32
  ulp, which shows how much the gradient moves under a perturbation of
  that size;
- ``cpu_f32`` and ``card_f32``: the port's f32 path (``Engine.grads_one``,
  TF32 off);
- ``cpu_f32_ulp``: that path on the CPU with the input moved by one ulp.

For each: the loss's relative error and, over the gradient tensors,
the worst and the median of ``max|g - g_ref| / max|g_ref|``. The float64
runs use the model's modules and the loss's formula without the f32 casts
of the training path (BatchNorm keeps float64 for a float64 input). Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile

import numpy as np
import torch

from ..data.hbm_loader import SliceStore
from ..data.packer import pack_kspace_volume
from ..data.preprocess import MRIKneePreprocessor
from ..models.factory import build_unet
from ..models.unet2d import init_weights
from ..train.engine import Engine
from ..train.losses import LossManager
from ..train.optim import make_optimizer
from ..utils.synthetic import synthetic_kspace_pairs


def forward_any_dtype(model, x):
    """``ResNetEncoderUNet.forward`` in the parameters' own dtype."""
    feats = model.encoder(x)
    skips = [feats[4], feats[3], feats[2], feats[1], None]
    y = feats[5]
    for block, skip in zip(model.decoder, skips):
        y = block(y, skip)
    return model.head(y)


def dice_bce_any_dtype(logits, t):
    """``train/losses.py`` dice_bce (weights 0.5, 0.5) without its casts."""
    n = logits.shape[0]
    p = torch.sigmoid(logits).reshape(n, 1, -1)
    tf = t.reshape(n, 1, -1)
    inter = (p * tf).sum(dim=(0, 2))
    card = (p + tf).sum(dim=(0, 2))
    score = 2.0 * inter / torch.clamp_min(card, 1e-7)
    dice = torch.mean((1.0 - score) * (tf.sum(dim=(0, 2)) > 0))
    bce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * t
           + torch.log1p(torch.exp(-torch.abs(logits)))).mean()
    return 0.5 * dice + 0.5 * bce


def grads_f64(model, x, y, dev):
    """Loss and gradients of one train-mode step of a copy of ``model`` in
    float64 on ``dev``; the gradients on the CPU."""
    m = copy.deepcopy(model).to(dev, torch.float64).train()
    loss = dice_bce_any_dtype(forward_any_dtype(m, x.to(dev,
                                                          torch.float64)),
                               y.to(dev, torch.float64)[:, None])
    grads = torch.autograd.grad(loss, list(m.parameters()))
    return float(loss.detach()), [g.cpu() for g in grads]


def grads_f32(model, x, y, dev):
    m = copy.deepcopy(model).to(dev)
    eng = Engine(m, LossManager(), make_optimizer(m.parameters(), 1e-3, 1e-4,
                                                  5.0), aug="none")
    loss, grads = eng.grads_one(x.to(dev), y.to(dev), None)
    return float(loss), [g.double().cpu() for g in grads]


def _one_ulp(x, seed=0):
    """``x`` with every element moved by one float32 ulp, up or down."""
    sign = torch.randint(0, 2, x.shape, generator=torch.Generator()
                         .manual_seed(seed)) * 2 - 1
    return torch.nextafter(x, torch.where(sign > 0, torch.inf, -torch.inf))


def probe(dev: torch.device, encoder: str = "resnet34",
          hw: int = 320, kspace_hw=(640, 368)) -> dict:
    """The comparison at the reference's full width by default (smaller
    sizes rehearse it)."""
    with tempfile.TemporaryDirectory() as tmp:
        pre = MRIKneePreprocessor(out_size=(hw, hw), device=dev)
        pack_kspace_volume(pre, synthetic_kspace_pairs(seed=0, s=35,
                                                       h=kspace_hw[0],
                                                       w=kspace_hw[1]),
                           os.path.join(tmp, "vol"))
        src = SliceStore.from_files([os.path.join(tmp, "vol",
                                                  "volume.npz")])
    x = torch.from_numpy(src.images[:2, None].copy())
    y = torch.from_numpy(src.masks[:2].astype(np.uint8))
    model = init_weights(build_unet("unet", encoder),
                         torch.Generator().manual_seed(7))
    names = [n for n, _ in model.named_parameters()]
    cpu = torch.device("cpu")
    ref_loss, ref = grads_f64(model, x, y, cpu)
    runs = {"card_f64": grads_f64(model, x, y, dev),
            "cpu_f64_ulp": grads_f64(model, _one_ulp(x), y, cpu),
            "cpu_f32": grads_f32(model, x, y, cpu),
            "card_f32": grads_f32(model, x, y, dev),
            "cpu_f32_ulp": grads_f32(model, _one_ulp(x), y, cpu)}
    out = {"batch": list(x.shape), "loss_f64": ref_loss}
    for side, (loss, grads) in runs.items():
        rel = [float((g - r).abs().max() / (r.abs().max() + 1e-300))
               for g, r in zip(grads, ref)]
        out[side] = {"loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                     "grad_worst_rel": max(rel),
                     "grad_worst_tensor": names[int(np.argmax(rel))],
                     "grad_median_rel": float(np.median(rel)),
                     "tensors_within_1e-3": int(sum(r <= 1e-3
                                                    for r in rel)),
                     "tensors": len(rel)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 allow_abbrev=False)
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_train_step needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = probe(torch.device("cuda"))
    out["card"] = torch.cuda.get_device_name(0)
    text = json.dumps(out)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
