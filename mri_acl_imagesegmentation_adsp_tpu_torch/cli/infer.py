"""Model loading for inference and serving.

Counterpart: ``load_model_from_ckpt`` in
``mri_acl_imagesegmentation_adsp_tpu/cli/infer.py:32-48``. The batch
inference CLI itself (``main``) is not ported yet."""

from __future__ import annotations

import json

import torch

from ..models.factory import build_unet
from ..train import checkpoint as ckpt_lib
from ..utils.device import resolve_device


def load_model_from_ckpt(ckpt_path: str, device: str | torch.device = "cuda"):
    """Rebuild the model from ``<ckpt>.args.json``, load its weights onto
    ``device`` in eval mode. Returns ``(model, args)``."""
    dev = resolve_device(device)
    with open(ckpt_path + ".args.json", "r", encoding="utf-8") as f:
        args = json.load(f)
    k = int(args.get("k", 1))
    in_ch = 3 if (k == 1 and args.get("imagenet_norm")) else k
    model = build_unet(args.get("model", "unet"),
                       args.get("encoder", "resnet34"), "none", in_ch=in_ch,
                       classes=int(args.get("classes", 1)))
    model.load_state_dict(ckpt_lib.load_best(ckpt_path))
    return model.to(dev).eval(), args
