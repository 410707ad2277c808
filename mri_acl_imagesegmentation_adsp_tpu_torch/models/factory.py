"""Model factory. Counterpart: ``validate_encoder_weights`` and
``build_unet`` in ``mri_acl_imagesegmentation_adsp_tpu/models/factory.py``
(:20-68; the reference's ``src/models/unet_factory.py``)."""

from __future__ import annotations

import os

from torch import nn

from .unet2d import RESNET_CFG, ResNetEncoderUNet, UNetPlusPlus


def validate_encoder_weights(encoder_weights) -> str | None:
    """None for a random init ("none" / "null"), else the path of an existing
    checkpoint file; "imagenet" (a download) and anything else raise."""
    ew = str(encoder_weights)
    if ew.lower() in ("none", "null"):
        return None
    if os.path.exists(ew):
        return ew
    if ew.lower() == "imagenet":
        raise ValueError(
            "encoder_weights='imagenet' needs a weight download; this "
            "environment has no network. Pass a local torch ResNet "
            "checkpoint path instead (torchvision state_dict layout; smp "
            "'encoder.'-prefixed checkpoints also load)")
    raise ValueError(
        f"encoder_weights {encoder_weights!r} is neither 'none' nor an "
        "existing checkpoint file")


def build_unet(model: str = "unet", encoder: str = "resnet34",
               encoder_weights: str = "none", in_ch: int = 1,
               classes: int = 1, **kw) -> nn.Module:
    """Build a 2-D segmentation U-Net (``unet``) or UNet++ (``unetpp``,
    ``unetplusplus``) with random weights.

    ``encoder_weights`` is validated as the JAX factory does; a checkpoint
    path (a torch ResNet to import into the encoder) is not ported yet and
    raises."""
    if validate_encoder_weights(encoder_weights) is not None:
        raise NotImplementedError(
            "encoder_weights from a checkpoint is not ported yet "
            "(models/torch_import.py); use 'none'")
    if encoder not in RESNET_CFG:
        raise ValueError(f"unsupported encoder {encoder!r}; "
                         f"one of {sorted(RESNET_CFG)}")
    m = model.lower()
    if m == "unet":
        return ResNetEncoderUNet(encoder=encoder, in_ch=in_ch,
                                 classes=classes, **kw)
    if m in ("unetpp", "unetplusplus"):
        return UNetPlusPlus(encoder=encoder, in_ch=in_ch, classes=classes,
                            **kw)
    raise ValueError(f"Unsupported model: {model}")
