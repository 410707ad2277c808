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
    ``unetplusplus``) with torch's default init.

    ``encoder_weights`` is validated as the JAX factory does; a checkpoint
    path loads a torchvision-layout ResNet into the encoder
    (``models/torch_import.py``), so only the decoder and head keep their
    fresh values. The trainer seeds its own init and imports the encoder
    after it."""
    path = validate_encoder_weights(encoder_weights)
    if encoder not in RESNET_CFG:
        raise ValueError(f"unsupported encoder {encoder!r}; "
                         f"one of {sorted(RESNET_CFG)}")
    m = model.lower()
    if m == "unet":
        net = ResNetEncoderUNet(encoder=encoder, in_ch=in_ch,
                                classes=classes, **kw)
    elif m in ("unetpp", "unetplusplus"):
        net = UNetPlusPlus(encoder=encoder, in_ch=in_ch, classes=classes,
                           **kw)
    else:
        raise ValueError(f"Unsupported model: {model}")
    if path is not None:
        from .torch_import import apply_encoder_weights
        apply_encoder_weights(net, path, encoder)
    return net
