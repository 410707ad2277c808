"""Model factory. Counterpart: ``build_unet`` in
``mri_acl_imagesegmentation_adsp_tpu/models/factory.py:38-65`` (the
``model="unet"`` family only; UNet++ is not ported yet)."""

from __future__ import annotations

from .unet2d import RESNET_CFG, ResNetEncoderUNet


def build_unet(model: str = "unet", encoder: str = "resnet34",
               encoder_weights: str = "none", in_ch: int = 1,
               classes: int = 1, **kw) -> ResNetEncoderUNet:
    """Build a 2-D segmentation U-Net with random weights.

    ``encoder_weights`` other than "none" (a torch ResNet checkpoint to
    import into the encoder) is not ported yet and raises."""
    if str(encoder_weights).lower() not in ("none", "null"):
        raise NotImplementedError(
            "encoder_weights from a checkpoint is not ported yet "
            "(models/torch_import.py); use 'none'")
    if model.lower() != "unet":
        raise ValueError(f"Unsupported model: {model} (the port builds "
                         "'unet'; UNet++ is not ported yet)")
    if encoder not in RESNET_CFG:
        raise ValueError(f"unsupported encoder {encoder!r}; "
                         f"one of {sorted(RESNET_CFG)}")
    return ResNetEncoderUNet(encoder=encoder, in_ch=in_ch, classes=classes,
                             **kw)
