"""ImageNet input normalization, shared by every serving path.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/utils/imagenet.py``. With
``imagenet_norm`` on, a 1-channel batch is replicated to 3 channels and
normalized with ImageNet's mean and std; off, the transform is the identity.
Here batches are NCHW."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def make_input_norm(imagenet_norm: bool):
    """(B, C, H, W) -> normalized (B, 3, H, W) when on; identity when off."""
    if not imagenet_norm:
        return lambda x: x

    def norm(x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
        return (x - mean) / std
    return norm
