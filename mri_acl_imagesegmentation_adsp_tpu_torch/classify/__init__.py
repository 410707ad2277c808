"""Slice-level lesion classification (ConvNeXt on T2 / DWI recons)."""

from .image_utils import (
    center_crop_2d, normalisation_2d, normalise_adc, norm_adc, norm_b1500,
    diffusion_resize,
)
from .augment import augment_image_t2, augment_image_diffusion
from .dataset import T2SliceDataset, DWISliceDataset, weighted_bce_loss
from .trainer import ClassifierArgs, ClassifierTrainer, roc_auc

__all__ = [
    "center_crop_2d", "normalisation_2d", "normalise_adc", "norm_adc",
    "norm_b1500", "diffusion_resize",
    "augment_image_t2", "augment_image_diffusion",
    "T2SliceDataset", "DWISliceDataset", "weighted_bce_loss",
    "ClassifierArgs", "ClassifierTrainer", "roc_auc",
]
