"""Slice-level classification augmentation, in numpy and scipy.

The port's own copy of
``mri_acl_imagesegmentation_adsp_tpu/classify/augment.py`` (the vendored
suite's ``utils/augmentation_slice_level.py``): a random subset of {shift,
contrast stretch, LR flip, rotate} for T2 and of {shift, LR flip, rotate}
applied jointly to (b1500, ADC) pairs. It draws from Python's ``random``
and numpy's global stream, as the reference does, so the same seeds give
the same images.
"""

from __future__ import annotations

import random
from random import randrange

import numpy as np
import scipy.ndimage as ndimage


def _rescale_intensity(img: np.ndarray, in_range) -> np.ndarray:
    """skimage's ``rescale_intensity(img, in_range)`` for float images:
    clip to ``in_range`` and map it linearly onto [0, 1]."""
    lo, hi = float(in_range[0]), float(in_range[1])
    x = np.clip(img, lo, hi)
    return (x - lo) / max(hi - lo, 1e-12)


def augment_image_t2(input_im_2d: np.ndarray):
    """A T2 slice -> ``(augmented, operation_list)``."""
    augmented_im = input_im_2d
    operation_list = np.unique(np.random.choice(4, 4, replace=True))

    if 0 in operation_list:
        augmented_im = ndimage.shift(
            augmented_im, [randrange(-3, 3), randrange(-16, 16)])
    if 1 in operation_list:
        lower_bound = np.percentile(augmented_im, randrange(10))
        upper_bound = np.percentile(augmented_im, randrange(90, 100))
        augmented_im = _rescale_intensity(augmented_im,
                                          (lower_bound, upper_bound))
    if 2 in operation_list:
        augmented_im = np.flip(augmented_im, axis=1)
    if 3 in operation_list:
        angle = random.randint(-12, 12)
        augmented_im = ndimage.rotate(augmented_im, angle, axes=(0, 1),
                                      mode="constant", cval=0.0,
                                      reshape=False)
    return augmented_im, operation_list


def augment_image_diffusion(b1500_in: np.ndarray, adc_in: np.ndarray):
    """A (b1500, ADC) pair transformed jointly -> ``(b1500, adc,
    operation_list)``."""
    augmented_im = np.stack((b1500_in, adc_in), axis=0)
    operation_list = np.unique(np.random.choice(3, 3, replace=True))

    if 0 in operation_list:
        dim1 = randrange(-3, 3)
        dim2 = randrange(-16, 16)
        for i in range(2):
            augmented_im[i] = ndimage.shift(augmented_im[i], [dim1, dim2])
    if 1 in operation_list:
        for i in range(2):
            augmented_im[i] = np.flip(augmented_im[i], axis=1)
    if 2 in operation_list:
        angle = random.randint(-12, 12)
        for i in range(2):
            augmented_im[i] = ndimage.rotate(augmented_im[i], angle,
                                             axes=(0, 1), mode="constant",
                                             cval=0.0, reshape=False)
    return augmented_im[0], augmented_im[1], operation_list
