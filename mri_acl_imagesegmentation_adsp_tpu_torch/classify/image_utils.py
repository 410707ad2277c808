"""Classification preprocessing helpers, in numpy.

The port's own copy of
``mri_acl_imagesegmentation_adsp_tpu/classify/image_utils.py:24-113`` (the
vendored suite's ``utils/image_utils.py``): ADC clipping at 3000 / 3053,
the five normalisation schemes, the center crop whose corners truncate
like ``int()``, and per-slice resizes. A resize uses OpenCV where it is
installed, as the reference does; without it, the port's bilinear resize
(``ops/imageops.py:resize_bilinear``) on the CPU, as the JAX package
falls back to its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.imageops import resize_bilinear

_ADC_CLIP = 3000.0          # image_utils.py:6-22 of the reference
_ADC_CLIP_ALT = 3053.0      # image_utils.py:90-102
_SCHEME5_MEAN = 0.19233476646025852   # image_utils.py:55-88 (torchvision)
_SCHEME5_STD = 0.1625128199949673


def normalise_adc(adc_image_in: np.ndarray) -> np.ndarray:
    """Clip ADC to the 3000 ceiling, then scale into [0, 1] by the max."""
    clipped = np.minimum(np.asarray(adc_image_in, dtype=np.float64),
                         _ADC_CLIP)
    return clipped / clipped.max()


def norm_adc(image_2d: np.ndarray) -> np.ndarray:
    """Variant ADC normalisation: 3053 ceiling, max-scaled."""
    clipped = np.minimum(image_2d, _ADC_CLIP_ALT)
    return clipped / clipped.max()


def norm_b1500(image_2d: np.ndarray) -> np.ndarray:
    """Per-image z-score for computed-b1500 maps."""
    return ((image_2d - image_2d.mean(axis=(0, 1), keepdims=True))
            / image_2d.std(axis=(0, 1), keepdims=True))


def center_crop_2d(im_2d: np.ndarray, crop_to_size) -> np.ndarray:
    """Center crop with ``int()``-truncated corners: on an odd size
    difference the window sits half a pixel toward the origin."""
    want_w, want_h = crop_to_size[0], crop_to_size[1]
    off_x = im_2d.shape[1] / 2 - want_w / 2
    off_y = im_2d.shape[0] / 2 - want_h / 2
    return im_2d[int(off_y):int(off_y + want_h),
                 int(off_x):int(off_x + want_w)]


def normalisation_2d(image_2d: np.ndarray, type_of_norm: int) -> np.ndarray:
    """The five schemes. 1: clip to the [p1, p99] band, scale by the
    clipped max. 2: per-image z-score. 3: min-max to [0, 1]. 4: divide by
    (mean + 3 std), clamp to [0, 1]. 5: min-max, then standardize with the
    reference's constants."""
    x = np.asarray(image_2d)
    if type_of_norm == 1:
        lo, hi = np.percentile(x, [1, 99])
        banded = np.clip(x, lo, hi)
        return banded / banded.max()
    if type_of_norm == 2:
        return norm_b1500(x)
    if type_of_norm == 3:
        lo = x.min()
        return (x - lo) / (x.max() - lo)
    if type_of_norm == 4:
        scaled = x / (np.nanmean(x) + 3.0 * np.nanstd(x))
        return np.clip(scaled, 0.0, 1.0)
    if type_of_norm == 5:
        lo, hi = x.min(), x.max()
        unit = (x - lo) / max(hi - lo, 1e-12)
        return (unit - _SCHEME5_MEAN) / _SCHEME5_STD
    raise ValueError(f"unknown norm type {type_of_norm}")


def _resize_slice(image_2d: np.ndarray, shape, cv2_interp: str) -> np.ndarray:
    """One 2-D resize: OpenCV's when installed, else bilinear."""
    try:
        import cv2
    except ImportError:
        return resize_bilinear(torch.from_numpy(
            np.ascontiguousarray(image_2d, np.float32)), shape).numpy()
    interp = {"cubic": cv2.INTER_CUBIC, "area": cv2.INTER_AREA,
              "linear": cv2.INTER_LINEAR}[cv2_interp]
    return cv2.resize(image_2d, (shape[0], shape[1]), interpolation=interp)


def resize_2d(image_2d: np.ndarray, shape, interpolation: str = "cubic"
              ) -> np.ndarray:
    """``cv2.resize`` for the DWI loader (INTER_CUBIC by default)."""
    return _resize_slice(image_2d, shape, interpolation)


def diffusion_resize(image_3d: np.ndarray, resize_shape) -> np.ndarray:
    """Per-slice area resize of an ``(S, H, W)`` volume."""
    return np.stack([
        _resize_slice(image_3d[i], resize_shape, "area")
        for i in range(image_3d.shape[0])
    ]).astype(np.float64, copy=False)
