"""Recon data transforms on real-pair numpy arrays.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/transforms.py``,
numpy only and copied as it is (the prostate code's ``data/transforms.py``):
``to_tensor`` (complex -> ``(..., 2)``), ``center_crop`` /
``complex_center_crop`` / ``center_crop_to_smallest`` (floor-divided
corners), ``normalize`` / ``normalize_instance``, ``VarNetSample`` and
``VarNetDataTransform``. A "tensor" here is a float32 real-pair ndarray; the
trainers move samples to the device themselves.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np


def to_tensor(data: np.ndarray) -> np.ndarray:
    """complex ndarray -> float32 (..., 2) real-pair (fastMRI to_tensor)."""
    if np.iscomplexobj(data):
        return np.stack([data.real, data.imag], axis=-1).astype(np.float32)
    return np.asarray(data, np.float32)


def tensor_to_complex_np(data: np.ndarray) -> np.ndarray:
    """(..., 2) pair -> complex64 (fastMRI tensor_to_complex_np)."""
    return (data[..., 0] + 1j * data[..., 1]).astype(np.complex64)


def center_crop(data: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Center crop the last two axes (transforms.py:45-68)."""
    if not (0 < shape[0] <= data.shape[-2] and 0 < shape[1] <= data.shape[-1]):
        raise ValueError("Invalid shapes.")
    w_from = (data.shape[-2] - shape[0]) // 2
    h_from = (data.shape[-1] - shape[1]) // 2
    return data[..., w_from:w_from + shape[0], h_from:h_from + shape[1]]


def complex_center_crop(data: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Center crop axes (-3, -2) of a (..., 2) pair (transforms.py:70-93)."""
    if not (0 < shape[0] <= data.shape[-3] and 0 < shape[1] <= data.shape[-2]):
        raise ValueError("Invalid shapes.")
    w_from = (data.shape[-3] - shape[0]) // 2
    h_from = (data.shape[-2] - shape[1]) // 2
    return data[..., w_from:w_from + shape[0], h_from:h_from + shape[1], :]


def center_crop_to_smallest(x: np.ndarray, y: np.ndarray):
    """Crop the larger of each pair to the smaller (transforms.py:95-119)."""
    smallest_width = min(x.shape[-1], y.shape[-1])
    smallest_height = min(x.shape[-2], y.shape[-2])
    return (center_crop(x, (smallest_height, smallest_width)),
            center_crop(y, (smallest_height, smallest_width)))


def normalize(data, mean, stddev, eps: Union[float, np.ndarray] = 0.0):
    return (data - mean) / (stddev + eps)


def normalize_instance(data: np.ndarray, eps: Union[float, np.ndarray] = 0.0):
    mean = data.mean()
    std = data.std(ddof=1)
    return normalize(data, mean, std, eps), mean, std


class VarNetSample(NamedTuple):
    kspace: np.ndarray
    target: np.ndarray
    espirit: np.ndarray
    fname: str
    slice_num: int
    max_value: float
    crop_size: Tuple[int, int]


class VarNetDataTransform:
    """Builds VarNetSamples from raw h5 arrays (transforms.py:187-251).

    With a ``mask_func`` (data/subsample.py) the k-space is prospectively
    undersampled on the fly; ``use_seed`` derives the mask seed from the
    filename so every slice of a volume sees the same mask (the vendored
    transform's documented contract, transforms.py:195-198). Masked
    columns become exact zeros — the VarNet DC term recovers the sampling
    pattern from them (``recon/varnet.py:VarNetBlock``)."""

    def __init__(self, mask_func=None, use_seed: bool = True):
        self.mask_func = mask_func
        self.use_seed = use_seed

    def __call__(self, kspace: np.ndarray, target: Optional[np.ndarray],
                 espirit: np.ndarray, attrs: Dict, fname: str,
                 slice_num: int) -> VarNetSample:
        if target is not None:
            target_t = to_tensor(target)
            max_value = attrs["max"]
        else:
            target_t = np.zeros((), np.float32)
            max_value = 0.0
        kspace_t = to_tensor(kspace)
        if self.mask_func is not None:
            from .subsample import apply_mask, seed_from_filename
            seed = seed_from_filename(fname) if self.use_seed else None
            kspace_t, _ = apply_mask(kspace_t, self.mask_func, seed)
        crop_size = (attrs["recon_size"][0], attrs["recon_size"][1])
        return VarNetSample(
            kspace=kspace_t,
            target=target_t,
            espirit=to_tensor(espirit),
            fname=fname,
            slice_num=slice_num,
            max_value=max_value,
            crop_size=crop_size,
        )
