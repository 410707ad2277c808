"""Prospective k-space undersampling masks (fastMRI-style mask functions).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/subsample.py``, numpy
only and copied as it is, so one seed gives the JAX package's masks bit for
bit: random or equispaced phase-encode column masks with a fully sampled
centre band, seeded per volume (``seed_from_filename``) so that every slice
of a volume sees the same mask. ``apply_mask`` works on the real-pair
``(..., W, 2)`` layout or on complex arrays; masked columns become exact
zeros, which VarNet's soft data consistency reads as "not sampled".
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class MaskFunc:
    """Base sampler: picks a (center_fraction, acceleration) pair per call
    and builds a phase-encode column mask of shape (1, 1, W, 1) that
    broadcasts over (coils, readout, pe, re/im)."""

    def __init__(self, center_fractions: Sequence[float],
                 accelerations: Sequence[int]):
        if len(center_fractions) != len(accelerations):
            raise ValueError(
                "center_fractions and accelerations must pair up")
        self.center_fractions = list(center_fractions)
        self.accelerations = list(accelerations)

    def __call__(self, shape: Sequence[int],
                 seed: Optional[int] = None) -> np.ndarray:
        """shape: (..., W, 2) k-space shape whose second-to-last dim is the
        phase-encode axis. Returns a float32 mask broadcastable to it."""
        if len(shape) < 3:
            raise ValueError("mask shape needs at least (H, W, 2)")
        num_cols = shape[-2]
        rng = np.random.default_rng(seed)
        choice = rng.integers(0, len(self.accelerations))
        cf = self.center_fractions[choice]
        accel = self.accelerations[choice]
        mask = self._column_mask(num_cols, cf, accel, rng)
        out_shape = [1] * len(shape)
        out_shape[-2] = num_cols
        return mask.astype(np.float32).reshape(out_shape)

    def _column_mask(self, num_cols: int, cf: float, accel: int,
                     rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


class RandomMaskFunc(MaskFunc):
    """Uniform-random columns + fully-sampled center band: each off-center
    column is kept with probability p chosen so the expected total keeps
    num_cols/accel columns (the fastMRI random mask definition)."""

    def _column_mask(self, num_cols, cf, accel, rng):
        num_low = round(num_cols * cf)
        p = (num_cols / accel - num_low) / (num_cols - num_low)
        mask = rng.uniform(size=num_cols) < p
        pad = (num_cols - num_low + 1) // 2
        mask[pad:pad + num_low] = True
        return mask


class EquispacedMaskFunc(MaskFunc):
    """Equispaced columns (random offset) + fully-sampled center band,
    spaced so the overall acceleration matches after the center is added."""

    def _column_mask(self, num_cols, cf, accel, rng):
        num_low = round(num_cols * cf)
        # spacing that yields num_cols/accel total columns once the center
        # band's num_low are included
        adjusted = (accel * (num_low - num_cols)
                    / (num_low * accel - num_cols))
        mask = np.zeros(num_cols, bool)
        offset = rng.integers(0, round(adjusted) if adjusted >= 1 else 1)
        idx = np.arange(offset, num_cols - 1, adjusted)
        mask[np.around(idx).astype(np.int64)] = True
        pad = (num_cols - num_low + 1) // 2
        mask[pad:pad + num_low] = True
        return mask


def seed_from_filename(fname: str) -> int:
    """Deterministic per-volume seed: every slice of a volume gets the same
    mask (the use_seed contract of the vendored transform docstring)."""
    return int.from_bytes(
        __import__("hashlib").sha256(str(fname).encode()).digest()[:4],
        "little")


def apply_mask(kspace: np.ndarray, mask_func: MaskFunc,
               seed: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Mask a (..., H, W, 2) real-pair (or complex (..., H, W)) k-space.

    Returns (masked_kspace, mask). Masked columns become exact zeros, so
    the VarNet data-consistency term's ``ref != 0`` mask recovers the
    sampling pattern without a separate channel
    (``recon/varnet.py:VarNetBlock``).
    """
    k = np.asarray(kspace)
    if np.iscomplexobj(k):
        shape = k.shape + (2,)
        mask = mask_func(shape, seed)[..., 0]
        return k * mask, mask
    mask = mask_func(k.shape, seed)
    return k * mask, mask
