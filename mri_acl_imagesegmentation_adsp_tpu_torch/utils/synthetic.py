"""Seeded synthetic knee slices and their single-coil k-space, in numpy.

The port's own copy of ``tests/oracles.py:122-140`` (``synthetic_knee``,
``synthetic_kspace_volume``): a bright Gaussian blob on a dark noisy
background with sparse bright specks, like a magnitude MRI slice, and its
centered orthonormal 2-D FFT as a fastMRI-style ``(S, H, W, 2)`` float32
real pair."""

from __future__ import annotations

import numpy as np


def synthetic_knee(rng: np.random.Generator, h: int = 128,
                   w: int = 128) -> np.ndarray:
    """One ``(h, w)`` float32 magnitude slice."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    cy, cx = h / 2 + rng.uniform(-8, 8), w / 2 + rng.uniform(-8, 8)
    r = min(h, w) * rng.uniform(0.25, 0.35)
    blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
                  ).astype(np.float32)
    noise = rng.random((h, w)).astype(np.float32) * 0.05
    speck = (rng.random((h, w)) > 0.995).astype(np.float32) * 0.9
    return blob + noise + speck


def synthetic_kspace_pairs(seed: int, s: int = 8, h: int = 640,
                           w: int = 368) -> np.ndarray:
    """``(s, h, w, 2)`` float32 k-space of ``s`` synthetic slices made from
    ``seed`` (the fastMRI knee single-coil layout at the defaults)."""
    rng = np.random.default_rng(seed)
    imgs = np.stack([synthetic_knee(rng, h, w) for _ in range(s)])
    ksp = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(imgs, axes=(-2, -1)),
                                      norm="ortho"), axes=(-2, -1))
    return np.stack([ksp.real, ksp.imag], axis=-1).astype(np.float32)
