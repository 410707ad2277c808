"""disk(2) binary opening then closing of a ``(S, H, W)`` uint8 mask stack.

Replaces the TPU kernel ``_fused_open_close``
(``mri_acl_imagesegmentation_adsp_tpu/ops/pallas/morphology.py:93-101``,
wrapper ``fused_open_close`` at :104-112) with the hand-written CUDA kernel
``csrc/open_close.cu``; see that file for its design and what bounds it.

Its plain PyTorch version, ``open_close_reference``, is built from this
module's ``disk`` and binary erosion and dilation, the counterparts of
``disk`` (:39) and ``binary_erosion`` / ``binary_dilation`` /
``binary_opening`` / ``binary_closing`` (:120-155) in
``mri_acl_imagesegmentation_adsp_tpu/ops/maskops.py``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# Launches of the CUDA kernel in this process: the wrapper adds one where it
# launches, and nowhere else, so a run can show its path went through it.
LAUNCHES = 0


@lru_cache(maxsize=16)
def disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk: Euclidean ball, dx^2+dy^2 <= r^2 (float32)."""
    r = int(radius)
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    return (yy * yy + xx * xx <= r * r).astype(np.float32)


def _stencil(mask: torch.Tensor, se: np.ndarray, fill: bool,
             erode: bool) -> torch.Tensor:
    """AND (erode) or OR (dilate) of the structuring element's taps over the
    last two axes; a tap outside the image reads ``fill``."""
    se = np.asarray(se) > 0
    kh, kw = se.shape
    h, w = mask.shape[-2], mask.shape[-1]
    padded = F.pad((mask > 0).to(torch.uint8), (kw // 2, kw // 2,
                                                kh // 2, kh // 2),
                   value=int(fill)).bool()
    acc = None
    for dy, dx in zip(*np.nonzero(se)):
        tap = padded[..., dy:dy + h, dx:dx + w]
        if acc is None:
            acc = tap.clone()
        elif erode:
            acc &= tap
        else:
            acc |= tap
    return acc


def binary_erosion(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Binary erosion; out-of-image pixels count as foreground (skimage)."""
    return _stencil(mask, se, fill=True, erode=True)


def binary_dilation(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Binary dilation; out-of-image pixels count as background (skimage)."""
    return _stencil(mask, se, fill=False, erode=False)


def binary_opening(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return binary_dilation(binary_erosion(mask, se), se)


def binary_closing(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return binary_erosion(binary_dilation(mask, se), se)


def open_close_reference(mask: torch.Tensor) -> torch.Tensor:
    """Plain version: ``closing(opening(mask, disk(2)), disk(2))`` as uint8."""
    se = disk(2)
    return binary_closing(binary_opening(mask, se), se).to(torch.uint8)


# Band heights the wrapper picks from, largest first, and the SMs of an H100
# the grid should fill.
BAND_ROWS = (64, 32, 16, 8)
SMS = 132


def band_plan(s: int, h: int) -> tuple:
    """``(band_rows, n_bands)`` for an ``(s, h, W)`` stack: the kernel runs
    one block per band of ``band_rows`` output rows, rows
    ``[b * band_rows, min((b + 1) * band_rows, h))`` of band ``b`` for
    ``b < n_bands``. The tallest band whose grid ``s * n_bands`` fills the
    card's SMs, else the shortest: a taller band re-reads less halo (16
    rows a band), a shorter one gives more blocks."""
    for rows in BAND_ROWS:
        if s * -(-h // rows) >= SMS:
            break
    return rows, -(-h // rows)


def load_library() -> ctypes.CDLL:
    """Build and load ``csrc/open_close.cu`` (once per process)."""
    lib = _build.load("open_close")
    fn = lib.open_close_u8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def open_close(mask: torch.Tensor) -> torch.Tensor:
    """disk(2) opening then closing of each slice of a contiguous
    ``(S, H, W)`` uint8 tensor, nonzero meaning 1; returns a new uint8 0/1
    tensor.

    A CUDA tensor goes to the kernel (or the call raises); a CPU tensor goes
    to :func:`open_close_reference`."""
    return _open_close(mask, None)


def _open_close(mask: torch.Tensor, band_rows: int | None) -> torch.Tensor:
    """:func:`open_close` with the kernel's band height ``band_rows`` in
    place of :func:`band_plan`'s when it is not None (the card tests and
    the kernel probe set it)."""
    global LAUNCHES
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"mask must be a torch.Tensor, got {type(mask)}")
    if mask.dtype != torch.uint8:
        raise TypeError(f"mask must be uint8, got {mask.dtype}")
    if mask.dim() != 3:
        raise ValueError(f"mask must be (S, H, W), got {tuple(mask.shape)}")
    s, h, w = mask.shape
    if h < 1 or w < 1:
        raise ValueError(f"mask needs H, W >= 1, got {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if band_rows is not None and band_rows < 1:
        raise ValueError(f"band_rows must be >= 1, got {band_rows}")
    if mask.device.type == "cpu":
        return open_close_reference(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    rows, n_bands = band_plan(s, h)
    if band_rows is not None:
        rows, n_bands = band_rows, -(-h // band_rows)
    if s * n_bands >= 2 ** 31:
        raise ValueError(f"{s} slices of {n_bands} bands exceed the grid")
    out = torch.empty_like(mask)
    if s == 0:
        return out
    lib = load_library()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        rc = lib.open_close_u8(mask.data_ptr(), out.data_ptr(), s, h, w,
                               rows, n_bands, stream)
    if rc != 0:
        raise RuntimeError(f"open_close_u8 launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
