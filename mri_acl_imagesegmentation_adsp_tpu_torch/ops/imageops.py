"""Intensity and geometry image ops, batched over leading axes.

Counterparts in ``mri_acl_imagesegmentation_adsp_tpu/ops/imageops.py``:
``percentile`` and ``percentile_clip`` (:32-41; the port's ``clip_sorted``
holds the clip rule for both), ``quantile_from_sorted`` (:44-57),
``_resize_weights`` / ``resize_bilinear`` (:60-97), ``zscore_in_mask`` (:100-120) and ``preview_01`` (:123-135).
Reductions run over the last two axes, so a ``(S, H, W)`` stack is one call.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def quantile_from_sorted(sorted_vals: torch.Tensor, q: float) -> torch.Tensor:
    """``np.percentile`` (linear) of each row of an ascending ``(..., N)``
    tensor. The two order-statistic indices and the f32 fraction are fixed
    by ``q`` and ``N``, as in the reference."""
    n = sorted_vals.shape[-1]
    pos = float(q) / 100.0 * (n - 1)
    i0 = int(np.floor(pos))
    i1 = min(i0 + 1, n - 1)
    frac = np.float32(pos - i0)
    return (sorted_vals[..., i0] * float(np.float32(1.0) - frac)
            + sorted_vals[..., i1] * float(frac))


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``np.percentile`` (linear) over all elements of ``x``."""
    return quantile_from_sorted(torch.sort(x.float().reshape(-1)).values, q)


def clip_sorted(img: torch.Tensor, pmin: float, pmax: float):
    """Clip each ``(H, W)`` image of ``img`` to its own ``[pmin, pmax]``
    percentiles; returns the clipped images (float32) and each image's
    values sorted and clipped, ``(..., H*W)``. One sort serves both the
    clip and, in the body mask, the Otsu histogram."""
    x = img.float()
    srt = torch.sort(x.flatten(-2), dim=-1).values
    lo = quantile_from_sorted(srt, pmin)[..., None]
    hi = quantile_from_sorted(srt, pmax)[..., None]
    return (torch.clamp(x, lo[..., None], hi[..., None]),
            torch.clamp(srt, lo, hi))


def percentile_clip(img: torch.Tensor, pmin: float,
                    pmax: float) -> torch.Tensor:
    """Clip each ``(H, W)`` image of ``img`` to its own ``[pmin, pmax]``
    percentiles."""
    return clip_sorted(img, pmin, pmax)[0]


@lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bilinear weight matrix with torch's align_corners=False
    rule: ``src = max((dst + 0.5) * in/out - 0.5, 0)``, upper neighbour
    clamped."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == out_size:
        np.fill_diagonal(w, 1.0)
        return w
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.maximum((dst + 0.5) * scale - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = (src - i0).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, i0), 1.0 - frac)
    np.add.at(w, (rows, i1), frac)
    return w


def resize_bilinear(img: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes to ``out_hw`` (float32).

    Two weight-matrix products, the H axis first, as in the reference: the
    mask threshold ``> 0.5`` after the resize sees the same sums."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    in_h, in_w = img.shape[-2], img.shape[-1]
    x = img.float()
    if in_h != out_h:
        wh = torch.from_numpy(_resize_weights(in_h, out_h)).to(x.device)
        x = torch.matmul(wh, x)
    if in_w != out_w:
        ww = torch.from_numpy(_resize_weights(in_w, out_w)).to(x.device)
        x = torch.matmul(x, ww.T)
    return x


def zscore_in_mask(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Z-score each ``(H, W)`` image with its in-mask mean and population
    std; fewer than 10 mask pixels falls back to whole-image statistics,
    and a std at or below 1e-6 becomes 1."""
    img = img.float()
    m = (mask > 0).float()
    cnt = m.sum(dim=(-2, -1), keepdim=True)
    safe_cnt = cnt.clamp_min(1.0)
    mean_in = (img * m).sum(dim=(-2, -1), keepdim=True) / safe_cnt
    var_in = ((img - mean_in).square() * m).sum(dim=(-2, -1),
                                                 keepdim=True) / safe_cnt
    std_in = var_in.sqrt()
    mean_all = img.mean(dim=(-2, -1), keepdim=True)
    std_all = img.std(dim=(-2, -1), keepdim=True, unbiased=False)
    use_mask = cnt >= 10
    mean = torch.where(use_mask, mean_in, mean_all)
    std = torch.where(use_mask, std_in, std_all)
    std = torch.where(std > 1e-6, std, torch.ones_like(std))
    return (img - mean) / std


def preview_01(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rescale each image to [0, 1] by its in-mask min/max (whole-image
    min/max where the mask is empty)."""
    img = img.float()
    m = mask > 0
    any_mask = m.any(dim=-1, keepdim=True).any(dim=-2, keepdim=True)
    big = torch.finfo(torch.float32).max
    lo_in = torch.where(m, img, big).amin(dim=(-2, -1), keepdim=True)
    hi_in = torch.where(m, img, -big).amax(dim=(-2, -1), keepdim=True)
    lo = torch.where(any_mask, lo_in, img.amin(dim=(-2, -1), keepdim=True))
    hi = torch.where(any_mask, hi_in, img.amax(dim=(-2, -1), keepdim=True))
    return (img - lo) / (hi - lo + 1e-6)
