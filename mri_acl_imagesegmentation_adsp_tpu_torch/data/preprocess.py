"""MRI knee preprocessing chain, batched over the slices of a volume.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/data/preprocess.py``
``MRIKneePreprocessor``: the slice chain (:78-122), ``preprocess_volume_pairs``
with ``_preprocess_volume`` (:266-270, :360-377) and ``_keep_band``
(:379-391).
The JAX version jits one slice and vmaps it; here every step takes the whole
``(S, H, W)`` stack. Only the default chain is ported: N4 bias correction and
NL-means denoising raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..ops.fftc import ifft2c_magnitude
from ..ops.imageops import (preview_01, quantile_from_sorted, resize_bilinear,
                            zscore_in_mask)
from ..ops.maskops import body_mask
from ..utils.device import resolve_device


class MRIKneePreprocessor:
    """Single-coil knee-MRI preprocessor (the reference's default chain)."""

    def __init__(
        self,
        out_size: Tuple[int, int] = (320, 320),
        slice_keep: Tuple[float, float] = (0.3, 0.7),
        clip_percentiles: Tuple[float, float] = (1.0, 99.5),
        use_n4: bool = False,
        use_denoise: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        self.out_size = tuple(int(v) for v in out_size)
        self.slice_keep = tuple(float(v) for v in slice_keep)
        self.clip_percentiles = tuple(float(v) for v in clip_percentiles)
        if use_n4 or use_denoise:
            raise NotImplementedError(
                "N4 bias correction and NL-means denoising are not ported "
                "yet (ops/restoration.py); the default chain has both off")
        lo, hi = self.slice_keep
        if not (0.0 <= lo < hi <= 1.0):
            raise ValueError("slice_keep must satisfy 0.0 <= lo < hi <= 1.0")
        pmin, pmax = self.clip_percentiles
        if not (0.0 <= pmin < pmax <= 100.0):
            raise ValueError(
                "clip_percentiles must be in [0,100] with pmin < pmax")
        self.device = resolve_device(device)

    def _volume_chain(self, x: torch.Tensor):
        """``(S, H, W, 2)`` k-space pairs -> ``(img_z, img_01, mask)`` at
        ``out_size``.

        One sort per slice serves both the percentile clip and the Otsu
        histogram, as in the reference."""
        img = ifft2c_magnitude(x)
        s, h, w = img.shape
        pmin, pmax = self.clip_percentiles
        srt = torch.sort(img.reshape(s, h * w), dim=1).values
        lo = quantile_from_sorted(srt, pmin)[:, None]
        hi = quantile_from_sorted(srt, pmax)[:, None]
        img = torch.clamp(img, lo[:, :, None], hi[:, :, None])
        mk = body_mask(img, sorted_values=torch.clamp(srt, lo, hi))
        img_r = resize_bilinear(img, self.out_size)
        mk_r = (resize_bilinear(mk.float(), self.out_size) > 0.5
                ).to(torch.uint8)
        return zscore_in_mask(img_r, mk_r), preview_01(img_r, mk_r), mk_r

    def preprocess_volume_pairs(self, kspace_pair) -> Dict[str, Any]:
        """Bulk k-space path: ``(S, H, W, 2)`` float pairs (numpy or torch)
        through the keep band and the chain.

        Returns ``{"tensor": (S', 1, H, W) f32, "preview": (S', H, W) f32,
        "mask": (S', H, W) uint8}`` as tensors on this preprocessor's
        device, and ``"indices"``, the kept slices' indices."""
        if isinstance(kspace_pair, np.ndarray):
            kspace_pair = torch.from_numpy(
                np.ascontiguousarray(kspace_pair, dtype=np.float32))
        stack = kspace_pair.to(self.device, torch.float32)
        if stack.dim() != 4 or stack.shape[-1] != 2:
            raise ValueError("kspace must be a single-coil (S, H, W, 2) "
                             f"real pair, got shape {tuple(stack.shape)}")
        s0, s1 = self._keep_band(stack.shape[0])
        img_z, img_01, mk = self._volume_chain(stack[s0:s1])
        return {"tensor": img_z[:, None], "preview": img_01, "mask": mk,
                "indices": list(range(s0, s1))}

    def _keep_band(self, ns: int) -> Tuple[int, int]:
        """[s0, s1) band of kept slices: truncate ns*lo / ns*hi, keep at
        least one slice, take the full volume on a degenerate band."""
        lo, hi = self.slice_keep
        s0 = int(ns * lo)
        s1 = min(max(int(ns * hi), s0 + 1), ns)
        if s0 >= s1:
            s0, s1 = 0, ns
        if s0 >= s1:  # only reachable when ns == 0
            raise ValueError("slice_keep selected no slices")
        return s0, s1
