"""Cartesian reconstruction: single-coil and multi-coil RSS, and the
helpers of the prostate pipelines.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/recon/cartesian.py:25-80``
(``recon_singlecoil``, ``recon_multicoil_rss``, ``ifftnd_scaled``,
``center_crop_im``, ``flip_im``), with ``torch.fft`` on complex tensors in
place of the JAX package's real-pair DFT matmuls.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.fftc import as_complex, ifft2c, ifft2c_magnitude, rss_complex
from ..utils.device import resolve_device


def _upload(kspace, device) -> torch.Tensor:
    """Host complex k-space, a ``(..., 2)`` pair or a tensor -> complex64
    on ``device``."""
    if not isinstance(kspace, torch.Tensor):
        kspace = np.asarray(kspace)
        kspace = torch.from_numpy(np.ascontiguousarray(
            kspace, np.complex64 if np.iscomplexobj(kspace) else np.float32))
    return as_complex(kspace.to(resolve_device(device)))


def recon_singlecoil(kspace, device: str | torch.device = "cuda"
                     ) -> np.ndarray:
    """``(..., H, W)`` complex or ``(..., H, W, 2)`` pair -> float32
    magnitude of its centered orthonormal iFFT, computed on ``device``."""
    return ifft2c_magnitude(_upload(kspace, device)).cpu().numpy()


def recon_multicoil_rss(kspace_coils, coil_axis: int = 0,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Multi-coil k-space ``(..., C, H, W)`` complex or ``(..., C, H, W,
    2)`` pair -> RSS magnitude: the centered orthonormal iFFT of each coil,
    then root-sum-of-squares over ``coil_axis`` (counted on the complex
    layout), on ``device``."""
    img = ifft2c(_upload(kspace_coils, device))
    return rss_complex(img, dim=coil_axis).cpu().numpy()


def ifftnd_scaled(kspace: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    """The prostate code's ``ifftnd`` (a centered inverse FFT scaled by
    ``sqrt(prod(shape[axes]))``, which is the orthonormal transform) over
    the last two axes.

    ``kspace`` is a complex tensor, or a real ``(..., 2)`` pair whose
    ``axes`` count the complex layout's axes (as the JAX version's); the
    result has the input's form. Other axes raise NotImplementedError."""
    pair = not kspace.is_complex()
    nd = kspace.ndim - 1 if pair else kspace.ndim
    if tuple(sorted(a % nd for a in axes)) != (nd - 2, nd - 1):
        raise NotImplementedError(
            "ifftnd_scaled supports the last two (spatial) axes; "
            f"got {tuple(axes)}")
    img = ifft2c(as_complex(kspace))
    return torch.view_as_real(img) if pair else img


def center_crop_im(im_3d, crop_to_size: Tuple[int, int]):
    """The prostate code's ``center_crop_im`` over the last two axes of an
    array or tensor, with its ``int()`` truncation of odd differences."""
    x_crop = im_3d.shape[-1] / 2 - crop_to_size[0] / 2
    y_crop = im_3d.shape[-2] / 2 - crop_to_size[1] / 2
    return im_3d[..., int(y_crop):int(crop_to_size[1] + y_crop),
                 int(x_crop):int(crop_to_size[0] + x_crop)]


def flip_im(vol: np.ndarray, slice_axis: int = 0) -> np.ndarray:
    """The prostate code's ``flip_im``: a copy with each slice along
    ``slice_axis`` flipped up-down."""
    out = np.array(vol)
    for i in range(out.shape[slice_axis]):
        sl = [slice(None)] * out.ndim
        sl[slice_axis] = i
        out[tuple(sl)] = np.flipud(out[tuple(sl)])
    return out
