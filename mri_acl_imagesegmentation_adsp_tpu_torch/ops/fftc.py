"""Centered k-space transforms and coil combination.

Counterparts in ``mri_acl_imagesegmentation_adsp_tpu/ops/fftc.py``:
``fft2c_pair`` / ``ifft2c_pair`` (:95-117), ``fft2c`` / ``ifft2c`` /
``complex_abs`` (:153-171), ``ifft2c_magnitude`` (:174-191), ``rss`` /
``rss_complex`` (:194-212) and ``center_crop_or_pad`` (:214-230); and
``to_pair_np`` of ``ops/cpair.py:114``. The JAX version applies the
centered DFT as dense real-pair matmuls because the TPU has no complex dtype
(``fftc.py:42-48``); here the same functions are ``torch.fft`` on complex
tensors, and the real-pair ``(..., 2)`` forms are views of them.
"""

from __future__ import annotations

import numpy as np
import torch


def to_pair_np(x) -> np.ndarray:
    """Host complex (or real) array -> float32 ``(..., 2)`` re/im pair."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return np.stack([x, np.zeros_like(x)], axis=-1).astype(np.float32)


def as_complex(x: torch.Tensor) -> torch.Tensor:
    """A complex tensor as complex64, or a real-pair ``(..., 2)`` float
    tensor viewed as complex64 ``(...)``."""
    if x.is_complex():
        return x.to(torch.complex64)
    if x.shape[-1] != 2:
        raise ValueError("real k-space input must be a (..., 2) re/im pair; "
                         f"got shape {tuple(x.shape)}")
    return torch.view_as_complex(x.float().contiguous())


def fft2c(x: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal 2-D FFT over the last two axes (complex64)."""
    x = torch.fft.ifftshift(x.to(torch.complex64), dim=(-2, -1))
    return torch.fft.fftshift(torch.fft.fft2(x, norm="ortho"), dim=(-2, -1))


def ifft2c(x: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal 2-D inverse FFT over the last two axes."""
    x = torch.fft.ifftshift(x.to(torch.complex64), dim=(-2, -1))
    return torch.fft.fftshift(torch.fft.ifft2(x, norm="ortho"),
                              dim=(-2, -1))


def fft2c_pair(x: torch.Tensor) -> torch.Tensor:
    """:func:`fft2c` of a real-pair ``(..., H, W, 2)`` tensor, as a pair."""
    return torch.view_as_real(fft2c(as_complex(x)))


def ifft2c_pair(x: torch.Tensor) -> torch.Tensor:
    """:func:`ifft2c` of a real-pair ``(..., H, W, 2)`` tensor, as a pair."""
    return torch.view_as_real(ifft2c(as_complex(x)))


def complex_abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` of a complex tensor as ``sqrt(re^2 + im^2)`` (a real tensor's
    ``abs``)."""
    if x.is_complex():
        return torch.sqrt(x.real.square() + x.imag.square())
    return x.abs()


def ifft2c_magnitude(kspace: torch.Tensor) -> torch.Tensor:
    """k-space -> magnitude image ``|fftshift(ifft2(ifftshift(k)))|``.

    ``kspace`` is a real-pair ``(..., H, W, 2)`` float tensor or a complex
    ``(..., H, W)`` one; the transform is orthonormal over the last two
    image axes. Returns float32 ``(..., H, W)`` on the input's device.
    """
    return ifft2c(as_complex(kspace)).abs().float()


def rss(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Root-sum-of-squares of real coil images over ``dim``."""
    return torch.sqrt(torch.sum(x.square(), dim=dim))


def rss_complex(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``sqrt(sum |x|^2)`` over ``dim`` of complex coil images, or of a
    real-pair ``(..., 2)`` tensor, where ``dim`` counts the axes of the
    underlying ``(..., H, W)`` layout (as the JAX version's ``axis``)."""
    if x.is_complex():
        mag_sq = x.real.square() + x.imag.square()
    else:
        if x.shape[-1] != 2:
            raise ValueError("real input to rss_complex must be (..., 2) "
                             "pairs")
        mag_sq = x[..., 0].square() + x[..., 1].square()
    return torch.sqrt(torch.sum(mag_sq, dim=dim))


def center_crop_or_pad(img: torch.Tensor, out_h: int,
                       out_w: int) -> torch.Tensor:
    """Center-crop or zero-pad the last two axes to ``(out_h, out_w)``; crop
    and pad can mix per axis."""
    h, w = img.shape[-2], img.shape[-1]
    hmin, wmin = min(h, out_h), min(w, out_w)
    h0, w0 = (h - hmin) // 2, (w - wmin) // 2
    top, left = (out_h - hmin) // 2, (out_w - wmin) // 2
    out = img.new_zeros(img.shape[:-2] + (out_h, out_w))
    out[..., top:top + hmin, left:left + wmin] = (
        img[..., h0:h0 + hmin, w0:w0 + wmin])
    return out
