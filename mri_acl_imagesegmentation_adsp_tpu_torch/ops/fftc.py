"""Centered k-space transforms.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/ops/fftc.py:174-191``
(``ifft2c_magnitude``). The JAX version applies the centered DFT as dense
real-pair matmuls because the TPU has no complex dtype (``fftc.py:42-48``);
here the same function is ``torch.fft`` on a complex tensor.
"""

from __future__ import annotations

import torch


def ifft2c_magnitude(kspace: torch.Tensor) -> torch.Tensor:
    """k-space -> magnitude image ``|fftshift(ifft2(ifftshift(k)))|``.

    ``kspace`` is a real-pair ``(..., H, W, 2)`` float tensor or a complex
    ``(..., H, W)`` one; the transform is orthonormal over the last two
    image axes. Returns float32 ``(..., H, W)`` on the input's device.
    """
    if not kspace.is_complex():
        if kspace.shape[-1] != 2:
            raise ValueError(
                "real k-space input must be a (..., 2) re/im pair; got "
                f"shape {tuple(kspace.shape)}")
        kspace = torch.view_as_complex(kspace.float().contiguous())
    x = torch.fft.ifftshift(kspace.to(torch.complex64), dim=(-2, -1))
    x = torch.fft.ifft2(x, norm="ortho")
    x = torch.fft.fftshift(x, dim=(-2, -1))
    return x.abs().float()
