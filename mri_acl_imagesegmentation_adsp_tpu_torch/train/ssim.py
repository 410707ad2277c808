"""SSIM training loss.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/ssim.py``, the
prostate code's ``SSIMLoss`` (``losses.py:13-64``): a uniform 7x7 window,
``k1 = 0.01`` / ``k2 = 0.03``, the sample covariance ``NP / (NP - 1)``, the
valid region only, a ``data_range`` per sample, ``1 - mean(S)``. The
window's means are ``avg_pool2d`` over 7x7 at stride 1, in f32: the JAX
version's f32 convolution at ``Precision.HIGHEST``, which TF32 on a card
would otherwise round.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssim_map(x: torch.Tensor, y: torch.Tensor, data_range, win_size: int = 7,
             k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """The SSIM of every valid window: ``x``, ``y`` ``(N, 1, H, W)`` ->
    ``(N, 1, H - win + 1, W - win + 1)``; ``data_range`` broadcasts as
    ``(N, 1, 1, 1)`` (a float or an ``(N,)`` tensor)."""
    npix = win_size * win_size
    cov_norm = npix / (npix - 1)

    def filt(a):
        return F.avg_pool2d(a.float(), win_size, stride=1)

    dr = torch.as_tensor(data_range, dtype=torch.float32, device=x.device)
    dr = dr.reshape(-1, 1, 1, 1)
    c1 = (k1 * dr) ** 2
    c2 = (k2 * dr) ** 2
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def ssim_loss(x: torch.Tensor, y: torch.Tensor, data_range,
              win_size: int = 7, k1: float = 0.01, k2: float = 0.03,
              reduced: bool = True) -> torch.Tensor:
    """``1 - SSIM`` of ``(N, 1, H, W)`` pairs with ``data_range`` ``(N,)``:
    a scalar tensor, or the map with ``reduced=False``."""
    s = ssim_map(x, y, data_range, win_size, k1, k2)
    return 1 - s.mean() if reduced else 1 - s
