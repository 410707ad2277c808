"""Seeded knee slices and their single-coil k-space, made on the device in
a few batched calls.

Served k-space (:func:`kspace_pairs`) is built from real anatomy: six
fastMRI knee panels (``knee_panels.npz``, 320x320 ``uint8``; a copy of
``tests/goldens/fastmri_real_panels.npz`` at commit 090937a, its
``inputs``), each slice one panel drawn from the seed, flipped left to
right or not, its brightness scaled by 0.6-1.4, placed in the middle of a
640 x 368 frame as fastMRI's 320 x 320 crop sits in its image (the whole
volume shifted by up to 8 px each way), over uniform background noise of
amplitude 0.05, then its centered orthonormal 2-D FFT as a ``(..., H, W,
2)`` float32 real pair. So the chain's content-dependent kernels (Otsu,
open/close, component labelling) see knee anatomy.

The training store's slices (:func:`training_slices`) follow the seeded
blobs of ``mri_acl_imagesegmentation_adsp_tpu_torch/utils/synthetic.py`` at
commit 090937a (``synthetic_knee``), rewritten in torch so that a whole
store comes from one ``torch.Generator`` on the card, and varied as a
corpus's slices are.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def fft2c(x: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal 2-D FFT over the last two axes (complex64)."""
    x = torch.fft.ifftshift(x.to(torch.complex64), dim=(-2, -1))
    return torch.fft.fftshift(torch.fft.fft2(x, norm="ortho"), dim=(-2, -1))


def load_panels(path: Path, device) -> torch.Tensor:
    """The panels of ``path`` as ``(n, 320, 320)`` float32 in [0, 1]."""
    with np.load(path) as z:
        return torch.from_numpy(z["inputs"].astype(np.float32) / 255.0
                                ).to(device)


def panel_slices(gen: torch.Generator, panels: torch.Tensor, n: int, h: int,
                 w: int) -> torch.Tensor:
    """``(n, h, w)`` float32 magnitude slices of real anatomy on the
    generator's device (module docstring)."""
    dev = gen.device
    if panels.shape[1] > h or panels.shape[2] > w:      # a small test frame
        panels = torch.nn.functional.interpolate(
            panels[:, None], size=(min(panels.shape[1], h),
                                   min(panels.shape[2], w)), mode="area")[:, 0]
    p, ph, pw = panels.shape
    pick = torch.randint(0, p, (n,), generator=gen, device=dev)
    u = torch.rand((2, n, 1, 1), generator=gen, device=dev)
    shift = torch.randint(-8, 9, (2,), generator=gen, device=dev).tolist()
    sel = panels[pick]
    sel = torch.where(u[0] < 0.5, sel, sel.flip(-1)) * (0.6 + 0.8 * u[1])
    img = torch.rand((n, h, w), generator=gen, device=dev) * 0.05
    y0 = min(max((h - ph) // 2 + shift[0], 0), h - ph)
    x0 = min(max((w - pw) // 2 + shift[1], 0), w - pw)
    img[:, y0:y0 + ph, x0:x0 + pw] += sel
    return img


def kspace_pairs(gen: torch.Generator, panels: torch.Tensor, s: int,
                 h: int, w: int) -> torch.Tensor:
    """``(s, h, w, 2)`` float32 k-space of ``s`` slices of real anatomy,
    on the generator's device (the fastMRI knee single-coil layout at 640
    x 368)."""
    return torch.view_as_real(
        fft2c(panel_slices(gen, panels, s, h, w))).contiguous()


def training_slices(gen: torch.Generator, n: int, h: int, w: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(n, h, w)`` float32 images and their ``uint8`` masks, as varied as
    a store's slices are: one in seven holds no anatomy (an empty mask),
    the others a blob of brightness 0.4-1.0, centre within 15 % of the
    side from the middle and radius 0.08-0.40 of the shorter side (masks
    of 1-70 % of the slice), its mask above half its peak, under uniform
    noise of amplitude 0.05 and specks of 0.9 (density 0.005) as
    ``synthetic_knee``'s. Each image is z-scored inside its mask
    (population std; over the whole image when the mask is empty), as the
    chain z-scores a pack."""
    dev = gen.device
    u = torch.rand((5, n, 1, 1), generator=gen, device=dev)
    present = (u[0] >= 1 / 7).float()
    cy = h / 2 + (u[1] - 0.5) * 0.3 * h
    cx = w / 2 + (u[2] - 0.5) * 0.3 * w
    r = min(h, w) * (0.08 + 0.32 * u[3])
    peak = (0.4 + 0.6 * u[4]) * present
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    blob = peak * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    img = (blob + torch.rand((n, h, w), generator=gen, device=dev) * 0.05
           + (torch.rand((n, h, w), generator=gen, device=dev) > 0.995
              ).float() * 0.9)
    mask = (blob > 0.5 * peak) & (present > 0)
    m = mask.float()
    cnt = m.sum(dim=(1, 2), keepdim=True)
    m = torch.where(cnt > 0, m, torch.ones_like(m))
    cnt = m.sum(dim=(1, 2), keepdim=True)
    mean = (img * m).sum(dim=(1, 2), keepdim=True) / cnt
    std = (((img - mean) ** 2) * m).sum(dim=(1, 2), keepdim=True) / cnt
    return (img - mean) / std.sqrt().clamp_min(1e-6), mask.to(torch.uint8)
