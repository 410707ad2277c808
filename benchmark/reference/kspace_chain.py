"""Plain k-space segmentation: single-coil k-space to body mask, model
input and masks, in float64 wherever the port computes in float32.

It follows the published chain that the port's ``data/preprocess.py``
serves (the reference project's ``MRIKneePreprocessor`` with
``slice_keep=(0, 1)``), written anew from its description:

1. the magnitude of the centered orthonormal inverse 2-D FFT;
2. each slice clipped to its own 1st and 99.5th percentiles
   (``np.percentile``, linear);
3. the body mask: the slice rescaled to [0, 1], thresholded at Otsu's
   threshold (skimage: a 256-bin histogram over [min, max], the centre of
   the bin that maximizes the between-class variance), opened and then
   closed by a radius-2 disk (an erosion treats pixels outside the image
   as set, a dilation as clear), 4-connected components under 256 pixels
   removed (``scipy.ndimage.label``), empty for a constant slice;
4. image and mask resized to the model's size (320 x 320) bilinearly
   (half-pixel centres, no antialiasing; the mask kept where its resize
   exceeds 0.5);
5. the image z-scored by the mean and population std inside the mask
   (the whole image's below 10 mask pixels; a std at or below 1e-6 taken
   as 1).

``bf16`` (the control) rounds the k-space, the magnitude, the clipped
image and the model input to bfloat16, the precision below the float32
the chain is stated in.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.ndimage as ndi
import torch
import torch.nn.functional as F

PCT = (1.0, 99.5)
NBINS = 256
MIN_SIZE = 256
OUT = (320, 320)


def _r(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if bf16 else t


def magnitude(kpair: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """``(S, H, W, 2)`` k-space -> ``(S, H, W)`` float64 magnitudes."""
    k = _r(kpair.double(), bf16)
    c = torch.complex(k[..., 0], k[..., 1])
    img = torch.fft.fftshift(torch.fft.ifft2(
        torch.fft.ifftshift(c, dim=(-2, -1)), norm="ortho"), dim=(-2, -1))
    return _r(img.abs(), bf16)


def percentile_clip(img: torch.Tensor) -> torch.Tensor:
    s = img.shape[0]
    srt = torch.sort(img.reshape(s, -1), dim=1).values
    n = srt.shape[1]

    def pct(q):
        pos = q / 100.0 * (n - 1)
        i0 = int(np.floor(pos))
        i1 = min(i0 + 1, n - 1)
        f = pos - i0
        return srt[:, i0] * (1.0 - f) + srt[:, i1] * f
    lo, hi = pct(PCT[0]), pct(PCT[1])
    return torch.minimum(torch.maximum(img, lo.view(s, 1, 1)),
                         hi.view(s, 1, 1))


def otsu_masks(img: torch.Tensor) -> torch.Tensor:
    """``(S, H, W)`` bool: each slice rescaled to [0, 1] above its Otsu
    threshold; all clear for a constant slice."""
    s = img.shape[0]
    flat = img.reshape(s, -1)
    lo = flat.amin(dim=1, keepdim=True)
    span = flat.amax(dim=1, keepdim=True) - lo
    ok = span[:, 0] > 0
    v = torch.where(span > 0, (flat - lo) / span.clamp_min(1e-300), 0.0)
    # bins of width 1/256 over [0, 1], the last one closed
    idx = torch.clamp((v * NBINS).floor().long(), max=NBINS - 1)
    hist = torch.zeros((s, NBINS), dtype=torch.float64, device=img.device)
    hist.scatter_add_(1, idx, torch.ones_like(v))
    centers = (torch.arange(NBINS, dtype=torch.float64,
                            device=img.device) + 0.5) / NBINS
    w1 = torch.cumsum(hist, 1)
    w2 = torch.cumsum(hist.flip(1), 1).flip(1)
    m1 = torch.cumsum(hist * centers, 1) / w1.clamp_min(1e-300)
    m2 = (torch.cumsum((hist * centers).flip(1), 1)
          / torch.cumsum(hist.flip(1), 1).clamp_min(1e-300)).flip(1)
    var12 = w1[:, :-1] * w2[:, 1:] * (m1[:, :-1] - m2[:, 1:]) ** 2
    th = centers[torch.argmax(var12, dim=1)]
    return (v > th[:, None]).reshape(img.shape) & ok.view(s, 1, 1)


def _disk2(device) -> torch.Tensor:
    yy, xx = np.mgrid[-2:3, -2:3]
    return torch.from_numpy((yy ** 2 + xx ** 2 <= 4).astype(np.float32)
                            ).to(device)[None, None]


def _erode(m: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    x = F.pad(m[:, None].float(), (2, 2, 2, 2), value=1.0)
    return F.conv2d(x, se)[:, 0] >= se.sum() - 0.5


def _dilate(m: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    return F.conv2d(m[:, None].float(), se, padding=2)[:, 0] > 0.5


def open_close(m: torch.Tensor) -> torch.Tensor:
    se = _disk2(m.device)
    opened = _dilate(_erode(m, se), se)
    return _erode(_dilate(opened, se), se)


def remove_small(m: torch.Tensor) -> torch.Tensor:
    """4-connected components under ``MIN_SIZE`` pixels cleared."""
    host = m.cpu().numpy()
    out = np.zeros_like(host)
    for i, sl in enumerate(host):
        lbl, n = ndi.label(sl)
        if n:
            sizes = np.bincount(lbl.ravel())
            keep = sizes >= MIN_SIZE
            keep[0] = False
            out[i] = keep[lbl]
    return torch.from_numpy(out).to(m.device)


def resize(x: torch.Tensor, out=OUT) -> torch.Tensor:
    return F.interpolate(x[:, None], size=tuple(out), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def zscore(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.double()
    out = torch.empty_like(img)
    for i in range(img.shape[0]):
        n = float(m[i].sum())
        if n >= 10:
            vals = img[i][mask[i]]
        else:
            vals = img[i].reshape(-1)
        mean = vals.mean()
        std = ((vals - mean) ** 2).mean().sqrt()
        out[i] = (img[i] - mean) / (std if std > 1e-6 else 1.0)
    return out


def chain(kpair: torch.Tensor, bf16: bool = False, out=OUT
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S, H, W, 2)`` k-space (on any device) -> the ``(S, 1, *out)``
    model input (float64) and the ``(S, *out)`` bool body mask."""
    img = percentile_clip(magnitude(kpair, bf16))
    img = _r(img, bf16)
    mask = remove_small(open_close(otsu_masks(img)))
    img_r = resize(img, out)
    mask_r = resize(mask.double(), out) > 0.5
    return _r(zscore(img_r, mask_r), bf16)[:, None], mask_r
