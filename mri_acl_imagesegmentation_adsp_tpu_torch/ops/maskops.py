"""Binary mask ops: Otsu threshold, morphology, connected components and the
body mask, batched over a ``(S, H, W)`` stack of slices.

Counterparts in ``mri_acl_imagesegmentation_adsp_tpu/ops/maskops.py``:
``otsu_threshold`` in its sorted-values form (:52-117),
``label_components`` and ``remove_small_objects`` (:195-330) and
``body_mask`` (:331-385). ``disk`` (:39) and the plain ``binary_erosion`` /
``binary_dilation`` / ``binary_opening`` / ``binary_closing`` (:120-155)
live in ``kernels/morphology.py`` beside the CUDA kernel they are the plain
version of.

Connected components have no torch primitive: ``label_components`` is
``kernels/components.py``'s, the CUDA kernels ``csrc/label_prop.cu`` for a
CUDA tensor (union-find over 32x32 tiles, three launches, no host sync) and
row and column sweeps on the CPU. The JAX version's fixed sweep count and
its ``cc_ok`` certificate only bound XLA compiles; the partition, and so the
surviving pixels, are the same.
"""

from __future__ import annotations

import torch

from .kernels.components import label_components
from .kernels.morphology import open_close


# --------------------------------------------------------------------------
# Otsu threshold (skimage-compatible, sorted-values form)
# --------------------------------------------------------------------------

def otsu_threshold_sorted(sorted_values: torch.Tensor,
                          nbins: int = 256) -> torch.Tensor:
    """Otsu's threshold of each row of an ascending ``(S, N)`` tensor.

    The histogram is ``np.histogram``'s over ``[min, max]``: f32 edges
    ``vmin + step * i`` with the last edge pinned to ``vmax``, half-open
    bins with the last one closed, counted by ``searchsorted`` ranks. The
    between-class variance is summed in float64 (the counts are exact
    integers either way), so its argmax follows skimage's float64 oracle
    rather than the order of an f32 cumulative sum. Returns ``(S,)`` f32.
    """
    x = sorted_values.float().contiguous()
    vmin = x[:, :1]
    vmax = x[:, -1:]
    span = torch.clamp(vmax - vmin, min=torch.finfo(torch.float32).tiny)
    step = span / nbins
    edges = vmin + step * torch.arange(nbins + 1, dtype=torch.float32,
                                       device=x.device)
    edges[:, -1:] = vmax
    left = torch.searchsorted(x, edges[:, :-1].contiguous(), side="left")
    last = torch.searchsorted(x, edges[:, -1:].contiguous(), side="right")
    counts = torch.diff(torch.cat([left, last], dim=1), dim=1).double()
    centers = 0.5 * (edges[:, :-1] + edges[:, 1:])

    c64 = centers.double()
    w1 = torch.cumsum(counts, dim=1)
    w2 = torch.cumsum(counts.flip(1), dim=1).flip(1)
    mean1 = torch.cumsum(counts * c64, dim=1) / w1.clamp_min(1e-12)
    mean2 = (torch.cumsum((counts * c64).flip(1), dim=1)
             / torch.cumsum(counts.flip(1), dim=1).clamp_min(1e-12)).flip(1)
    variance12 = w1[:, :-1] * w2[:, 1:] * (mean1[:, :-1] - mean2[:, 1:]) ** 2
    best = torch.argmax(variance12, dim=1, keepdim=True)
    return centers.gather(1, best)[:, 0]


# --------------------------------------------------------------------------
# Connected components + small-object removal
# --------------------------------------------------------------------------

def remove_small_objects(mask: torch.Tensor,
                         min_size: int = 256) -> torch.Tensor:
    """Drop 4-connected components with fewer than ``min_size`` pixels from
    each slice of a ``(S, H, W)`` mask (skimage semantics). Returns bool.

    Component sizes are counted with ``scatter_add_`` into a tensor of the
    known size ``S * (H*W + 1)`` (one slot per label and slice), so on the
    card nothing is read back to size it."""
    s, h, w = mask.shape
    lbl = label_components(mask)
    key = (lbl.to(torch.int64) + (h * w + 1)
           * torch.arange(s, device=mask.device).view(s, 1, 1)).reshape(-1)
    counts = torch.zeros(s * (h * w + 1), dtype=torch.int32,
                         device=mask.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    return (mask > 0) & (counts[key].view(s, h, w) >= min_size)


# --------------------------------------------------------------------------
# Body mask (the segmentation target)
# --------------------------------------------------------------------------

def open_closed_otsu_mask(img: torch.Tensor,
                          sorted_values: torch.Tensor | None = None):
    """The body mask before its connected components: per slice of ``img``
    ``(S, H, W)``, ``v = (img - min) / (max - min)``, ``th = otsu(v)`` (0.5
    if not finite), ``m = v > th``, then the disk(2) opening and closing
    (the CUDA kernel for a CUDA tensor, its plain version on the CPU).
    ``sorted_values``, if the caller has them, are each slice's values
    sorted ascending, ``(S, H*W)``. Returns the uint8 ``(S, H, W)`` mask
    and the bool ``(S, 1)`` flag of the slices that are not constant."""
    img = img.float()
    s, h, w = img.shape
    if sorted_values is None:
        sorted_values = torch.sort(img.reshape(s, h * w), dim=1).values
    sorted_values = sorted_values.float()
    imin = sorted_values[:, :1]
    vmax = sorted_values[:, -1:] - imin
    nonzero = vmax > 0
    denom = torch.clamp(vmax, min=torch.finfo(torch.float32).tiny)
    v = torch.where(nonzero[:, :, None], (img - imin[:, :, None])
                    / denom[:, :, None], 0.0)
    sorted_v = torch.where(nonzero, (sorted_values - imin) / denom, 0.0)
    th = otsu_threshold_sorted(sorted_v)
    th = torch.where(torch.isfinite(th), th, 0.5)
    m = (v > th[:, None, None]).to(torch.uint8)
    return open_close(m.contiguous()), nonzero


def body_mask(img: torch.Tensor,
              sorted_values: torch.Tensor | None = None) -> torch.Tensor:
    """Otsu body mask + disk(2) open/close + remove_small_objects(256):
    :func:`open_closed_otsu_mask`, then small-object removal (its connected
    components in the CUDA kernel for a CUDA tensor, in their plain version
    on the CPU); a constant slice gives an empty mask. Returns uint8
    ``(S, H, W)``."""
    m, nonzero = open_closed_otsu_mask(img, sorted_values)
    m = remove_small_objects(m, 256)
    return (m & nonzero[:, :, None]).to(torch.uint8)
