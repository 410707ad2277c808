"""Binary mask ops: Otsu threshold, morphology, connected components and the
body mask, batched over a ``(S, H, W)`` stack of slices.

Counterparts in ``mri_acl_imagesegmentation_adsp_tpu/ops/maskops.py``:
``otsu_threshold`` in its sorted-values form (:52-117),
``label_components`` and ``remove_small_objects`` (:195-330) and
``body_mask`` (:331-385). ``disk`` (:39) and the plain ``binary_erosion`` /
``binary_dilation`` / ``binary_opening`` / ``binary_closing`` (:120-155)
live in ``kernels/morphology.py`` beside the CUDA kernel they are the plain
version of.

Connected components have no torch primitive. Here they iterate to the
exact fixpoint: run ids come from a ``cumsum`` of the background along an
axis, per-run minima from ``scatter_reduce(..., "amin")``, and row and
column sweeps alternate until no label changes. The JAX version's fixed
sweep count and its ``cc_ok`` certificate only bound XLA compiles; the
partition, and so the surviving pixels, are the same.
"""

from __future__ import annotations

import torch

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

def _run_min(lbl: torch.Tensor, run_id: torch.Tensor, fg: torch.Tensor,
             n_runs: int, sentinel: int) -> torch.Tensor:
    """Replace each foreground label by the minimum over its run.

    Background pixels scatter their sentinel, which never lowers a minimum,
    so every pixel can scatter without first selecting the foreground."""
    mins = torch.full((n_runs,), sentinel, dtype=lbl.dtype, device=lbl.device)
    mins.scatter_reduce_(0, run_id.reshape(-1), lbl.reshape(-1), "amin")
    return torch.where(fg, mins[run_id], sentinel)


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """4-connected component labels of each slice of a ``(S, H, W)`` mask.

    Returns int64 ``(S, H, W)``: background holds ``H*W``, each foreground
    pixel the minimum in-slice linear index of its component (the JAX
    version's labels). Row and column sweeps alternate to the fixpoint.
    """
    s, h, w = mask.shape
    dev = mask.device
    fg = mask > 0
    bg = (~fg).to(torch.int64)
    sentinel = h * w
    lbl = torch.where(fg, torch.arange(h * w, device=dev).view(1, h, w),
                      sentinel)
    # a run of foreground along an axis is the pixels between two
    # background pixels: a cumsum of the background numbers the runs
    rows = torch.arange(s * h, device=dev).view(s, h, 1)
    row_id = rows * (w + 1) + torch.cumsum(bg, dim=2)
    cols = (torch.arange(s, device=dev).view(s, 1, 1) * w
            + torch.arange(w, device=dev).view(1, 1, w))
    col_id = cols * (h + 1) + torch.cumsum(bg, dim=1)
    while True:
        nxt = _run_min(lbl, row_id, fg, s * h * (w + 1), sentinel)
        nxt = _run_min(nxt, col_id, fg, s * w * (h + 1), sentinel)
        if torch.equal(nxt, lbl):
            return lbl
        lbl = nxt


def remove_small_objects(mask: torch.Tensor,
                         min_size: int = 256) -> torch.Tensor:
    """Drop 4-connected components with fewer than ``min_size`` pixels from
    each slice of a ``(S, H, W)`` mask (skimage semantics). Returns bool."""
    s, h, w = mask.shape
    lbl = label_components(mask)
    key = lbl + (h * w + 1) * torch.arange(s, device=mask.device).view(s, 1, 1)
    counts = torch.bincount(key.reshape(-1), minlength=s * (h * w + 1))
    return (mask > 0) & (counts[key] >= min_size)


# --------------------------------------------------------------------------
# Body mask (the segmentation target)
# --------------------------------------------------------------------------

def body_mask(img: torch.Tensor,
              sorted_values: torch.Tensor | None = None) -> torch.Tensor:
    """Otsu body mask + disk(2) open/close + remove_small_objects(256).

    ``img`` is ``(S, H, W)``; ``sorted_values``, if the caller has them,
    are each slice's values sorted ascending, ``(S, H*W)``. Per slice:
    ``v = (img - min) / (max - min)``, ``th = otsu(v)`` (0.5 if not
    finite), ``m = v > th``, then the disk(2) opening
    and closing (the CUDA kernel for a CUDA tensor, its plain version on
    the CPU), then small-object removal; a constant slice gives an empty
    mask. Returns uint8 ``(S, H, W)``.
    """
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
    m = open_close(m.contiguous())
    m = remove_small_objects(m, 256)
    return (m & nonzero[:, :, None]).to(torch.uint8)
