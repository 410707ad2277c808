"""Exact Euclidean distance transform and the surface-distance metrics.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/ops/edt.py:30-136``
(``_nearest_zero_dist_1d``, ``edt``, ``_edt_sampled``, ``_masked_sorted``,
``surface_distances``, ``_masked_percentile``, ``hd95``, ``assd``), with a
leading batch axis: every function takes ``(H, W)`` or ``(N, H, W)``.

The semantics are the JAX package's, not scipy's:

* an input with no zero gives the large finite sentinel ``H + W`` (times the
  row spacing) where scipy would give distances to out-of-range indices;
* the surface is the whole mask: the reference's border extraction
  (``a ^ (edt(~a) > 0 & a)``) is always empty, so its HD95 and ASSD measure
  from every pixel of one mask to the nearest of the other, both ways;
* HD95 and ASSD are 0 when both masks are empty.

The transform is exact, in two phases: per column the distance to the
nearest zero (two ``cummax`` scans), then per row
``D^2[i, j] = min_k (g[i, k]^2 + (j - k)^2)`` as a broadcast minimum that
materializes ``(N, H, W, W)`` float32. With unit spacing every squared
distance is an integer below 2^24, and the root is taken in float64 and
rounded to float32, which is the correctly rounded float32 root, so the
result is bit-equal to the JAX function's on the CPU and on the card.
Plain PyTorch: JAX lowers it through XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_UNIT = (1.0, 1.0)


def _nearest_zero_dist_1d(is_zero: torch.Tensor) -> torch.Tensor:
    """Distance in rows from each pixel to the nearest zero of its column,
    ``(..., H, W)`` bool -> float32; a column with no zero gets ``H + W``."""
    h, w = is_zero.shape[-2:]
    idx = torch.arange(h, dtype=torch.float32, device=is_zero.device)
    idx = idx[:, None].expand(is_zero.shape)
    # the last zero at or above each row, and the next at or below it
    last = torch.cummax(torch.where(is_zero, idx, -torch.inf), dim=-2).values
    nxt = -torch.cummax(torch.where(is_zero, -idx, -torch.inf).flip(-2),
                        dim=-2).values.flip(-2)
    d = torch.minimum(idx - last, nxt - idx)
    return torch.where(torch.isfinite(d), d, float(h + w))


def edt(input_arr: torch.Tensor,
        spacing: Sequence[float] = _UNIT) -> torch.Tensor:
    """``scipy.ndimage.distance_transform_edt(input, sampling=spacing)`` of
    ``(H, W)`` or ``(N, H, W)``: each nonzero pixel's distance to the nearest
    zero, 0 on zeros, float32. ``spacing`` is ``(row, column)``."""
    sy, sx = float(spacing[0]), float(spacing[1])
    nz = input_arr != 0
    g = _nearest_zero_dist_1d(~nz) * sy
    w = g.shape[-1]
    k = torch.arange(w, dtype=torch.float32, device=g.device) * sx
    off2 = torch.square(k[None, :] - k[:, None])          # (W_out, W_k)
    # D2[..., i, j] = min_k (g2[..., i, k] + off2[j, k])
    d2 = torch.amin(torch.square(g)[..., :, None, :] + off2, dim=-1)
    # PyTorch's float32 sqrt on the card is not correctly rounded (one ulp
    # off at some integers); the float64 root rounded to float32 is, on any
    # device, as 53 >= 2 * 24 + 2 bits make the double rounding innocuous
    d = torch.sqrt(d2.to(torch.float64)).to(torch.float32)
    return torch.where(nz, d, 0.0)


def _masked_sorted(values: torch.Tensor, valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort the last axis ascending with invalid entries at +inf; returns
    ``(sorted, n_valid)``."""
    v = torch.where(valid, values, torch.inf)
    return torch.sort(v, dim=-1).values, valid.sum(dim=-1)


def surface_distances(pred: torch.Tensor, gt: torch.Tensor,
                      spacing: Sequence[float] = _UNIT
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sorted distances, n)`` of the A->B and B->A sets together, per
    slice: ``edt(~gt)`` on the pixels of ``pred``, then ``edt(~pred)`` on
    those of ``gt``; the ``2 * H * W - n`` unused entries hold +inf."""
    a = pred > 0
    b = gt > 0
    vals = torch.cat([edt(~b, spacing).flatten(-2),
                      edt(~a, spacing).flatten(-2)], dim=-1)
    valid = torch.cat([a.flatten(-2), b.flatten(-2)], dim=-1)
    return _masked_sorted(vals, valid)


def _masked_percentile(sorted_vals: torch.Tensor, n: torch.Tensor,
                       q: float) -> torch.Tensor:
    """``np.percentile`` (linear) of the first ``n`` entries of each sorted
    row, with the position taken in float32 as the JAX function does; 0
    where ``n == 0``."""
    nf = torch.clamp(n.to(torch.float32), min=1.0)
    pos = torch.full_like(nf, q / 100.0) * (nf - 1.0)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    frac = pos - lo
    vlo = torch.gather(sorted_vals, -1, lo.long()[..., None])[..., 0]
    vhi = torch.gather(sorted_vals, -1, hi.long()[..., None])[..., 0]
    out = vlo * (1.0 - frac) + vhi * frac
    return torch.where(n > 0, out, 0.0)


def _assd_from(sorted_vals: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    # the sum is taken in float64, so that it does not depend on the
    # device's order of summation
    finite = torch.where(torch.isfinite(sorted_vals), sorted_vals, 0.0)
    total = finite.sum(dim=-1, dtype=torch.float64)
    mean = (total / torch.clamp(n, min=1)).to(torch.float32)
    return torch.where(n > 0, mean, 0.0)


def hd95_assd(pred: torch.Tensor, gt: torch.Tensor,
              spacing: Sequence[float] = _UNIT
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hd95, assd)`` per slice, from one pair of transforms."""
    d, n = surface_distances(pred, gt, spacing)
    return _masked_percentile(d, n, 95.0), _assd_from(d, n)


def hd95(pred: torch.Tensor, gt: torch.Tensor,
         spacing: Sequence[float] = _UNIT) -> torch.Tensor:
    """95th-percentile symmetric surface distance, per slice."""
    return hd95_assd(pred, gt, spacing)[0]


def assd(pred: torch.Tensor, gt: torch.Tensor,
         spacing: Sequence[float] = _UNIT) -> torch.Tensor:
    """Average symmetric surface distance, per slice."""
    return hd95_assd(pred, gt, spacing)[1]
