"""Whole-volume 2-D segmentation.

Counterparts in ``mri_acl_imagesegmentation_adsp_tpu/infer/segment.py``:
``_neighbor_stack`` (:31-37), ``segment_volume_2d`` (:86-122) and the
mask-only form of ``segment_volumes_2d`` / ``_masked_runner`` (:208-290).
The JAX version runs the batches in one ``lax.scan`` and rounds step counts
to powers of two to bound XLA compiles; here a plain loop over batches runs
under ``torch.inference_mode()``. ``apply_fn`` maps an NCHW batch to NCHW
logits; volumes are ``(S, H, W)`` or ``(S, 1, H, W)`` tensors and results
stay on their device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch


def _neighbor_stack(vol: torch.Tensor, k: int) -> torch.Tensor:
    """(S, H, W) -> (S, k, H, W) edge-clamped 2.5-D neighbour channels."""
    s = vol.shape[0]
    idx = torch.arange(s, device=vol.device)
    half = k // 2
    return torch.stack([vol[(idx + d).clamp(0, s - 1)]
                        for d in range(-half, half + 1)], dim=1)


def _as_slices(volume: torch.Tensor, k: int) -> torch.Tensor:
    vol = volume[:, 0] if volume.dim() == 4 else volume
    if vol.dim() != 3:
        raise ValueError("each volume must be (S,H,W) or (S,1,H,W), got "
                         f"shape {tuple(volume.shape)}")
    if vol.shape[0] == 0:
        raise ValueError("empty volume (0 slices)")
    if k % 2 != 1:
        raise ValueError(f"k must be odd (2.5-D stacks k//2 neighbors per "
                         f"side); got k={k}")
    return vol.float()


def threshold_probs(probs: torch.Tensor, classes: int,
                    threshold: float) -> torch.Tensor:
    """``(S, C, H, W)`` probabilities -> ``(S, H, W)`` uint8 mask on their
    device: ``probs > threshold`` for one class, the argmax otherwise."""
    if classes == 1:
        return (probs[:, 0] > float(threshold)).to(torch.uint8)
    return probs.argmax(dim=1).to(torch.uint8)


def segment_volume_2d(apply_fn: Callable, volume: torch.Tensor, k: int = 1,
                      batch_size: int = 16, classes: int = 1) -> torch.Tensor:
    """Probabilities ``(S, C, H, W)`` (sigmoid for one class, softmax over
    classes otherwise) of every slice of a volume."""
    return segment_volumes_2d(apply_fn, [volume], k, batch_size, classes)[0]


@torch.inference_mode()
def segment_volumes_2d(apply_fn: Callable, volumes: Sequence[torch.Tensor],
                       k: int = 1, batch_size: int = 16, classes: int = 1,
                       masks_only_threshold: Optional[float] = None
                       ) -> List[torch.Tensor]:
    """Segment several volumes in one run of batches; neighbour stacks are
    built per volume, so no channel crosses a volume boundary.

    Returns ``(S_i, C, H, W)`` probabilities per volume, or with
    ``masks_only_threshold`` set, ``(S_i, H, W)`` uint8 masks thresholded on
    the device by :func:`threshold_probs`."""
    if not volumes:
        return []
    vols = [_as_slices(v, k) for v in volumes]
    if any(v.shape[1:] != vols[0].shape[1:] for v in vols):
        raise ValueError("volumes must share (H, W); got "
                         f"{[tuple(v.shape) for v in vols]}")
    x = torch.cat([_neighbor_stack(v, k) for v in vols])

    def head(logits):
        probs = (torch.sigmoid(logits) if classes == 1
                 else torch.softmax(logits, dim=1))
        if masks_only_threshold is None:
            return probs
        return threshold_probs(probs, classes, masks_only_threshold)
    out = torch.cat([head(apply_fn(x[i:i + batch_size]))
                     for i in range(0, x.shape[0], batch_size)])
    return list(torch.split(out, [v.shape[0] for v in vols]))
