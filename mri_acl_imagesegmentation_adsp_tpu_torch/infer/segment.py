"""Whole-volume 2-D segmentation.

Counterparts in ``mri_acl_imagesegmentation_adsp_tpu/infer/segment.py``:
``_neighbor_stack`` (:31-37), ``segment_volume_2d`` (:86-122),
``tta_wrap`` (:125-152), ``segment_volumes_2d`` with ``_masked_runner``
(:208-290) and ``evaluate_volume`` (:353-388). The JAX version runs the
batches in one ``lax.scan`` and rounds step counts to powers of two to bound
XLA compiles; here a plain loop over batches runs under
``torch.inference_mode()``. ``apply_fn`` maps an NCHW batch to NCHW logits;
volumes are ``(S, H, W)`` or ``(S, 1, H, W)`` tensors and results stay on
their device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops.edt import hd95_assd
from ..train.metrics import dice_bin, iou_bin

# slices per exact-EDT call: each materializes (N, H, W, W) float32, 1.05 GB
# for 8 slices at 320^2
SURFACE_CHUNK = 8


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


def tta_wrap(apply_fn: Callable, classes: int, tta: str) -> Callable:
    """``apply_fn`` with horizontal-flip test-time augmentation.

    The wrapped function averages the probabilities of the batch and of its
    mirror image along W (flipped back), and returns them through the
    activation's inverse, so that the sigmoid or softmax downstream yields
    the mean exactly: ``logit(clip(mean sigmoid, 1e-7, 1 - 1e-7))`` for one
    class, ``log(clip(mean softmax, 1e-30))`` otherwise. ``"none"`` returns
    ``apply_fn`` itself."""
    if tta in (None, "none"):
        return apply_fn
    if tta != "hflip":
        raise ValueError(f"tta must be 'none' or 'hflip', got {tta!r}")

    def tta_fn(x: torch.Tensor) -> torch.Tensor:
        logits = apply_fn(x)
        flipped = apply_fn(x.flip(3)).flip(3)
        if classes == 1:
            p = 0.5 * (torch.sigmoid(logits) + torch.sigmoid(flipped))
            p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
            return torch.log(p) - torch.log1p(-p)
        pa = 0.5 * (torch.softmax(logits, dim=1)
                    + torch.softmax(flipped, dim=1))
        return torch.log(torch.clamp(pa, min=1e-30))
    return tta_fn


def segment_volume_2d(apply_fn: Callable, volume: torch.Tensor, k: int = 1,
                      batch_size: int = 16, classes: int = 1,
                      tta: str = "none") -> torch.Tensor:
    """Probabilities ``(S, C, H, W)`` (sigmoid for one class, softmax over
    classes otherwise) of every slice of a volume."""
    return segment_volumes_2d(apply_fn, [volume], k, batch_size, classes,
                              tta=tta)[0]


@torch.inference_mode()
def segment_volumes_2d(apply_fn: Callable, volumes: Sequence[torch.Tensor],
                       k: int = 1, batch_size: int = 16, classes: int = 1,
                       masks_only_threshold: Optional[float] = None,
                       tta: str = "none") -> List[torch.Tensor]:
    """Segment several volumes in one run of batches; neighbour stacks are
    built per volume, so no channel crosses a volume boundary.

    Returns ``(S_i, C, H, W)`` probabilities per volume, or with
    ``masks_only_threshold`` set, ``(S_i, H, W)`` uint8 masks thresholded on
    the device by :func:`threshold_probs`. ``tta`` is :func:`tta_wrap`'s."""
    if not volumes:
        return []
    apply_fn = tta_wrap(apply_fn, classes, tta)
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


def slice_metrics(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
                  spacing=(1.0, 1.0), with_surface: bool = True
                  ) -> torch.Tensor:
    """Per-slice ``[dice, iou, hd95, assd]`` (``[dice, iou]`` without the
    surface metrics) of ``(S, H, W)`` {0, 1} masks, ``(S, 4)`` float32 on
    their device, with no read-back to the host. The surface metrics run
    ``SURFACE_CHUNK`` slices at a time."""
    pred, gt = torch.as_tensor(pred_mask), torch.as_tensor(gt_mask)
    if pred.dim() == 2:
        pred, gt = pred[None], gt[None]
    cols = [dice_bin(pred, gt), iou_bin(pred, gt)]
    if with_surface:
        surf = [hd95_assd(pred[i:i + SURFACE_CHUNK], gt[i:i + SURFACE_CHUNK],
                          spacing)
                for i in range(0, pred.shape[0], SURFACE_CHUNK)]
        cols += [torch.cat([h for h, _ in surf]),
                 torch.cat([a for _, a in surf])]
    return torch.stack(cols, dim=1)


def evaluate_volume(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
                    spacing=(1.0, 1.0), with_surface: bool = True
                    ) -> Dict[str, float]:
    """Dice, IoU and (``with_surface``) HD95 and ASSD of a volume, each the
    mean over its slices (the reference's medimetrics on {0, 1} slices),
    computed on the masks' device."""
    names = ("dice", "iou", "hd95", "assd")
    means = slice_metrics(pred_mask, gt_mask, spacing, with_surface).mean(0)
    return dict(zip(names, means.tolist()))
