"""In-loop and report metrics for binary masks.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/metrics.py:16-42``:
``bin_dice_iou`` (batch-global over dims (0, 2, 3), eps 1e-7, mean over
channels; the caller thresholds), ``dice_bin`` and ``iou_bin`` on one
``(H, W)`` pair."""

from __future__ import annotations

from typing import Tuple

import torch


def bin_dice_iou(preds: torch.Tensor, masks: torch.Tensor,
                 eps: float = 1e-7) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dice and IoU of binary ``(N, 1, H, W)`` {0, 1} tensors, as 0-d
    tensors on their device."""
    p = preds.float()
    m = masks.float()
    dims = (0, 2, 3)
    inter = torch.sum(p * m, dim=dims)
    dice = (2.0 * inter + eps) / (torch.sum(p, dim=dims)
                                  + torch.sum(m, dim=dims) + eps)
    iou = (inter + eps) / (torch.sum(p + m - p * m, dim=dims) + eps)
    return torch.mean(dice), torch.mean(iou)


def dice_bin(pred: torch.Tensor, gt: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """Dice of one ``(H, W)`` {0, 1} pair."""
    p, g = pred.float(), gt.float()
    return (2.0 * torch.sum(p * g) + eps) / (torch.sum(p) + torch.sum(g)
                                             + eps)


def iou_bin(pred: torch.Tensor, gt: torch.Tensor,
            eps: float = 1e-7) -> torch.Tensor:
    """IoU of one ``(H, W)`` {0, 1} pair."""
    p, g = pred.float(), gt.float()
    inter = torch.sum(p * g)
    return (inter + eps) / (torch.sum(p) + torch.sum(g) - inter + eps)
