"""Report-time segmentation metrics, returning floats.

Counterpart: ``medimetrics.py:18-33`` in
``mri_acl_imagesegmentation_adsp_tpu/metrics/`` (the reference's
``src/metrics/medimetrics.py``): ``dice_bin`` and
``iou_bin`` of a {0, 1} pair, ``hd95`` and ``assd`` by the exact EDT with an
optional ``(row, column)`` spacing. Inputs are numpy arrays or tensors; a
tensor is measured on its own device."""

from __future__ import annotations

import torch

from ..ops import edt as _edt
from ..train import metrics as _loop_metrics


def _spacing(spacing):
    return tuple(spacing) if spacing is not None else (1.0, 1.0)


def dice_bin(pred, gt, eps: float = 1e-7) -> float:
    return float(_loop_metrics.dice_bin(torch.as_tensor(pred),
                                        torch.as_tensor(gt), eps))


def iou_bin(pred, gt, eps: float = 1e-7) -> float:
    return float(_loop_metrics.iou_bin(torch.as_tensor(pred),
                                       torch.as_tensor(gt), eps))


def hd95(pred, gt, spacing=None) -> float:
    return float(_edt.hd95(torch.as_tensor(pred), torch.as_tensor(gt),
                           _spacing(spacing)))


def assd(pred, gt, spacing=None) -> float:
    return float(_edt.assd(torch.as_tensor(pred), torch.as_tensor(gt),
                           _spacing(spacing)))
