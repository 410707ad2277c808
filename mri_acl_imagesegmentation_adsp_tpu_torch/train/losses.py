"""Segmentation losses, computed in f32 whatever the logits' dtype (float64
logits keep float64).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/losses.py:25-244``:
the binary losses (:29-103), the multiclass losses (:106-131), the 3-D
DiceCE losses (:134-166) and ``LossManager`` (:173-235). Shapes: binary
logits and targets ``(N, 1, H, W)``; multiclass logits ``(N, C, H, W)``
with integer targets ``(N, H, W)``; the 3-D losses take ``(N, C, D, H,
W)`` logits with ``(N, 1, D, H, W)`` float targets (binary) or ``(N, D, H,
W)`` labels.

``max(x, 0)`` is ``torch.maximum`` against zeros, whose gradient at a tie
splits in half as ``jnp.maximum``'s does (``clamp`` would give it whole).

Under data parallelism (``group``, a ``parallel.DataGroup``) the
batch-global sums of the Dice and Tversky losses are summed over the ranks
by one differentiable all-reduce before their ratio, so each rank's loss
holds the global batch's Dice term; the means (BCE, CE, focal) stay each
rank's mean of its equal share, whose mean over the ranks is the global
mean.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..models.norm import at_least_f32 as _f
from ..parallel.mesh import all_reduce_sum


def _bce_terms(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Stable elementwise BCE-with-logits, ``max(x,0) - x*t +
    log1p(exp(-|x|))``."""
    return (torch.maximum(x, torch.zeros_like(x)) - x * t
            + torch.log1p(torch.exp(-torch.abs(x))))


def _present_dice(p: torch.Tensor, t: torch.Tensor, smooth: float,
                  eps: float, group=None) -> torch.Tensor:
    """Batch-global soft Dice loss per class of ``(N, C, L)`` probabilities
    and targets; a class absent from the target counts zero; mean over
    classes."""
    dims = (0, 2)
    inter, card, tsum = all_reduce_sum(torch.stack([
        torch.sum(p * t, dim=dims), torch.sum(p + t, dim=dims),
        torch.sum(t, dim=dims)]), group)
    score = (2.0 * inter + smooth) / torch.clamp_min(card + smooth, eps)
    present = (tsum > 0).to(score.dtype)
    return torch.mean((1.0 - score) * present)


def dice_loss_binary(logits: torch.Tensor, targets: torch.Tensor,
                     smooth: float = 0.0, eps: float = 1e-7,
                     group=None) -> torch.Tensor:
    """smp ``DiceLoss(mode="binary", from_logits=True)``."""
    n = logits.shape[0]
    p = torch.sigmoid(_f(logits)).reshape(n, 1, -1)
    t = targets.to(p.dtype).reshape(n, 1, -1)
    return _present_dice(p, t, smooth, eps, group)


def soft_bce_loss(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """BCE with logits, mean reduction (smp ``SoftBCEWithLogitsLoss``)."""
    return torch.mean(_bce_terms(_f(logits), targets.float()))


def focal_loss_binary(logits: torch.Tensor, targets: torch.Tensor,
                      alpha: Optional[float] = 0.25,
                      gamma: float = 2.0) -> torch.Tensor:
    """smp ``FocalLoss(mode="binary")`` (not normalized)."""
    x = logits.float().reshape(-1)
    t = targets.float().reshape(-1)
    logpt = -_bce_terms(x, t)
    focal = torch.pow(1.0 - torch.exp(logpt), gamma) * (-logpt)
    if alpha is not None:
        focal = focal * (alpha * t + (1.0 - alpha) * (1.0 - t))
    return torch.mean(focal)


def tversky_loss(logits: torch.Tensor, targets: torch.Tensor,
                 alpha: float = 0.7, beta: float = 0.3,
                 eps: float = 1e-7, group=None) -> torch.Tensor:
    """Tversky loss over dims (0, 2, 3), mean over classes."""
    p = torch.sigmoid(_f(logits))
    t = targets.to(p.dtype)
    dims = (0, 2, 3)
    tp, fp, fn = all_reduce_sum(torch.stack([
        torch.sum(p * t, dim=dims), torch.sum(p * (1.0 - t), dim=dims),
        torch.sum((1.0 - p) * t, dim=dims)]), group)
    tv = (tp + eps) / (tp + alpha * fp + beta * fn + eps)
    return 1.0 - torch.mean(tv)


def focal_tversky_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.7, beta: float = 0.3,
                       gamma: float = 0.75, group=None) -> torch.Tensor:
    """``tversky_loss ** gamma``."""
    return torch.pow(tversky_loss(logits, targets, alpha, beta,
                                  group=group), gamma)


def _one_hot(targets: torch.Tensor, c: int) -> torch.Tensor:
    """``(N, ...)`` labels -> ``(N, C, L)`` f32 one-hot; a label outside
    ``[0, C)`` gives a zero row, as ``jax.nn.one_hot`` does."""
    t = targets.reshape(targets.shape[0], 1, -1).long()
    classes = torch.arange(c, device=targets.device).view(1, c, 1)
    return (t == classes).float()


def dice_loss_multiclass(logits: torch.Tensor, targets: torch.Tensor,
                         smooth: float = 0.0, eps: float = 1e-7,
                         group=None) -> torch.Tensor:
    """smp ``DiceLoss(mode="multiclass")``: softmax probabilities, one-hot
    targets."""
    n, c = logits.shape[0], logits.shape[1]
    p = torch.softmax(_f(logits), dim=1).reshape(n, c, -1)
    return _present_dice(p, _one_hot(targets, c).to(p.dtype), smooth, eps,
                         group)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """``nn.CrossEntropyLoss`` over ``(N, C, H, W)`` logits and ``(N, H, W)``
    labels, mean reduction."""
    logp = torch.log_softmax(_f(logits), dim=1)
    nll = -torch.gather(logp, 1, targets.long()[:, None])
    return torch.mean(nll)


def _dice_3d(p: torch.Tensor, t: torch.Tensor, smooth_nr: float,
             smooth_dr: float) -> torch.Tensor:
    """MONAI's per-sample, per-class soft Dice loss (``batch=False``, no
    masking of absent classes), mean over samples and classes."""
    dims = tuple(range(2, p.dim()))
    inter = torch.sum(p * t, dim=dims)
    denom = torch.sum(p, dim=dims) + torch.sum(t, dim=dims)
    return torch.mean(1.0 - (2.0 * inter + smooth_nr) / (denom + smooth_dr))


def dice_ce_loss_3d_binary(logits: torch.Tensor, targets: torch.Tensor,
                           smooth_nr: float = 1e-5,
                           smooth_dr: float = 1e-5) -> torch.Tensor:
    """MONAI ``DiceCELoss(sigmoid=True)`` for binary ``(N, 1, D, H, W)``:
    the per-sample soft Dice plus the BCE, summed 1:1."""
    p = torch.sigmoid(logits.float())
    return (_dice_3d(p, targets.float(), smooth_nr, smooth_dr)
            + soft_bce_loss(logits, targets))


def dice_ce_loss_3d_multiclass(logits: torch.Tensor, targets: torch.Tensor,
                               smooth_nr: float = 1e-5,
                               smooth_dr: float = 1e-5) -> torch.Tensor:
    """MONAI ``DiceCELoss(softmax=True, to_onehot_y=True)``: the per-sample
    per-class soft Dice of softmax probabilities against one-hot labels
    (background included) plus the softmax CE, summed 1:1."""
    c = logits.shape[1]
    p = torch.softmax(logits.float(), dim=1)
    t1h = _one_hot(targets, c).reshape(p.shape)
    return (_dice_3d(p, t1h, smooth_nr, smooth_dr)
            + cross_entropy_loss(logits, targets))


_BINARY = {"dice_bce": "dice_bce", "bce_dice": "dice_bce",
           "dice+bce": "dice_bce", "focal": "focal", "tversky": "tversky",
           "focal_tversky": "focal_tversky",
           "focal-tversky": "focal_tversky"}
_MULTICLASS = {"dice_ce": "dice_ce", "dice+ce": "dice_ce",
               "ce_dice": "dice_ce", "ce": "ce", "cross_entropy": "ce"}


@dataclass
class LossManager:
    """Callable loss chosen by name (and alias) and class count; the
    weighted combinations blend with ``weights`` (default 0.5, 0.5)."""
    classes: int = 1
    name: str = "dice_bce"
    weights: Optional[Tuple[float, float]] = None
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    tversky_alpha: float = 0.7
    tversky_beta: float = 0.3
    tversky_gamma: float = 0.75

    def __post_init__(self):
        self.classes = int(self.classes)
        self.name = str(self.name).lower()
        if self.weights is None:
            self.weights = (0.5, 0.5)
        table = _BINARY if self.classes == 1 else _MULTICLASS
        if self.name not in table:
            kind = "binary" if self.classes == 1 else "multiclass"
            raise ValueError(f"Unknown {kind} loss: {self.name}")
        self._kind = table[self.name]

    @classmethod
    def from_config(cls, cfg: dict) -> "LossManager":
        return cls(
            classes=cfg.get("classes", 1),
            name=cfg.get("loss_name", cfg.get("loss", "dice_bce")),
            weights=(tuple(cfg["loss_weights"]) if cfg.get("loss_weights")
                     else None),
            focal_alpha=cfg.get("focal_alpha", 0.25),
            focal_gamma=cfg.get("focal_gamma", 2.0),
            tversky_alpha=cfg.get("tversky_alpha", 0.7),
            tversky_beta=cfg.get("tversky_beta", 0.3),
            tversky_gamma=cfg.get("tversky_gamma", 0.75),
        )

    def __call__(self, logits: torch.Tensor, targets: torch.Tensor,
                 group=None) -> torch.Tensor:
        """The loss of a batch, or with ``group`` of this rank's share of
        a data-parallel global batch (module docstring)."""
        w0, w1 = float(self.weights[0]), float(self.weights[1])
        kind = self._kind
        if kind == "dice_bce":
            return (w0 * dice_loss_binary(logits, targets, group=group)
                    + w1 * soft_bce_loss(logits, targets))
        if kind == "focal":
            return focal_loss_binary(logits, targets, self.focal_alpha,
                                     self.focal_gamma)
        if kind == "tversky":
            return tversky_loss(logits, targets, self.tversky_alpha,
                                self.tversky_beta, group=group)
        if kind == "focal_tversky":
            return focal_tversky_loss(logits, targets, self.tversky_alpha,
                                      self.tversky_beta, self.tversky_gamma,
                                      group=group)
        if kind == "dice_ce":
            return (w0 * dice_loss_multiclass(logits, targets, group=group)
                    + w1 * cross_entropy_loss(logits, targets))
        return cross_entropy_loss(logits, targets)
