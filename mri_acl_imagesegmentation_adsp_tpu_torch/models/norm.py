"""BatchNorm with the JAX package's statistics and update rule (NCHW).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/models/norm.py``:
``BatchNorm`` (:65-116) and ``_scale_shift`` with its VJP (:42-58).

torch's own ``nn.BatchNorm2d`` differs from it in train mode: it folds the
unbiased batch variance into ``running_var``, where the reference folds the
biased one. Here, in train mode:

* the batch mean and variance are f32 reductions taken in one pass,
  ``var = max(0, E[x^2] - E[x]^2)`` (biased), also under bf16 autocast
  (float64 inputs keep float64);
* the input is normalized with that ``var`` and the running stats move by
  ``0.9 * running + 0.1 * batch``, mean and var alike;
* the statistics and affine fold into per-channel ``a = weight *
  rsqrt(var + eps)``, ``b = bias - mean * a`` (f32), and ``y = x * a + b``
  runs in the input's dtype, with the ``a`` / ``b`` gradients summed in f32.

The module subclasses ``nn.BatchNorm2d`` for its parameters, buffers and
state_dict keys (``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``), so checkpoints and ``models/convert.py`` are
unchanged; only ``forward`` is its own.
"""

from __future__ import annotations

import torch
from torch import nn

# Flax's momentum: the weight of the running value in the update
FLAX_MOMENTUM = 0.9


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, or float64 for a float64 input."""
    return torch.promote_types(x.dtype, torch.float32)


class _ScaleShift(torch.autograd.Function):
    """``y = x * a + b`` over the channel axis of NCHW ``x``, in x.dtype;
    the (C,) gradients are sums of products in at least f32."""

    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a)
        return (x * a.to(x.dtype).view(1, -1, 1, 1)
                + b.to(x.dtype).view(1, -1, 1, 1))

    @staticmethod
    def backward(ctx, g):
        x, a = ctx.saved_tensors
        dx = (g * a.to(g.dtype).view(1, -1, 1, 1)).to(x.dtype)
        acc = _acc_dtype(x)
        gf = g.to(acc)
        da = (gf * x.to(acc)).sum(dim=(0, 2, 3))
        db = gf.sum(dim=(0, 2, 3))
        return dx, da.to(a.dtype), db.to(a.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d``'s state with the reference's train-mode math (see
    the module docstring). Always tracks running stats and has an affine."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1 - FLAX_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(_acc_dtype(x))
            mean = xf.mean(dim=(0, 2, 3))
            mu2 = (xf * xf).mean(dim=(0, 2, 3))
            var = torch.maximum(mu2 - mean * mean, torch.zeros_like(mean))
            with torch.no_grad():
                m = FLAX_MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        return _ScaleShift.apply(x, a, b)
