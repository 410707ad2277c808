"""BatchNorm with the JAX package's statistics and update rule (NCHW), and
the InstanceNorm that the fastMRI U-Net and the 3-D U-Net share.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/models/norm.py``:
``BatchNorm`` (:65-116) and ``_scale_shift`` with its VJP (:42-58); and
Flax ``GroupNorm(num_groups=None, group_size=1)`` as the JAX package's
``models/unet3d.py`` and ``models/fastmri_unet.py`` use it.

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
  runs in the input's dtype, with the ``a`` / ``b`` gradients summed in f32;
* under :func:`synced` (data parallelism) the statistics are the global
  batch's: each rank's f32 ``sum x``, ``sum x^2`` and count are summed over
  the ranks by one differentiable all-reduce before the ratio, as XLA sums
  a sharded batch's mean in the JAX engine, so every rank normalizes, and
  moves its running statistics, as one rank holding the whole batch would.

The module subclasses ``nn.BatchNorm2d`` for its parameters, buffers and
state_dict keys (``weight``, ``bias``, ``running_mean``, ``running_var``,
``num_batches_tracked``), so checkpoints and ``models/convert.py`` are
unchanged; only ``forward`` is its own.

:func:`remat` is ``nn.remat``'s counterpart: a block recomputed in the
backward pass (``torch.utils.checkpoint``, not reentrant). The recompute
runs ``forward`` a second time on the same input, so it normalizes with
the same batch statistics; it leaves the running statistics alone, which
therefore move once a step, as the functional JAX update moves them.

:class:`InstanceNorm` is that ``GroupNorm`` over ``(N, C, *)``: an affine
``scale`` / ``bias`` (here ``weight`` / ``bias``, f32 parameters),
statistics per sample and channel in f32, epsilon 1e-6 (not torch's 1e-5),
no running statistics (train and eval normalize alike), the result in the
input's dtype. It is torch's ``group_norm`` with a group a channel on the
f32 upcast, a native kernel or two each way; its variance is two-pass
where Flax's is ``max(0, E[x^2] - E[x]^2)``, the same up to f32 rounding.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import all_reduce_sum

# set on the thread that recomputes a remat block in the backward pass
_RECOMPUTE = threading.local()


@contextmanager
def _recomputing() -> Iterator[None]:
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


def remat(on: bool, block: nn.Module, *args):
    """``block(*args)``; when ``on`` and gradients are taken in train mode,
    its activations are recomputed in the backward pass instead of kept.
    BatchNorm's running statistics move only in the forward pass."""
    if not (on and block.training and torch.is_grad_enabled()):
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=lambda: (nullcontext(), _recomputing()))


# Flax's momentum: the weight of the running value in the update
FLAX_MOMENTUM = 0.9
GN_EPS = 1e-6          # flax.linen.GroupNorm's default epsilon


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, or float64 for a float64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or kept in float64 (a float64 model's inputs, logits
    and losses stay float64 end to end)."""
    return x.to(_acc_dtype(x))


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
        self.group = None       # a DataGroup while ``synced``

    def _batch_moments(self, xf: torch.Tensor):
        """``E[x]`` and ``E[x^2]`` per channel, over the global batch when
        a group is set."""
        if self.group is None:
            return xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
        c = xf.shape[1]
        sums = all_reduce_sum(torch.cat([
            xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
            xf.new_full((1,), xf.numel() // c)]), self.group)
        return sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, mu2 = self._batch_moments(x.to(_acc_dtype(x)))
            var = torch.maximum(mu2 - mean * mean, torch.zeros_like(mean))
            # a remat recompute leaves them as the forward pass moved them
            if not getattr(_RECOMPUTE, "on", False):
                with torch.no_grad():
                    m = FLAX_MOMENTUM
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        return _ScaleShift.apply(x, a, b)


@contextmanager
def synced(model: nn.Module, group) -> Iterator[None]:
    """Inside the block, the train-mode statistics of ``model``'s
    :class:`BatchNorm2d` layers are the group's global batch's (``group``
    None: each rank's own)."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.group = group
    try:
        yield
    finally:
        for m in layers:
            m.group = None


class InstanceNorm(nn.Module):
    """Flax ``GroupNorm(num_groups=None, group_size=1)`` over ``(N, C, *)``
    (see the module docstring). With a ``depth_band``
    (``parallel/spatial.py:depth_sharded``) ``x`` is one rank's depth
    band and the statistics are the whole volume's (see
    :func:`_band_norm`)."""

    def __init__(self, channels: int, eps: float = GN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.depth_band = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Flax normalizes the f32 upcast and casts the result back; CUDA's
        # group_norm also wants the input in its parameters' dtype
        acc = torch.promote_types(x.dtype, self.weight.dtype)
        if self.depth_band is not None:
            return _band_norm(x.to(acc), self.weight.to(acc),
                              self.bias.to(acc), self.eps,
                              self.depth_band.group).to(x.dtype)
        return F.group_norm(x.to(acc), x.shape[1], self.weight.to(acc),
                            self.bias.to(acc), self.eps).to(x.dtype)


def _band_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, group) -> torch.Tensor:
    """The instance norm of a volume of which ``x`` ``(N, C, d, H, W)`` is
    one rank's depth band: two passes as the one-rank norm takes them, the
    mean first (each (sample, channel)'s sum and the plane count summed
    over ``group`` by one differentiable all-reduce), then the centred
    squares (a second), so every rank normalizes by the whole volume's
    statistics."""
    n, c = x.shape[:2]
    dims = tuple(range(2, x.dim()))
    shape = (n, c) + (1,) * (x.dim() - 2)
    s = all_reduce_sum(torch.cat([x.sum(dim=dims).reshape(-1),
                                  x.new_full((1,), x[0, 0].numel())]), group)
    xc = x - (s[:-1] / s[-1]).view(shape)
    var = all_reduce_sum((xc * xc).sum(dim=dims), group) / s[-1]
    y = xc * torch.rsqrt(var + eps).view(shape)
    return y * weight.view(1, c, *shape[2:]) + bias.view(1, c, *shape[2:])
