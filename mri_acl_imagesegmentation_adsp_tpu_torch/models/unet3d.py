"""3-D residual U-Net for ROI patches and whole volumes (NCDHW).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/models/unet3d.py``:
``_ResUnit3D`` (:40-63) and ``ResidualUNet3D`` (:66-133), the reference's
MONAI ``UNet(spatial_dims=3, channels=(32, 64, 128, 256, 320), strides=(2,
2, 2, 2), num_res_units=2)``. Each level is a residual unit of two
conv3x3x3 -> InstanceNorm -> PReLU (the first conv strided on the way
down) plus a 1x1x1 conv on the residual when the width or stride changes;
the up path is a kernel-2 stride-2 transpose conv, a concat with the skip
and a unit; a 1x1x1 conv is the head.

What the Flax module computes, and this one with it:

* ``padding="SAME"`` pads each spatial dimension by its own rule: a 3x3x3
  conv at stride 2 pads an even size by (0, 1) and an odd one by (1, 1);
  at stride 1 by (1, 1); the 1x1x1 residual conv not at all. Symmetric
  padding would give the same shapes on a grid shifted by one voxel.
* ``GroupNorm(num_groups=None, group_size=1)`` is an InstanceNorm with an
  affine ``scale`` / ``bias``: ``models/norm.py:InstanceNorm``, shared with
  the fastMRI U-Net.
* ``PReLU`` is one scalar slope, initialized to 0.01.
* The transpose conv's Flax kernel ``(2, 2, 2, Ci, Co)`` is applied
  unflipped as a lhs-dilated conv, which is ``ConvTranspose3d`` with the
  spatially flipped kernel (``models/convert.py``). The JAX package's
  phase-space lowering of it (``fused_up``) is the same function.
* ``dtype`` is the compute dtype: the input, kernels and biases are cast
  to it (bf16 under ``amp``), parameters stay f32, biases are added after
  each conv in that dtype, and the logits come back in f32.
* ``remat``: each unit is recomputed in the backward pass
  (``models/norm.py:remat``) when gradients are taken in train mode;
  there is no state and no randomness in a unit, so it changes no number.

Module names follow the Flax tree: ``units.{i}`` is ``_ResUnit3D_{i}``
(with ``convs.{j}`` / ``norms.{j}`` / ``acts.{j}`` its ``Conv_{j}`` /
``GroupNorm_{j}`` / ``PReLU_{j}`` and ``residual`` its last conv),
``up.{n}`` is ``ConvTranspose_{n}`` and ``head`` is ``Conv_0``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import conv3d_band, same_pads
from .norm import InstanceNorm, at_least_f32, remat

PRELU_INIT = 0.01      # flax.linen.PReLU's default negative_slope


class SameConv3d(nn.Conv3d):
    """``nn.Conv`` with ``padding="SAME"`` in a compute dtype: pads each
    dimension by :func:`same_pads`, convolves with the kernel cast to the
    input's dtype, then adds the bias in that dtype. With a
    ``depth_band`` (``parallel/spatial.py:depth_sharded``) ``x`` is one
    rank's depth band and the depth padding comes from its neighbours."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=True)
        self.depth_band = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        if self.depth_band is not None:
            y = conv3d_band(x, self.weight.to(x.dtype), s, self.depth_band)
            return y + self.bias.to(x.dtype).view(1, -1, 1, 1, 1)
        pads: List[int] = []
        for n in reversed(x.shape[2:]):      # F.pad: last dimension first
            pads.extend(same_pads(int(n), k, s))
        if any(pads):
            x = F.pad(x, pads)
        y = F.conv3d(x, self.weight.to(x.dtype), None, self.stride)
        return y + self.bias.to(x.dtype).view(1, -1, 1, 1, 1)


class PReLU(nn.Module):
    """Flax ``PReLU``: ``where(x >= 0, x, slope * x)`` with one scalar
    slope (held as shape ``(1,)``, torch's layout), cast to x's dtype."""

    def __init__(self, init: float = PRELU_INIT):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class ResUnit3D(nn.Module):
    """``_ResUnit3D``: ``num_convs`` x (conv3x3x3, norm, PReLU), the first
    conv at ``stride``, plus the residual (a strided 1x1x1 conv when the
    width or stride changes)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 num_convs: int = 2):
        super().__init__()
        self.convs = nn.ModuleList(
            [SameConv3d(cin if i == 0 else features, features, 3,
                        stride if i == 0 else 1) for i in range(num_convs)])
        self.norms = nn.ModuleList([InstanceNorm(features)
                                    for _ in range(num_convs)])
        self.acts = nn.ModuleList([PReLU() for _ in range(num_convs)])
        self.residual: Optional[SameConv3d] = None
        if cin != features or stride != 1:
            self.residual = SameConv3d(cin, features, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for conv, norm, act in zip(self.convs, self.norms, self.acts):
            y = act(norm(conv(y)))
        return y + (x if self.residual is None else self.residual(x))


class ResidualUNet3D(nn.Module):
    """NCDHW ``(B, in_ch, D, H, W)`` in, f32 logits ``(B, classes, D, H,
    W)`` out (one channel when ``classes`` is 1). Each dimension must
    survive ``len(channels) - 1`` halvings and double back to itself, i.e.
    divide by ``2 ** (len(channels) - 1)`` (as in the Flax module)."""

    def __init__(self, in_ch: int = 1, classes: int = 1,
                 channels: Sequence[int] = (32, 64, 128, 256, 320),
                 num_res_units: int = 2, dtype: torch.dtype = torch.float32,
                 remat: bool = True):
        super().__init__()
        chs = [int(c) for c in channels]
        if len(chs) < 2:
            raise ValueError(f"channels needs at least two widths: {chs}")
        self.channels, self.classes = tuple(chs), int(classes)
        self.dtype, self.remat = dtype, bool(remat)
        self.depth = len(chs) - 1
        units, cin = [], in_ch
        for i, ch in enumerate(chs[:-1]):
            units.append(ResUnit3D(cin, ch, 1 if i == 0 else 2,
                                   num_res_units))
            cin = ch
        units.append(ResUnit3D(cin, chs[-1], 2, num_res_units))
        ups, cin = [], chs[-1]
        for ch in reversed(chs[:-1]):
            ups.append(nn.ConvTranspose3d(cin, ch, 2, stride=2))
            units.append(ResUnit3D(2 * ch, ch, 1, num_res_units))
            cin = ch
        self.units = nn.ModuleList(units)
        self.up = nn.ModuleList(ups)
        self.head = SameConv3d(cin, 1 if classes == 1 else classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype)
        skips = []
        for i in range(self.depth):
            y = remat(self.remat, self.units[i], y)
            skips.append(y)
        y = remat(self.remat, self.units[self.depth], y)
        for n, (up, skip) in enumerate(zip(self.up, reversed(skips))):
            y = F.conv_transpose3d(y, up.weight.to(y.dtype), None, stride=2)
            y = y + up.bias.to(y.dtype).view(1, -1, 1, 1, 1)
            y = remat(self.remat, self.units[self.depth + 1 + n],
                      torch.cat([y, skip], dim=1))
        return at_least_f32(self.head(y))


def he_normal_(weight: torch.Tensor, fan_in: int,
               generator: torch.Generator) -> None:
    """Flax's ``he_normal`` in place: a normal truncated at 2 std, scaled
    so that its std is ``sqrt(2 / fan_in)``, drawn on the CPU."""
    # std of a unit normal truncated to [-2, 2] is 0.8796
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    weight.copy_(w)


def init_weights3d(model: nn.Module, generator: torch.Generator
                   ) -> nn.Module:
    """Seeded Flax init: He-normal (fan-in, truncated at 2 std) kernels,
    zero biases, norm scale 1 / bias 0, PReLU slopes 0.01. A transpose
    conv's fan-in is ``Ci * 8``, as Flax counts it on its ``(2, 2, 2, Ci,
    Co)`` kernel. The generator lives on the CPU."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                if isinstance(m, nn.ConvTranspose3d):
                    fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
                else:
                    fan_in = m.weight[0].numel()
                he_normal_(m.weight, fan_in, generator)
                m.bias.zero_()
            elif isinstance(m, InstanceNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, PReLU):
                m.weight.fill_(PRELU_INIT)
    return model
