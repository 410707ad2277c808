"""fastMRI's plain U-Net (InstanceNorm + LeakyReLU) over NCHW.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/models/fastmri_unet.py``:
``ConvBlock`` (:85-141), ``TransposeConvBlock`` (:144-191) and
``FastMRIUnet`` (:194-261), the prostate code's ``models/unet.py``, which
VarNet's cascades wrap (as ``NormUnet``) and the recon baseline trains.
``ConvBlock`` is two (conv3x3 -> InstanceNorm -> LeakyReLU(0.2) ->
dropout); the encoder pools 2x2 by average, the decoder upsamples by a
kernel-2 stride-2 transpose conv (+ norm + LeakyReLU) and concatenates the
skip; a 1x1 conv with a bias is the head (no other conv has one).

What the Flax module computes, and this one with it:

* ``GroupNorm(num_groups=None, group_size=1)`` is an InstanceNorm with an
  affine ``scale`` / ``bias``, epsilon 1e-6: ``models/norm.py:InstanceNorm``,
  shared with the 3-D U-Net.
* Odd sizes: H and W are padded by reflection at their ends to a multiple
  of ``2 ** num_pool_layers`` and the output is cropped back.
* The transpose conv's Flax kernel ``(2, 2, Ci, Co)`` is applied flipped:
  output phase ``(a, b)`` reads ``K[1 - a, 1 - b]``
  (``models/phaseconv.py:195-203`` there). Here it is ``ConvTranspose2d``'s
  ``(Ci, Co, 2, 2)`` weight, the flip done once by the converter
  (``models/convert.py``).
* ``dtype`` is the compute dtype: the input and kernels are cast to it
  (bf16 under ``amp``), parameters stay f32, the head's bias is added in
  that dtype and the output comes back in f32 (float64 in a float64 run).
* The JAX module's phase-space lowering (``phase_max_chans``) relowers the
  same kernels for the TPU's matrix unit and is the same function up to
  the order of sums; this module is the plain conv / avg-pool /
  transpose-conv form, whatever ``phase_max_chans`` a caller names.

Module names follow the Flax tree: ``conv_blocks.{i}`` is ``ConvBlock_{i}``
(numbered in call order: the encoder's, the bottleneck, then the decoder's),
``tconv_blocks.{i}`` is ``TransposeConvBlock_{i}``, ``head`` is ``Conv_0``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .norm import InstanceNorm
from .unet3d import he_normal_

LEAKY_SLOPE = 0.2


def reflect_pad_end(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """``jnp.pad(..., mode="reflect")`` of the last two axes by ``ph`` rows
    and ``pw`` columns at their ends; a pad longer than the axis reflects
    again off the padded tensor, as numpy does."""
    for dim, pad in ((-2, ph), (-1, pw)):
        while pad > 0:
            step = min(pad, x.shape[dim] - 1)
            if step <= 0:
                raise ValueError(f"cannot reflect-pad an axis of size "
                                 f"{x.shape[dim]}")
            pads = (0, step, 0, 0) if dim == -1 else (0, 0, 0, step)
            x = F.pad(x, pads, mode="reflect")
            pad -= step
    return x


class ConvBlock(nn.Module):
    """2 x (conv3x3 without bias -> InstanceNorm -> LeakyReLU(0.2) ->
    dropout)."""

    def __init__(self, cin: int, features: int, drop_prob: float = 0.0):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(cin if i == 0 else features, features, 3, padding=1,
                      bias=False) for i in range(2)])
        self.norms = nn.ModuleList([InstanceNorm(features) for _ in range(2)])
        self.drop_prob = float(drop_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = F.conv2d(x, conv.weight.to(x.dtype), None, padding=1)
            x = F.leaky_relu(norm(x), LEAKY_SLOPE)
            if self.drop_prob > 0:
                x = F.dropout(x, self.drop_prob, self.training)
        return x


class TransposeConvBlock(nn.Module):
    """Kernel-2 stride-2 transpose conv without bias -> InstanceNorm ->
    LeakyReLU(0.2)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.tconv = nn.ConvTranspose2d(cin, features, 2, stride=2,
                                        bias=False)
        self.norm = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv_transpose2d(x, self.tconv.weight.to(x.dtype), None,
                               stride=2)
        return F.leaky_relu(self.norm(x), LEAKY_SLOPE)


class FastMRIUnet(nn.Module):
    """NCHW ``(B, in_chans, H, W)`` in, f32 ``(B, out_chans, H, W)`` out;
    ``num_pool_layers`` levels, the width doubling from ``chans``."""

    def __init__(self, in_chans: int = 1, out_chans: int = 1,
                 chans: int = 32, num_pool_layers: int = 4,
                 drop_prob: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_pool_layers = int(num_pool_layers)
        self.dtype = dtype
        blocks, cin, ch = [], in_chans, chans
        for _ in range(num_pool_layers):
            blocks.append(ConvBlock(cin, ch, drop_prob))
            cin, ch = ch, ch * 2
        blocks.append(ConvBlock(cin, ch, drop_prob))     # the bottleneck
        tblocks = []
        for _ in range(num_pool_layers):
            tblocks.append(TransposeConvBlock(ch, ch // 2))
            blocks.append(ConvBlock(ch, ch // 2, drop_prob))
            ch //= 2
        self.conv_blocks = nn.ModuleList(blocks)
        self.tconv_blocks = nn.ModuleList(tblocks)
        self.head = nn.Conv2d(ch, out_chans, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        h, w = x.shape[-2:]
        mult = 2 ** self.num_pool_layers
        ph, pw = (-h) % mult, (-w) % mult
        if ph or pw:
            x = reflect_pad_end(x, ph, pw)
        n = self.num_pool_layers
        skips = []
        for block in self.conv_blocks[:n]:
            x = block(x)
            skips.append(x)
            x = F.avg_pool2d(x, 2)
        x = self.conv_blocks[n](x)
        for tblock, block, skip in zip(self.tconv_blocks,
                                       self.conv_blocks[n + 1:],
                                       reversed(skips)):
            x = block(torch.cat([tblock(x), skip], dim=1))
        x = F.conv2d(x, self.head.weight.to(x.dtype), None)
        x = x + self.head.bias.to(x.dtype).view(1, -1, 1, 1)
        if ph or pw:
            x = x[..., :h, :w]
        return x.to(torch.promote_types(x.dtype, torch.float32))


def init_fastmri_weights(model: nn.Module, generator: torch.Generator
                         ) -> nn.Module:
    """Seeded Flax init of every fastMRI U-Net inside ``model``: He-normal
    kernels (fan-in, truncated at 2 std; a transpose conv's fan-in is
    ``Ci * 4``, as Flax counts it on its ``(2, 2, Ci, Co)`` kernel), zero
    biases, norm scale 1 and bias 0. The generator lives on the CPU."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
                else:
                    fan_in = m.weight[0].numel()
                he_normal_(m.weight, fan_in, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, InstanceNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model
