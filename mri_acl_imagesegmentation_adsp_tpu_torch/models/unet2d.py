"""2-D segmentation U-Net with a ResNet encoder (NCHW).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/models/unet2d.py``:
``_BasicBlock`` (:43-71), ``_Bottleneck`` (:74-103), ``ResNetEncoder``
(:106-157), ``_DecoderBlock`` in its plain form (:213-226) and
``ResNetEncoderUNet`` (:305-356) and ``UNetPlusPlus`` in its plain form
(``fused_decoder=False``, :360-466). The JAX decoders' phase-space lowering
(``models/phaseconv.py``) is a TPU device equal in f32 to the plain form,
so only the plain form is here.

Module names follow the JAX parameter tree (``blocks`` counts the residual
blocks across stages, as ``_BasicBlock_{g}`` does), so
``models/convert.py`` is a renaming. BatchNorm is ``models/norm.py``'s,
whose train mode takes the reference's biased one-pass batch variance and
running-stat update (``nn.BatchNorm2d`` folds the unbiased variance into
``running_var``); its state_dict keys are ``nn.BatchNorm2d``'s.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .norm import BatchNorm2d

# ResNet stage definitions: name -> (blocks per stage, bottleneck?)
RESNET_CFG = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
}
_STAGE_WIDTHS = (64, 128, 256, 512)


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          bias: bool = False) -> nn.Conv2d:
    # padding k//2 on both sides: the (1, 1) padding the reference keeps
    # explicit on stride-2 3x3 convs (unet2d.py:54-60), "SAME" elsewhere
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv0 = _conv(cin, width, 3, stride)
        self.bn0 = _bn(width)
        self.conv1 = _conv(width, width, 3)
        self.bn1 = _bn(width)
        self.down_conv = self.down_bn = None
        if cin != width or stride != 1:
            self.down_conv = _conv(cin, width, 1, stride)
            self.down_bn = _bn(width)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        res = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + res)


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        out = width * 4
        self.conv0 = _conv(cin, width, 1)
        self.bn0 = _bn(width)
        self.conv1 = _conv(width, width, 3, stride)
        self.bn1 = _bn(width)
        self.conv2 = _conv(width, out, 1)
        self.bn2 = _bn(out)
        self.down_conv = self.down_bn = None
        if cin != out or stride != 1:
            self.down_conv = _conv(cin, out, 1, stride)
            self.down_bn = _bn(out)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        res = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + res)


class ResNetEncoder(nn.Module):
    """ResNet-18/34/50 feature extractor returning
    ``[x, f1 (/2), f2 (/4), f3 (/8), f4 (/16), f5 (/32)]``."""

    def __init__(self, name: str = "resnet34", in_ch: int = 1):
        super().__init__()
        if name not in RESNET_CFG:
            raise ValueError(f"unsupported encoder {name!r}; "
                             f"one of {sorted(RESNET_CFG)}")
        n_blocks, bottleneck = RESNET_CFG[name]
        block_cls = _Bottleneck if bottleneck else _BasicBlock
        self.stem_conv = nn.Conv2d(in_ch, 64, 7, stride=2, padding=3,
                                   bias=False)
        self.stem_bn = _bn(64)
        self.stage_ends: List[int] = []
        blocks = []
        cin = 64
        for stage, (n, width) in enumerate(zip(n_blocks, _STAGE_WIDTHS)):
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(block_cls(cin, width, stride))
                cin = width * block_cls.expansion
            self.stage_ends.append(len(blocks))
        self.blocks = nn.ModuleList(blocks)
        self.channels = [in_ch, 64] + [w * block_cls.expansion
                                       for w in _STAGE_WIDTHS]

    def forward(self, x) -> List[torch.Tensor]:
        feats = [x]
        y = F.relu(self.stem_bn(self.stem_conv(x)))
        feats.append(y)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for i, block in enumerate(self.blocks, start=1):
            y = block(y)
            if i in self.stage_ends:
                feats.append(y)
        return feats


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class _ConvBlock(nn.Module):
    """Twice conv3x3-BN-ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = _conv(cin, features, 3)
        self.bn0 = _bn(features)
        self.conv1 = _conv(features, features, 3)
        self.bn1 = _bn(features)

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))


class _DecoderBlock(_ConvBlock):
    """Nearest 2x upsample, concat ``[up(x), skip]``, twice conv3x3-BN-ReLU."""

    def __init__(self, cin: int, cskip: int, features: int):
        super().__init__(cin + cskip, features)

    def forward(self, x, skip: Optional[torch.Tensor]):
        x = _up2(x)
        if skip is not None:
            # crop an odd-size mismatch (inputs padded to /32 avoid this)
            x = x[:, :, :skip.shape[2], :skip.shape[3]]
            x = torch.cat([x, skip], dim=1)
        return super().forward(x)


class ResNetEncoderUNet(nn.Module):
    """smp.Unet-equivalent: ResNet encoder, U-Net decoder, conv3x3 head with
    bias. NCHW in, float32 logits ``(B, classes, H, W)`` out."""

    def __init__(self, encoder: str = "resnet34", in_ch: int = 1,
                 classes: int = 1,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.encoder = ResNetEncoder(encoder, in_ch)
        ch = self.encoder.channels
        # skips, deepest first, excluding the bottleneck f5: f4 f3 f2 f1 None
        skip_ch = [ch[4], ch[3], ch[2], ch[1], 0]
        self.n_blocks = min(len(decoder_channels), len(skip_ch))
        blocks = []
        cin = ch[5]
        for feat, cs in zip(decoder_channels, skip_ch):
            blocks.append(_DecoderBlock(cin, cs, feat))
            cin = feat
        self.decoder = nn.ModuleList(blocks)
        self.head = nn.Conv2d(cin, classes, 3, padding=1, bias=True)

    def forward(self, x):
        feats = self.encoder(x.float())
        skips = [feats[4], feats[3], feats[2], feats[1], None]
        y = feats[5]
        for block, skip in zip(self.decoder, skips):
            y = block(y, skip)
        return self.head(y).float()


class UNetPlusPlus(nn.Module):
    """smp.UnetPlusPlus-equivalent: the nested dense-skip decoder (Zhou et
    al. 2018) over the same ResNet encoder. NCHW in, float32 logits out.

    Node ``X[i][j]`` (``nodes["x_{i}_{j}"]``) sits at encoder level ``i``
    (``/2`` to ``/32``) and column ``j``: twice conv3x3-BN-ReLU over
    ``concat(X[i][0..j-1], up2(X[i+1][j-1]))`` with ``decoder_channels``'
    first four widths, shallow row last. The tail upsamples ``X[0][4]`` to
    full resolution, runs twice conv3x3-BN-ReLU at ``decoder_channels[-1]``
    and a conv3x3 head with bias. ``DEPTH`` columns, column by column, then
    the tail: the order in which the JAX module numbers its ``Conv_i`` and
    ``BatchNorm_i`` (``models/convert.py``)."""

    DEPTH = 4

    def __init__(self, encoder: str = "resnet34", in_ch: int = 1,
                 classes: int = 1,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.encoder = ResNetEncoder(encoder, in_ch)
        d = self.DEPTH
        row_ch = list(decoder_channels)[:d][::-1]     # shallow -> deep
        ch = {(i, 0): c for i, c in enumerate(self.encoder.channels[1:])}
        self.nodes = nn.ModuleDict()
        for j, i in self.node_order():
            cin = sum(ch[(i, m)] for m in range(j)) + ch[(i + 1, j - 1)]
            self.nodes[f"x_{i}_{j}"] = _ConvBlock(cin, row_ch[i])
            ch[(i, j)] = row_ch[i]
        tail = decoder_channels[-1]
        self.tail = _ConvBlock(ch[(0, d)], tail)
        self.head = nn.Conv2d(tail, classes, 3, padding=1, bias=True)

    @classmethod
    def node_order(cls):
        """``(j, i)`` of every node, column by column."""
        return [(j, i) for j in range(1, cls.DEPTH + 1)
                for i in range(cls.DEPTH + 1 - j)]

    def forward(self, x):
        feats = self.encoder(x.float())
        grid = {(i, 0): f for i, f in enumerate(feats[1:])}
        for j, i in self.node_order():
            priors = [grid[(i, m)] for m in range(j)]
            grid[(i, j)] = self.nodes[f"x_{i}_{j}"](
                torch.cat(priors + [_up2(grid[(i + 1, j - 1)])], dim=1))
        y = self.tail(_up2(grid[(0, self.DEPTH)]))
        return self.head(y).float()


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded He-normal (fan-in, truncated at 2 std) conv init, the JAX
    models' ``he_normal``; BatchNorm at scale 1 / bias 0 / identity stats and
    conv biases at 0. The generator must live on the CPU; the values are
    then copied to each parameter's device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # std of a unit normal truncated to [-2, 2] is 0.8796
                std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
