"""ConvNeXt classifier over NCHW, the JAX package's Flax module.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/models/convnext.py``:
``ConvNeXtBlock`` (:31-50), ``ConvNeXt`` (:53-84) and ``ConvNext_model``
(:87-94), torchvision's ``convnext_tiny`` / ``convnext_base`` with a 1- or
2-channel stem and one logit. Stem conv 4x4 stride 4 + LayerNorm; four
stages of ConvNeXt blocks (depthwise 7x7 -> LayerNorm -> Linear 4x ->
GELU -> Linear -> layer scale, plus the residual), a LayerNorm and a 2x2
stride-2 conv ahead of stages 1-3; global average pool, LayerNorm, Linear.
The model takes NCHW; each block moves to channels-last for its LayerNorm
and MLP, as torchvision's block does.

What the Flax module computes, and this one with it:

* GELU is the tanh form (Flax's ``nn.gelu`` is ``approximate=True``);
  torch's default erf form would be another model.
* Flax ``nn.Conv`` pads ``"SAME"``: the stem and the downsamples get
  ``total = max((ceil(n / s) - 1) * s + k - n, 0)`` zeros, ``total // 2``
  low and the rest high, which is none at sizes that are multiples of 32
  and asymmetric for an odd total (a 50x70 input pads its 13-row stage
  (0, 1)). Serving takes any size, so :func:`_pad_same` pads explicitly.
* LayerNorm has epsilon 1e-6 and takes its statistics on the f32 upcast
  (``F.layer_norm``, two-pass; Flax's variance is ``E[x^2] - E[x]^2``, the
  same up to f32 rounding).
* ``dtype`` is the compute dtype (bf16 under ``amp``): parameters stay
  f32; convs and Linears cast input and weights to it; a LayerNorm returns
  it; ``gamma * y`` promotes to f32, so every block returns f32 (bf16 +
  f32); the pool is f32 and the head's LayerNorm and Linear run in
  ``dtype``; the logits come back f32. Each dtype is placed op by op as
  Flax places it (``torch.autocast``'s lists place LayerNorm's output in
  f32). With ``dtype=float64`` (parameters cast too) every f32 place is
  float64: the reference run of the checks.

Module names: ``stem``, ``stem_norm``; ``downsample.{s-1}.norm`` /
``.conv`` ahead of stage ``s``; ``stages.{s}.{j}`` blocks (``dwconv``,
``norm``, ``pwconv1``, ``pwconv2``, ``gamma``); ``head_norm``, ``head``.
``models/convert.py:state_dict_from_flax_convnext`` carries the Flax tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

CONFIGS = {
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "convnext": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
}
LN_EPS = 1e-6
INIT_STD = 0.02
LAYER_SCALE_INIT = 1e-6


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _pad_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Zero-pad the last two axes of ``x`` as Flax's ``padding="SAME"``
    pads a ``k`` x ``k`` stride-``s`` conv: ``total // 2`` low, the rest
    high."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the statistics, the residual stream and the pool: f32
    for bf16 and f32, float64 for a float64 run."""
    return torch.promote_types(dtype, torch.float32)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=dtype)`` over the last axis: statistics and
    affine on the upcast, the result in ``dtype``."""
    acc = _acc(dtype)
    return F.layer_norm(x.to(acc), norm.normalized_shape,
                        norm.weight.to(acc), norm.bias.to(acc),
                        norm.eps).to(dtype)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
          padding: int = 0) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype),
                    conv.bias.to(dtype), conv.stride, padding, 1,
                    conv.groups)


def _linear(lin: nn.Linear, x: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7 -> (channels-last) LayerNorm -> Linear(4 dim) ->
    GELU -> Linear(dim) -> ``gamma`` scale, plus the residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = _conv(self.dwconv, x, dtype, padding=3).permute(0, 2, 3, 1)
        y = _layer_norm(self.norm, y, dtype)
        y = _linear(self.pwconv2, _gelu(_linear(self.pwconv1, y, dtype)),
                    dtype)
        # the f32 layer scale promotes the branch, and with it the block's
        # output, to f32
        y = self.gamma.to(_acc(dtype)) * y.to(_acc(dtype))
        return x.to(_acc(dtype)) + y.permute(0, 3, 1, 2)


class _Downsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = nn.LayerNorm(cin, eps=LN_EPS)
        self.conv = nn.Conv2d(cin, cout, 2, stride=2)


class ConvNeXt(nn.Module):
    """ConvNeXt backbone with a ``num_classes``-logit head; ``forward``
    takes ``(N, in_chans, H, W)`` at any H, W and returns f32 ``(N,
    num_classes)`` logits."""

    def __init__(self, variant: str = "tiny", in_chans: int = 1,
                 num_classes: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant not in CONFIGS:
            raise ValueError(f"unknown ConvNeXt variant {variant!r} "
                             f"(one of {sorted(CONFIGS)})")
        cfg = CONFIGS[variant]
        depths: Sequence[int] = cfg["depths"]
        dims: Sequence[int] = cfg["dims"]
        self.variant, self.in_chans, self.dtype = variant, in_chans, dtype
        self.stem = nn.Conv2d(in_chans, dims[0], 4, stride=4)
        self.stem_norm = nn.LayerNorm(dims[0], eps=LN_EPS)
        self.downsample = nn.ModuleList([
            _Downsample(dims[s - 1], dims[s]) for s in range(1, 4)])
        self.stages = nn.ModuleList([
            nn.ModuleList([ConvNeXtBlock(dims[s]) for _ in range(depths[s])])
            for s in range(4)])
        self.head_norm = nn.LayerNorm(dims[3], eps=LN_EPS)
        self.head = nn.Linear(dims[3], num_classes)

    @staticmethod
    def _norm_nchw(norm: nn.LayerNorm, x: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
        return _layer_norm(norm, x.permute(0, 2, 3, 1), dtype
                           ).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = _conv(self.stem, _pad_same(x.to(dt), 4, 4), dt)
        x = self._norm_nchw(self.stem_norm, x, dt)
        for s, blocks in enumerate(self.stages):
            if s > 0:
                down = self.downsample[s - 1]
                x = self._norm_nchw(down.norm, x, dt)
                x = _conv(down.conv, _pad_same(x, 2, 2), dt)
            for block in blocks:
                x = block(x, dt)
        x = x.to(_acc(dt)).mean(dim=(2, 3))         # global average pool
        x = _linear(self.head, _layer_norm(self.head_norm, x, dt), dt)
        return x.to(_acc(dt))


def init_convnext_weights(model: nn.Module, generator: torch.Generator
                          ) -> nn.Module:
    """Flax's init, seeded: conv and Linear kernels truncated normal at 2
    std with std 0.02 (``nn.initializers.truncated_normal(0.02)``), zero
    biases, LayerNorm scale 1 / bias 0, layer scales 1e-6. The generator
    lives on the CPU."""
    std = INIT_STD / 0.87962566103423978   # unit normal truncated to +-2
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, ConvNeXtBlock):
                m.gamma.fill_(LAYER_SCALE_INIT)
    return model


def ConvNext_model(args: dict, diff: bool = False) -> ConvNeXt:
    """The vendored factory surface: ``args['model_args']['model']`` in
    {"convnext", "tiny"}; ``diff=True`` gives a 2-channel stem."""
    name = args["model_args"]["model"]
    if name not in ("convnext", "tiny"):
        raise ValueError(
            "Wrong model selection. Accepted values are 'convnext' or 'tiny'.")
    return ConvNeXt(variant=name, in_chans=2 if diff else 1, num_classes=1)
