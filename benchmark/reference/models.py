"""Plain U-Net over a ResNet-34 encoder, as a function of a ``{name:
tensor}`` parameter dict.

The architecture is ``segmentation_models_pytorch``'s ``Unet`` with
``encoder_name="resnet34"``, ``decoder_channels=(256, 128, 64, 32, 16)``,
one input channel and one class, as the port's
``mri_acl_imagesegmentation_adsp_tpu_torch/models/unet2d.py`` (commit
090937a) builds it: 3x3 convolutions padded by 1 (the stride-2 ones
too), no conv bias before a BatchNorm, nearest 2x upsampling, and a 3x3
head with a bias. The parameter names are that module's ``state_dict``
keys, so the benchmark hands the same tensors to both sides by name.

Only ``torch`` operations: float32 in, float32 out, BatchNorm from the
batch's statistics in train mode (``F.batch_norm``, biased variance) and
from the given running statistics in eval mode; ``capture`` keeps each
train-mode BatchNorm's batch variance by name. ``quant`` (the control,
not the reference) computes every convolution as an fp8 training recipe
would, the step a lower-precision path would take: its input and weight
rounded to e4m3 and, in the backward pass, the gradient of its output to
e5m2, each under a per-tensor scale. ``checkpoint`` recomputes each block in
the backward pass, so that the float32 step fits beside what is left on
the card; it changes no value.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _ckpt

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))   # ResNet-34
DECODER = (256, 128, 64, 32, 16)
BN_EPS = 1e-5
FP8_MAX = 448.0          # largest finite e4m3
FP8_E5M2_MAX = 57344.0   # largest finite e5m2

Params = Dict[str, torch.Tensor]


@contextmanager
def float32_exact() -> Iterator[None]:
    """float32 convolutions and matmuls inside the block, not TF32 (the
    card's default for convolutions); the flags are put back after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _block_specs() -> List[Tuple[int, int, int]]:
    """``(cin, width, stride)`` of each residual block."""
    specs, cin = [], 64
    for stage, (n, width) in enumerate(STAGES):
        for b in range(n):
            specs.append((cin, width, 2 if stage > 0 and b == 0 else 1))
            cin = width
    return specs


def _stage_ends() -> List[int]:
    ends, total = [], 0
    for n, _ in STAGES:
        total += n
        ends.append(total)
    return ends


def _conv_bn(name: str, cout: int, cin: int, k: int) -> list:
    return [(f"{name}.weight", (cout, cin, k, k))]


def _bn(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,)), (f"{name}.bias", (c,))]


def _conv_block(pre: str, cin: int, out: int) -> list:
    return (_conv_bn(pre + "conv0", out, cin, 3) + _bn(pre + "bn0", out)
            + _conv_bn(pre + "conv1", out, out, 3) + _bn(pre + "bn1", out))


def param_shapes(model: str) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter's name and shape, in the port's order."""
    out = (_conv_bn("encoder.stem_conv", 64, 1, 7)
           + _bn("encoder.stem_bn", 64))
    for i, (cin, width, stride) in enumerate(_block_specs()):
        pre = f"encoder.blocks.{i}."
        out += (_conv_bn(pre + "conv0", width, cin, 3) + _bn(pre + "bn0",
                                                             width)
                + _conv_bn(pre + "conv1", width, width, 3)
                + _bn(pre + "bn1", width))
        if cin != width or stride != 1:
            out += (_conv_bn(pre + "down_conv", width, cin, 1)
                    + _bn(pre + "down_bn", width))
    if model == "unet":
        cin = 512
        for j, (feat, skip) in enumerate(zip(DECODER, (256, 128, 64, 64,
                                                        0))):
            out += _conv_block(f"decoder.{j}.", cin + skip, feat)
            cin = feat
    else:
        raise ValueError(f"unknown model {model!r}")
    return out + [("head.weight", (1, cin, 3, 3)), ("head.bias", (1,))]


def bn_names(model: str) -> List[Tuple[str, int]]:
    """``(name, channels)`` of every BatchNorm (its running statistics)."""
    return [(n[:-len(".weight")], s[0]) for n, s in param_shapes(model)
            if len(s) == 1 and n.endswith(".weight") and n != "head.weight"]


def _fp8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to ``top``."""
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 (per-tensor scale), gradients passed
    straight through."""
    return t + (_fp8(t.detach(), torch.float8_e4m3fn, FP8_MAX) - t.detach())


class Fp8Grad(torch.autograd.Function):
    """Identity forward; the gradient arriving in the backward pass rounded
    to fp8 e5m2 (per-tensor scale), as an fp8 GEMM takes it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, FP8_E5M2_MAX)


class Net:
    """One model's forward pass over a parameter dict ``P``; ``stats``
    maps each BatchNorm name to its running ``(mean, var)`` for eval
    mode."""

    def __init__(self, model: str, P: Params, train: bool,
                 stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
                 | None = None, quant: bool = False,
                 checkpoint: bool = False, capture: dict | None = None):
        if model != "unet":
            raise ValueError(f"unknown model {model!r}")
        self.model, self.P, self.train = model, P, train
        self.stats = stats or {}
        self.quant, self.ckpt = quant, checkpoint
        self.capture = capture

    # -- pieces ------------------------------------------------------------
    def conv(self, x, name, stride=1, pad=1):
        w = self.P[name + ".weight"]
        if self.quant:
            x, w = fp8_round(x), fp8_round(w)
        y = F.conv2d(x, w, self.P.get(name + ".bias"), stride, pad)
        return Fp8Grad.apply(y) if self.quant else y

    def bn(self, x, name):
        w, b = self.P[name + ".weight"], self.P[name + ".bias"]
        if self.train:
            if self.capture is not None:
                self.capture[name] = x.detach().double().var(
                    dim=(0, 2, 3), unbiased=False)
            return F.batch_norm(x, None, None, w, b, True, 0.0, BN_EPS)
        mean, var = self.stats[name]
        return F.batch_norm(x, mean, var, w, b, False, 0.0, BN_EPS)

    def conv_block(self, x, pre):
        x = F.relu(self.bn(self.conv(x, pre + "conv0"), pre + "bn0"))
        return F.relu(self.bn(self.conv(x, pre + "conv1"), pre + "bn1"))

    def run(self, fn: Callable, *args):
        if self.ckpt and torch.is_grad_enabled():
            return _ckpt(fn, *args, use_reentrant=False)
        return fn(*args)

    def res_block(self, y, i, cin, width, stride):
        pre = f"encoder.blocks.{i}."
        z = F.relu(self.bn(self.conv(y, pre + "conv0", stride), pre + "bn0"))
        z = self.bn(self.conv(z, pre + "conv1"), pre + "bn1")
        if cin != width or stride != 1:
            y = self.bn(self.conv(y, pre + "down_conv", stride, 0),
                        pre + "down_bn")
        return F.relu(z + y)

    # -- the models --------------------------------------------------------
    def encoder(self, x):
        y = F.relu(self.bn(self.conv(x, "encoder.stem_conv", 2, 3),
                           "encoder.stem_bn"))
        feats = [y]
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        ends = _stage_ends()
        for i, (cin, width, stride) in enumerate(_block_specs()):
            y = self.run(lambda t, i=i, c=cin, w=width, s=stride:
                         self.res_block(t, i, c, w, s), y)
            if i + 1 in ends:
                feats.append(y)
        return feats                 # f1 (/2) .. f5 (/32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)
        up = lambda t: F.interpolate(t, scale_factor=2.0,  # noqa: E731
                                     mode="nearest")
        y = feats[4]
        for j, skip in enumerate([feats[3], feats[2], feats[1], feats[0],
                                  None]):
            def dec(t, s=None, j=j):
                t = up(t)
                if s is not None:
                    t = torch.cat([t[:, :, :s.shape[2], :s.shape[3]], s],
                                  dim=1)
                return self.conv_block(t, f"decoder.{j}.")
            y = self.run(dec, y) if skip is None else self.run(dec, y, skip)
        return self.conv(y, "head")
