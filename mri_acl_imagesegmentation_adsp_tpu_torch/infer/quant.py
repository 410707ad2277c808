"""Post-training int8 quantization of the 2-D segmentation U-Nets.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/infer/quant.py``:
``_fold_conv_bn`` (:49), ``_quantize_kernel`` (:61), ``QuantConfig``
(:70), ``QuantizedUNet2D`` with ``from_model`` (:108-144), ``_fold``
(:146), ``_forward`` (:184-248), ``_decode_unetpp`` (:250), ``apply``
(:279-322) and ``apply_folded`` (:324), ``save_qtree`` / ``load_qtree``
(:342-362) and ``nn_max_pool`` (:364).

Pipeline, as there:

* fold: eval-mode BatchNorm is per-channel affine, ``a = weight *
  rsqrt(var + eps)``, ``b = bias - mean * a``; ``a`` scales the conv
  kernel's output channels and ``b`` becomes its bias;
* calibrate: the folded network runs on a few batches, recording the
  running absmax of every conv's input. The JAX package runs it in f32;
  here it runs in float64, so that the scales do not depend on the
  summation order of the device's f32 convolution: they agree with the
  JAX package's to ~1e-7 relative (its own f32 error), and an artifact
  made on the card is the one the CPU makes;
* quantize: per-output-channel symmetric int8 weights, ``s_w = absmax /
  127`` (floor 1e-12), ``w_q = clip(round(w / s_w), -127, 127)`` with
  round-half-to-even; at apply time ``x_q = clip(round(x / s_x), -127,
  127)`` (a true division) and the conv sums ``x_q * w_q`` exactly in
  int32, dequantized by ``s_x * s_w``.

The quantized tree is the JAX package's artifact: ``{conv path: {w_q,
w_scale, x_scale, bias}}`` keyed by the Flax module path (``enc/Conv_0``,
``enc/_BasicBlock_3/Conv_1``, ``_DecoderBlock_0/Conv_1``, ``Conv_0``),
``w_q`` an HWIO int8 kernel, so either package reads the other's
``save_qtree`` file. The port folds from its own ``state_dict`` and names
each conv through ``models/convert.py``'s Flax-to-torch map. The forward
runs NHWC as the JAX one does; the caller's batches stay NCHW.

The int8 convolution is im2col followed by ``torch._int_mm`` (cuBLAS's
int8 GEMM on the card, int32 accumulation), exact on both devices: at
ResNet34's first decoder conv K = 3*3*768 and one sum reaches 127^2 * 6912
~ 1.1e8, past f32's 2^24, so no float accumulation would be. It is a
library call, as XLA's int8 convolution is in the JAX package; there is
no TPU kernel here. Everything outside the convolutions (ReLU, residual
add, pool, nearest-up, concat, the cast after dequant and bias) runs in
the compute dtype, bf16 for an ``amp`` checkpoint.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import _module_path
from ..models.unet2d import RESNET_CFG, UNetPlusPlus
from ..utils.device import f32_on_card

Tree = Dict[str, Dict[str, Optional[torch.Tensor]]]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``, the artifact's spelling."""
    return str(dtype).removeprefix("torch.")


def _fold_conv_bn(w: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO kernel and bias with eval-mode BatchNorm folded in."""
    a = weight * torch.rsqrt(var + eps)
    return w * a, bias - mean * a


def _quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an HWIO kernel."""
    s = torch.clamp(w.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
    wq = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return wq, s.float()


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pad: int = 0) -> torch.Tensor:
    """Exact int32 convolution of NHWC int8 ``x`` with an HWIO int8 ``w``.

    im2col in (ky, kx, cin) order, which is the HWIO kernel's row order,
    then one ``torch._int_mm``. cuBLAS's int8 GEMM wants M > 16 and K, N
    multiples of 8, so the operands are zero-padded to that on every
    device (zero rows and columns add nothing to a sum)."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    cols = [x[:, dy:dy + stride * (ho - 1) + 1:stride,
              dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    a = torch.stack(cols, dim=3).reshape(n * ho * wo, kh * kw * c)
    b = w.reshape(kh * kw * c, o)
    m, k = a.shape
    mp, kp, op = max(m, 17), -(-k // 8) * 8, -(-o // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, op) != (k, o):
        b = F.pad(b, (0, op - o, 0, kp - k))
    acc = torch._int_mm(a.contiguous(), b.contiguous())
    return acc[:m, :o].reshape(n, ho, wo, o)


def _float_conv(y: torch.Tensor, w: torch.Tensor, stride: int,
                pad: int) -> torch.Tensor:
    """NHWC ``y`` * HWIO ``w`` in their (equal) float dtype, NHWC out."""
    out = F.conv2d(y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1)


def nn_max_pool(y: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool with (1, 1) padding of an NHWC tensor, integer or
    float. Integers pool in float32, which holds int8 exactly (and
    PyTorch has no integer max-pool on the card); a padded window always
    holds a real pixel, so the padding value never wins."""
    t = y.permute(0, 3, 1, 2)
    if not t.is_floating_point():
        return F.max_pool2d(t.float(), 3, 2, 1).to(y.dtype).permute(
            0, 2, 3, 1)
    return F.max_pool2d(t, 3, 2, 1).permute(0, 2, 3, 1)


def _up2(t: torch.Tensor) -> torch.Tensor:
    return t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


@dataclass(frozen=True)
class QuantConfig:
    """``mode``: ``"int8"`` (int8 weights and activations, int32 sums) or
    ``"folded"`` (BN-folded convs in the compute dtype, from a folded tree
    or an int8 tree's dequantized weights)."""
    mode: str = "int8"
    compute_dtype: torch.dtype = torch.bfloat16


def _flax_module(path: str) -> tuple:
    """``enc/_BasicBlock_3/Conv_1`` -> the Flax module path tuple."""
    parts = path.split("/")
    return tuple("ResNetEncoder_0" if p == "enc" else p for p in parts)


class QuantizedUNet2D:
    """BN-folded, int8-quantized evaluator of ``ResNetEncoderUNet`` and
    ``UNetPlusPlus``. Build it with :meth:`from_model`; ``apply(qtree,
    x)`` maps an NCHW batch to f32 NCHW logits, as the model does."""

    def __init__(self, encoder: str, classes: int,
                 decoder_channels: Sequence[int],
                 config: QuantConfig = QuantConfig(), arch: str = "unet"):
        if arch not in ("unet", "unetpp"):
            raise ValueError(f"unsupported arch {arch!r}")
        if config.mode not in ("int8", "folded"):
            raise ValueError(f"unsupported mode {config.mode!r}")
        self.encoder = encoder
        self.classes = int(classes)
        self.decoder_channels = tuple(decoder_channels)
        self.config = config
        self.arch = arch

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    @classmethod
    def from_model(cls, model: torch.nn.Module, calib_batches: Sequence,
                   config: QuantConfig = QuantConfig()
                   ) -> Tuple["QuantizedUNet2D", Tree]:
        """Fold, calibrate and quantize ``model`` (its eval-mode BN stats).
        Returns ``(engine, qtree)`` on the model's device.

        ``calib_batches``: NCHW batches (arrays or tensors) of the
        normalized tensors inference sees; the activation scales are the
        running absmax over all of them."""
        arch = "unetpp" if isinstance(model, UNetPlusPlus) else "unet"
        eng = cls(model.encoder_name, model.classes, model.decoder_channels,
                  config, arch=arch)
        folded = eng.fold(model.state_dict())
        dev = next(model.parameters()).device
        folded64 = {p: {k: None if t is None else t.double()
                        for k, t in leaf.items()}
                    for p, leaf in folded.items()}
        scales: Dict[str, float] = {}

        def calib_conv(path, x, w, b, stride, pad):
            amax = float(x.abs().max())
            scales[path] = max(scales.get(path, 0.0), amax, 1e-12)
            y = _float_conv(x, w, stride, pad)
            return y if b is None else y + b

        with torch.inference_mode():
            for xb in calib_batches:
                x = torch.as_tensor(xb).to(dev, torch.float32).double()
                eng._forward(folded64, x.permute(0, 2, 3, 1), calib_conv)

        qtree: Tree = {}
        for path, leaf in folded.items():
            wq, ws = _quantize_kernel(leaf["w"])
            qtree[path] = {
                "w_q": wq, "w_scale": ws,
                "x_scale": torch.tensor(np.float32(scales[path] / 127.0),
                                        device=dev),
                "bias": leaf["b"]}
        return eng, qtree

    def _conv_paths(self) -> List[str]:
        """Every conv of the architecture, by its Flax path."""
        blocks, bottleneck = RESNET_CFG[self.encoder]
        kind = "_Bottleneck_" if bottleneck else "_BasicBlock_"
        per_block = 4 if bottleneck else 3       # the last is the downsample
        paths = ["enc/Conv_0"]
        paths += [f"enc/{kind}{g}/Conv_{i}" for g in range(sum(blocks))
                  for i in range(per_block)]
        if self.arch == "unetpp":
            n = 2 * len(UNetPlusPlus.node_order()) + 3   # + tail + head
            return paths + [f"Conv_{i}" for i in range(n)]
        n_dec = min(len(self.decoder_channels), 5)
        paths += [f"_DecoderBlock_{d}/Conv_{i}" for d in range(n_dec)
                  for i in range(2)]
        return paths + ["Conv_0"]

    def fold(self, state_dict: Dict[str, torch.Tensor]) -> Tree:
        """``{conv path: {w (HWIO), b}}`` with BN folded in; the head conv
        keeps its own bias. A block without a downsample has no such
        conv."""
        unetpp = self.arch == "unetpp"
        out: Tree = {}
        for path in self._conv_paths():
            mod = _flax_module(path)
            prefix = _module_path(mod, unetpp)
            if f"{prefix}.weight" not in state_dict:
                continue
            w = state_dict[f"{prefix}.weight"].float().permute(2, 3, 1, 0)
            try:
                bn = _module_path(mod[:-1] + (re.sub(
                    "^Conv_", "BatchNorm_", mod[-1]),), unetpp)
            except KeyError:
                bn = None
            if bn is not None and f"{bn}.running_mean" in state_dict:
                w, b = _fold_conv_bn(
                    w, state_dict[f"{bn}.weight"].float(),
                    state_dict[f"{bn}.bias"].float(),
                    state_dict[f"{bn}.running_mean"].float(),
                    state_dict[f"{bn}.running_var"].float())
            else:                               # the head: own bias, no BN
                b = state_dict.get(f"{prefix}.bias")
                b = None if b is None else b.float()
            out[path] = {"w": w.contiguous(), "b": b}
        return out

    # ------------------------------------------------------------------
    # Forward (shared by calibration and quantized inference)
    # ------------------------------------------------------------------

    def _forward(self, tree: Tree, x: torch.Tensor,
                 conv: Callable) -> torch.Tensor:
        """The plain dataflow of the source model over a flat conv tree,
        NHWC. ``conv(path, y, leaf_or_w, b, stride, pad)`` runs one
        convolution and its bias; everything else runs here in ``y``'s
        dtype."""
        blocks, bottleneck = RESNET_CFG[self.encoder]

        def cbr(prefix, i, y, stride=1, pad=None, relu=True):
            path = f"{prefix}Conv_{i}"
            leaf = tree[path]
            w = leaf["w"] if "w" in leaf else leaf
            k = (w["w_q"] if isinstance(w, dict) else w).shape[0]
            y = conv(path, y, w, leaf.get("b"), stride,
                     k // 2 if pad is None else pad)
            return torch.relu(y) if relu else y

        feats = [x]
        y = cbr("enc/", 0, x, stride=2, pad=3)
        feats.append(y)                                          # /2
        y = nn_max_pool(y)
        bi = 0
        kind = "_Bottleneck_" if bottleneck else "_BasicBlock_"
        for stage, n_blocks in enumerate(blocks):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                p = f"enc/{kind}{bi}/"
                residual = y
                if bottleneck:
                    y = cbr(p, 0, y)
                    y = cbr(p, 1, y, stride=stride, pad=1)
                    y = cbr(p, 2, y, relu=False)
                    ds = 3
                else:
                    y = cbr(p, 0, y, stride=stride, pad=1)
                    y = cbr(p, 1, y, relu=False)
                    ds = 2
                if f"{p}Conv_{ds}" in tree:
                    residual = cbr(p, ds, residual, stride=stride,
                                   relu=False)
                y = torch.relu(y + residual)
                bi += 1
            feats.append(y)                                      # /4.../32
        if self.arch == "unetpp":
            return self._decode_unetpp(feats, cbr)
        skips = [feats[4], feats[3], feats[2], feats[1], None]
        y = feats[5]
        for d, skip in enumerate(skips[:len(self.decoder_channels)]):
            y = _up2(y)
            if skip is not None:
                y = torch.cat([y[:, :skip.shape[1], :skip.shape[2]], skip],
                              dim=-1)
            p = f"_DecoderBlock_{d}/"
            y = cbr(p, 0, y)
            y = cbr(p, 1, y)
        return cbr("", 0, y, relu=False).float()

    def _decode_unetpp(self, feats: List[torch.Tensor],
                       cbr: Callable) -> torch.Tensor:
        """The nested dense-skip decoder; conv indices in Flax's call
        order."""
        enc = feats[1:6]
        depth = len(enc) - 1
        ci = 0
        grid = {(i, 0): enc[i] for i in range(depth + 1)}
        for j in range(1, depth + 1):
            for i in range(depth + 1 - j):
                priors = [grid[(i, k)] for k in range(j)]
                y = torch.cat(priors + [_up2(grid[(i + 1, j - 1)])], dim=-1)
                y = cbr("", ci, y)
                y = cbr("", ci + 1, y)
                ci += 2
                grid[(i, j)] = y
        y = _up2(grid[(0, depth)])
        y = cbr("", ci, y)
        y = cbr("", ci + 1, y)
        return cbr("", ci + 2, y, relu=False).float()

    # ------------------------------------------------------------------
    # Quantized apply
    # ------------------------------------------------------------------

    def apply(self, qtree: Tree, x: torch.Tensor) -> torch.Tensor:
        """Quantized (``int8``) or folded-precision (``folded``) logits of
        an NCHW batch. ``folded`` takes an int8 tree (its weights
        dequantized) or a :meth:`fold` tree; ``int8`` refuses a tree
        without scales, and never runs the folded path in its place."""
        cdt = self.config.compute_dtype
        int8_mode = self.config.mode == "int8"

        def qconv(path, y, leaf, b, stride, pad):
            is_qleaf = isinstance(leaf, dict)
            if int8_mode:
                if not is_qleaf:
                    raise TypeError(
                        f"int8 apply needs a quantized tree (leaf at "
                        f"{path!r} has no scales); run from_model() or use "
                        f"mode='folded'")
                yq = torch.clamp(torch.round(y.float() / leaf["x_scale"]),
                                 -127, 127).to(torch.int8)
                acc = int8_conv(yq, leaf["w_q"], stride, pad)
                out = acc.float() * (leaf["x_scale"] * leaf["w_scale"])
                bias = leaf.get("bias")
            else:
                if is_qleaf:
                    w = leaf["w_q"].float() * leaf["w_scale"]
                    bias = leaf.get("bias")
                else:
                    w, bias = leaf, b
                out = _float_conv(y.to(cdt), w.to(cdt), stride, pad)
            if bias is not None:
                out = out + bias.to(out.dtype)
            return out.to(cdt)

        with torch.inference_mode(), f32_on_card(x.device):
            logits = self._forward(qtree, x.to(cdt).permute(0, 2, 3, 1),
                                   qconv)
        return logits.permute(0, 3, 1, 2)

    def apply_folded(self, folded: Tree, x: torch.Tensor) -> torch.Tensor:
        """Full-precision forward over a :meth:`fold` tree in the compute
        dtype: the fold-exactness oracle."""
        cdt = self.config.compute_dtype

        def fconv(path, y, w, b, stride, pad):
            out = _float_conv(y.to(cdt), w.to(cdt), stride, pad)
            return out if b is None else out + b.to(out.dtype)

        with torch.inference_mode(), f32_on_card(x.device):
            logits = self._forward(folded, x.to(cdt).permute(0, 2, 3, 1),
                                   fconv)
        return logits.permute(0, 3, 1, 2)


def save_qtree(path: str, qtree: Tree) -> None:
    """One ``.npz`` of ``<conv path>::<leaf>`` arrays: HWIO int8 kernels,
    f32 scales and biases (``np.savez_compressed`` appends ``.npz``)."""
    flat = {f"{cpath}::{k}": v.detach().cpu().numpy()
            for cpath, leaf in qtree.items()
            for k, v in leaf.items() if v is not None}
    np.savez_compressed(path, **flat)


def load_qtree(path: str, device: str | torch.device = "cpu") -> Tree:
    """The tree of a :func:`save_qtree` file (of either package) on
    ``device``; a conv without a stored bias gets ``None``."""
    out: Tree = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            cpath, k = key.rsplit("::", 1)
            out.setdefault(cpath, {})[k] = torch.from_numpy(
                np.array(z[key])).to(device)
    for leaf in out.values():
        leaf.setdefault("bias", None)
    return out
