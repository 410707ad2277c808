"""A torch ResNet checkpoint -> the port's ``ResNetEncoder``.

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/models/torch_import.py``
(:49-210): ``load_torch_checkpoint``, ``convert_resnet_encoder`` and
``apply_encoder_weights``, the local-file stand-in for smp's
``encoder_weights="imagenet"`` (a download, which ``models/factory.py``
refuses). A torchvision-layout ResNet18/34/50 ``state_dict``, bare or in a
``{"state_dict" | "model" | "model_state": ...}`` wrapper, with or without
the ``module.`` (DataParallel) and ``encoder.`` (smp) key prefixes, maps
onto the encoder:

  conv1.weight                  -> stem_conv.weight
  bn1.{weight,bias,running_*}   -> stem_bn.*
  layer{s}.{b}.conv{i} / bn{i}  -> blocks.{g}.conv{i-1} / bn{i-1}
  layer{s}.{b}.downsample.0/.1  -> blocks.{g}.down_conv / down_bn

where ``g`` counts the residual blocks across stages. A checkpoint stem
with more input channels than the model's (a 3-channel ImageNet ResNet
into a 1-channel MRI model) is summed over its input channels, which is
``conv(replicate(x), W) == conv(x, sum_c W)``; for a model stem of
``k > 1`` channels the sum is spread evenly over them.

The file is read with ``torch.load(weights_only=True)``: tensors and plain
containers only. A file that holds a pickled object (a whole
``nn.Module``, anything with code) is refused, unlike the JAX package's
loader, which unpickles arbitrary objects.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping

import torch
from torch import nn

from .unet2d import RESNET_CFG


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors by name, unwrapped and with the ``module.``
    and ``encoder.`` prefixes stripped; non-tensor entries are dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "model_state"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict):
        raise ValueError(f"{path} holds a {type(obj).__name__}, not a "
                         "state_dict")
    out: Dict[str, torch.Tensor] = {}
    for name, value in obj.items():
        if not isinstance(value, torch.Tensor):
            continue
        for prefix in ("module.", "encoder."):
            if name.startswith(prefix):
                name = name[len(prefix):]
        out[name] = value.detach()
    return out


def _stem(w: torch.Tensor, stem_in_ch: int | None) -> torch.Tensor:
    """The checkpoint's (O, I, 7, 7) stem for a model stem of
    ``stem_in_ch`` input channels: summed over I in channel order (the
    order numpy sums them in the JAX package's converter), then spread
    over the model's channels."""
    if stem_in_ch is None or w.shape[1] == stem_in_ch:
        return w
    if stem_in_ch > w.shape[1]:
        raise ValueError(f"cannot widen a {w.shape[1]}-channel checkpoint "
                         f"stem to {stem_in_ch} input channels")
    total = functools.reduce(torch.add, [w[:, i:i + 1]
                                         for i in range(w.shape[1])])
    if stem_in_ch > 1:
        total = (total / stem_in_ch).repeat(1, stem_in_ch, 1, 1)
    return total


def convert_resnet_encoder(sd: Mapping[str, torch.Tensor], encoder: str,
                           stem_in_ch: int | None = None
                           ) -> Dict[str, torch.Tensor]:
    """The ``ResNetEncoder`` state_dict (its own keys, float32) of a
    torchvision-layout ``sd``. ``stem_in_ch``: the model's stem input
    channels (None keeps the checkpoint's)."""
    if encoder not in RESNET_CFG:
        raise ValueError(f"unsupported encoder {encoder!r}; torch import "
                         f"supports {sorted(RESNET_CFG)}")
    missing = [k for k in ("conv1.weight", "bn1.weight") if k not in sd]
    if missing:
        raise ValueError(f"checkpoint lacks torchvision ResNet keys "
                         f"{missing}; got e.g. {sorted(sd)[:5]}")
    blocks, bottleneck = RESNET_CFG[encoder]
    n_convs = 3 if bottleneck else 2
    pairs = {"conv1": "stem_conv", "bn1": "stem_bn"}
    g = 0
    for stage, n_blocks in enumerate(blocks, start=1):
        for b in range(n_blocks):
            src, dst = f"layer{stage}.{b}", f"blocks.{g}"
            for i in range(n_convs):
                pairs[f"{src}.conv{i + 1}"] = f"{dst}.conv{i}"
                pairs[f"{src}.bn{i + 1}"] = f"{dst}.bn{i}"
            if f"{src}.downsample.0.weight" in sd:
                pairs[f"{src}.downsample.0"] = f"{dst}.down_conv"
                pairs[f"{src}.downsample.1"] = f"{dst}.down_bn"
            g += 1
    out: Dict[str, torch.Tensor] = {}
    for src, dst in pairs.items():
        leaves = (("weight",) if "conv" in dst else
                  ("weight", "bias", "running_mean", "running_var"))
        for leaf in leaves:
            key = f"{src}.{leaf}"
            if key not in sd:
                raise ValueError(f"checkpoint lacks {key} for {encoder}")
            out[f"{dst}.{leaf}"] = sd[key].float()
    out["stem_conv.weight"] = _stem(out["stem_conv.weight"], stem_in_ch)
    return out


def apply_encoder_weights(model: nn.Module, path: str,
                          encoder: str) -> nn.Module:
    """Load the checkpoint at ``path`` into ``model.encoder`` (every
    weight and BN statistic; its BN step counters stay); the decoder and
    head keep their values. Any key or shape that does not line up
    raises ``ValueError`` naming it."""
    enc = getattr(model, "encoder", None)
    if not isinstance(enc, nn.Module) or not hasattr(enc, "stem_conv"):
        raise ValueError("torch import targets the ResNet-encoder U-Net "
                         "family (a model with a ResNetEncoder .encoder)")
    new = convert_resnet_encoder(load_torch_checkpoint(path), encoder,
                                 stem_in_ch=enc.stem_conv.in_channels)
    own = {k: v for k, v in enc.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    if set(own) != set(new):
        raise ValueError(
            f"encoder import structure mismatch: model lacks "
            f"{sorted(set(new) - set(own))[:5]}, checkpoint lacks "
            f"{sorted(set(own) - set(new))[:5]}")
    for key, t in own.items():
        if tuple(new[key].shape) != tuple(t.shape):
            raise ValueError(f"encoder import shape mismatch at {key}: "
                             f"model {tuple(t.shape)}, checkpoint "
                             f"{tuple(new[key].shape)}")
    enc.load_state_dict(new, strict=False)
    return model
