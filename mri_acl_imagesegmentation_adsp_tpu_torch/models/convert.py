"""Flax ``params`` / ``batch_stats`` trees of the JAX U-Net or UNet++ -> a
torch ``state_dict`` of :class:`~.unet2d.ResNetEncoderUNet` or
:class:`~.unet2d.UNetPlusPlus`.

The inverse of the layout map in
``mri_acl_imagesegmentation_adsp_tpu/models/torch_import.py:95``
(``convert_resnet_encoder``), extended to the decoders. The U-Net's are
``_DecoderBlock_{i}`` and a top-level ``Conv_0`` head. The UNet++ numbers
its top-level ``Conv_{i}`` and ``BatchNorm_{i}`` in the order it calls them
(``models/unet2d.py:395-416`` there): its nodes column by column, two convs
and two BatchNorms each, then the tail's two and the head; its fused and
plain lowerings share that tree. A tree with top-level BatchNorms is a
UNet++. Conv kernels go HWIO -> OIHW, and BatchNorm's
``scale / bias`` + ``mean / var`` become ``weight / bias`` +
``running_mean / running_var``; the stats carry over unchanged, and the
port's BatchNorm (``models/norm.py``) updates them as Flax's does.
Any leaf of either tree that maps nowhere, and any BatchNorm whose params
and stats do not pair up, raises.

``state_dict_from_flax_unet3d`` carries the 3-D ``ResidualUNet3D``'s
``params`` (it has no ``batch_stats``) to :class:`~.unet3d.ResidualUNet3D`:
kernels DHWIO -> OIDHW, ``ConvTranspose_{n}`` kernels ``(2, 2, 2, Ci, Co)``
flipped in space and laid out ``(Ci, Co, 2, 2, 2)``, ``GroupNorm_{j}``
``scale`` / ``bias`` to the InstanceNorm's ``weight`` / ``bias`` and
``PReLU_{j}`` ``negative_slope`` to its ``weight`` of shape ``(1,)``.

``state_dict_from_flax_fastmri_unet`` carries a ``FastMRIUnet``'s ``params``
to :class:`~.fastmri_unet.FastMRIUnet` (``ConvBlock_{i}`` ->
``conv_blocks.{i}``, ``TransposeConvBlock_{i}`` -> ``tconv_blocks.{i}``,
``Conv_0`` -> ``head``): kernels HWIO -> OIHW, each ``ConvTranspose_0``
kernel ``(2, 2, Ci, Co)`` flipped in space and laid out ``(Ci, Co, 2, 2)``
(Flax applies it flipped, ``ConvTranspose2d`` as it is), ``GroupNorm_{j}``
``scale`` / ``bias`` to the InstanceNorm's ``weight`` / ``bias``. Both the
plain and the phase-space lowering of the JAX module have this tree.
``state_dict_from_flax_varnet`` carries a ``VarNet``'s: its
``SensitivityModel_0/NormUnet_0/FastMRIUnet_0`` to ``sens_net.norm_unet.unet``,
each ``VarNetBlock_{i}``'s U-Net to ``cascades.{i}.norm_unet.unet`` and its
``dc_weight`` to ``cascades.{i}.dc_weight``. ``state_dict_from_flax_convnext``
carries a ``ConvNeXt``'s to :class:`~.convnext.ConvNeXt` (its docstring
has the names).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .unet2d import UNetPlusPlus

# Flax module name inside a residual block -> torch attribute, by block kind
_BLOCK_NAMES = {
    "_BasicBlock": {"Conv_0": "conv0", "BatchNorm_0": "bn0",
                    "Conv_1": "conv1", "BatchNorm_1": "bn1",
                    "Conv_2": "down_conv", "BatchNorm_2": "down_bn"},
    "_Bottleneck": {"Conv_0": "conv0", "BatchNorm_0": "bn0",
                    "Conv_1": "conv1", "BatchNorm_1": "bn1",
                    "Conv_2": "conv2", "BatchNorm_2": "bn2",
                    "Conv_3": "down_conv", "BatchNorm_3": "down_bn"},
}
_DECODER_NAMES = {"Conv_0": "conv0", "BatchNorm_0": "bn0",
                  "Conv_1": "conv1", "BatchNorm_1": "bn1"}


def _unetpp_names() -> Dict[str, str]:
    """The UNet++'s top-level Flax names -> torch module prefixes."""
    blocks = [f"nodes.x_{i}_{j}" for j, i in UNetPlusPlus.node_order()]
    blocks.append("tail")
    convs = [f"{b}.conv{n}" for b in blocks for n in (0, 1)] + ["head"]
    bns = [f"{b}.bn{n}" for b in blocks for n in (0, 1)]
    return {**{f"Conv_{i}": t for i, t in enumerate(convs)},
            **{f"BatchNorm_{i}": t for i, t in enumerate(bns)}}


_UNETPP_NAMES = _unetpp_names()


def _module_path(path: tuple, unetpp: bool = False) -> str:
    """Flax module path (tuple of names) -> torch module prefix."""
    if unetpp and len(path) == 1 and path[0] in _UNETPP_NAMES:
        return _UNETPP_NAMES[path[0]]
    if path == ("Conv_0",):
        return "head"
    if path[0] == "ResNetEncoder_0":
        if path[1:] == ("Conv_0",):
            return "encoder.stem_conv"
        if path[1:] == ("BatchNorm_0",):
            return "encoder.stem_bn"
        m = re.fullmatch(r"(_BasicBlock|_Bottleneck)_(\d+)", path[1])
        if m and len(path) == 3 and path[2] in _BLOCK_NAMES[m.group(1)]:
            return (f"encoder.blocks.{m.group(2)}."
                    f"{_BLOCK_NAMES[m.group(1)][path[2]]}")
    m = re.fullmatch(r"_DecoderBlock_(\d+)", path[0])
    if not unetpp and m and len(path) == 2 and path[1] in _DECODER_NAMES:
        return f"decoder.{m.group(1)}.{_DECODER_NAMES[path[1]]}"
    raise KeyError(f"Flax module {'/'.join(path)} has no torch counterpart")


def _leaves(tree: Mapping, prefix: tuple = ()) -> Dict[tuple, np.ndarray]:
    out: Dict[tuple, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def state_dict_from_flax(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """Carry the JAX ``ResNetEncoderUNet`` or ``UNetPlusPlus`` weights into
    a torch state_dict.

    ``params`` / ``batch_stats`` are the nested dicts of arrays (numpy or
    jax) from ``model.init`` or a checkpoint. Load the result with
    ``model.load_state_dict(sd)`` (strict), which raises on any torch key the
    trees did not fill."""
    p_leaves = _leaves(params)
    s_leaves = _leaves(batch_stats)
    unetpp = any(k.startswith("BatchNorm_") for k in params)
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in p_leaves.items():
        mod, leaf = path[:-1], path[-1]
        prefix = _module_path(mod, unetpp)
        is_bn = mod[-1].startswith("BatchNorm_")
        if not is_bn and leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: expected an HWIO "
                                 f"kernel, got shape {arr.shape}")
            sd[f"{prefix}.weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif not is_bn and leaf == "bias":
            sd[f"{prefix}.bias"] = torch.from_numpy(arr.copy())
        elif is_bn and leaf in ("scale", "bias"):
            name = "weight" if leaf == "scale" else "bias"
            sd[f"{prefix}.{name}"] = torch.from_numpy(arr.copy())
            for stat, buf in (("mean", "running_mean"),
                              ("var", "running_var")):
                key = mod + (stat,)
                if key not in s_leaves:
                    raise KeyError(f"batch_stats lacks {'/'.join(key)}")
                sd[f"{prefix}.{buf}"] = torch.from_numpy(
                    s_leaves[key].copy())
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise KeyError(f"params leaf {'/'.join(path)} has no torch "
                           "counterpart")
    used = {k.rsplit(".", 1)[0] for k in sd if k.endswith("running_mean")}
    for path in s_leaves:
        if (path[-1] not in ("mean", "var")
                or _module_path(path[:-1], unetpp) not in used):
            raise KeyError(f"batch_stats leaf {'/'.join(path)} has no "
                           "matching BatchNorm params")
    return sd


def _unit3d_target(unit: str, path: tuple, n_norms: int) -> str:
    """A leaf's module inside ``_ResUnit3D_{i}`` -> torch prefix: a unit of
    ``n_norms`` conv-norm-act triples holds its residual conv after them."""
    m = re.fullmatch(r"(Conv|GroupNorm|PReLU)_(\d+)", path[0])
    if m and len(path) == 1:
        kind, j = m.group(1), int(m.group(2))
        if kind == "Conv":
            return (f"{unit}.convs.{j}" if j < n_norms
                    else f"{unit}.residual" if j == n_norms else "")
        if j < n_norms:
            return f"{unit}.{'norms' if kind == 'GroupNorm' else 'acts'}.{j}"
    return ""


def state_dict_from_flax_unet3d(params: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """Carry the JAX ``ResidualUNet3D`` ``params`` into a torch state_dict
    of :class:`~.unet3d.ResidualUNet3D` (see the module docstring). Load it
    with ``model.load_state_dict(sd)`` (strict)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params).items():
        mod, leaf = path[:-1], path[-1]
        name = "/".join(path)
        prefix = ""
        m = re.fullmatch(r"_ResUnit3D_(\d+)", mod[0]) if mod else None
        if m:
            n_norms = sum(k.startswith("GroupNorm_")
                          for k in params[mod[0]])
            prefix = _unit3d_target(f"units.{m.group(1)}", mod[1:], n_norms)
        elif len(mod) == 1:
            t = re.fullmatch(r"ConvTranspose_(\d+)", mod[0])
            prefix = (f"up.{t.group(1)}" if t
                      else "head" if mod[0] == "Conv_0" else "")
        if not prefix:
            raise KeyError(f"params leaf {name} has no torch counterpart")
        kind = mod[-1].split("_")[0]
        if kind in ("Conv", "ConvTranspose") and leaf == "kernel":
            if arr.ndim != 5:
                raise ValueError(f"{name}: expected a DHWIO kernel, got "
                                 f"shape {arr.shape}")
            if kind == "ConvTranspose":
                arr = arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
            else:
                arr = arr.transpose(4, 3, 0, 1, 2)
            sd[f"{prefix}.weight"] = torch.from_numpy(np.array(arr,
                                                               order="C"))
        elif kind in ("Conv", "ConvTranspose") and leaf == "bias":
            sd[f"{prefix}.bias"] = torch.from_numpy(arr.copy())
        elif kind == "GroupNorm" and leaf in ("scale", "bias"):
            sd[f"{prefix}.{'weight' if leaf == 'scale' else 'bias'}"] = (
                torch.from_numpy(arr.copy()))
        elif kind == "PReLU" and leaf == "negative_slope":
            sd[f"{prefix}.weight"] = torch.from_numpy(arr.reshape(1).copy())
        else:
            raise KeyError(f"params leaf {name} has no torch counterpart")
    return sd


def _fastmri_module(mod: tuple) -> Tuple[str, str]:
    """A module path inside a ``FastMRIUnet`` tree -> (torch prefix, Flax
    kind), or ``("", "")``."""
    if mod == ("Conv_0",):
        return "head", "Conv"
    if len(mod) == 2:
        blk = re.fullmatch(r"ConvBlock_(\d+)", mod[0])
        sub = re.fullmatch(r"(Conv|GroupNorm)_([01])", mod[1])
        if blk and sub:
            kind = sub.group(1)
            return (f"conv_blocks.{blk.group(1)}."
                    f"{'convs' if kind == 'Conv' else 'norms'}."
                    f"{sub.group(2)}"), kind
        blk = re.fullmatch(r"TransposeConvBlock_(\d+)", mod[0])
        if blk and mod[1] in ("ConvTranspose_0", "GroupNorm_0"):
            kind = mod[1][:-2]
            return (f"tconv_blocks.{blk.group(1)}."
                    f"{'tconv' if kind == 'ConvTranspose' else 'norm'}"), kind
    return "", ""


def _fastmri_leaf(path: tuple, arr: np.ndarray
                  ) -> Tuple[str, torch.Tensor]:
    """A leaf of a ``FastMRIUnet`` tree -> (torch key, tensor), or raise."""
    name = "/".join(path)
    prefix, kind = _fastmri_module(path[:-1])
    leaf = path[-1]
    if kind in ("Conv", "ConvTranspose") and leaf == "kernel":
        if arr.ndim != 4:
            raise ValueError(f"{name}: expected an HWIO kernel, got shape "
                             f"{arr.shape}")
        arr = (arr[::-1, ::-1].transpose(2, 3, 0, 1)
               if kind == "ConvTranspose" else arr.transpose(3, 2, 0, 1))
        return f"{prefix}.weight", torch.from_numpy(np.array(arr, order="C"))
    if (prefix == "head" and leaf == "bias") or (
            kind == "GroupNorm" and leaf in ("scale", "bias")):
        return (f"{prefix}.{'weight' if leaf == 'scale' else 'bias'}",
                torch.from_numpy(arr.copy()))
    raise KeyError(f"params leaf {name} has no torch counterpart")


def state_dict_from_flax_fastmri_unet(params: Mapping[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """Carry a JAX ``FastMRIUnet``'s ``params`` into a torch state_dict of
    :class:`~.fastmri_unet.FastMRIUnet` (see the module docstring). Load it
    with ``model.load_state_dict(sd)`` (strict)."""
    return dict(_fastmri_leaf(path, arr)
                for path, arr in _leaves(params).items())


def state_dict_from_flax_varnet(params: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """Carry a JAX ``VarNet``'s ``params`` into a torch state_dict of
    ``recon/varnet.py:VarNet`` (see the module docstring)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params).items():
        name = "/".join(path)
        m = re.fullmatch(r"VarNetBlock_(\d+)", path[0])
        if path[:3] == ("SensitivityModel_0", "NormUnet_0", "FastMRIUnet_0"):
            prefix, rest = "sens_net.norm_unet.unet", path[3:]
        elif m and path[1:] == ("dc_weight",):
            sd[f"cascades.{m.group(1)}.dc_weight"] = torch.from_numpy(
                arr.reshape(1).copy())
            continue
        elif m and path[1:3] == ("NormUnet_0", "FastMRIUnet_0"):
            prefix, rest = f"cascades.{m.group(1)}.norm_unet.unet", path[3:]
        else:
            raise KeyError(f"params leaf {name} has no torch counterpart")
        key, val = _fastmri_leaf(rest, arr)
        sd[f"{prefix}.{key}"] = val
    return sd


# ConvNeXt: top-level Flax module -> torch prefix (blocks mapped apart)
_CONVNEXT_NAMES = {"Conv_0": "stem", "LayerNorm_0": "stem_norm",
                   "LayerNorm_4": "head_norm", "Dense_0": "head",
                   **{f"Conv_{s}": f"downsample.{s - 1}.conv"
                      for s in (1, 2, 3)},
                   **{f"LayerNorm_{s}": f"downsample.{s - 1}.norm"
                      for s in (1, 2, 3)}}
_CONVNEXT_BLOCK_NAMES = {"Conv_0": "dwconv", "LayerNorm_0": "norm",
                         "Dense_0": "pwconv1", "Dense_1": "pwconv2"}


def _convnext_leaf(prefix: str, path: tuple, arr: np.ndarray
                   ) -> Tuple[str, torch.Tensor]:
    """A Conv / LayerNorm / Dense leaf -> (torch key, tensor), or raise."""
    kind, leaf = re.sub(r"_\d+$", "", path[-2]), path[-1]
    if kind == "Conv" and leaf == "kernel":
        arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    elif kind == "Dense" and leaf == "kernel":
        arr = arr.T                              # (in, out) -> (out, in)
    elif not (leaf == "bias" or (kind == "LayerNorm" and leaf == "scale")):
        raise KeyError(f"params leaf {'/'.join(path)} has no torch "
                       "counterpart")
    return (f"{prefix}.{'bias' if leaf == 'bias' else 'weight'}",
            torch.from_numpy(np.array(arr, order="C")))


def state_dict_from_flax_convnext(params: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """Carry a JAX ``ConvNeXt``'s ``params`` into a torch state_dict of
    :class:`~.convnext.ConvNeXt`: ``Conv_0`` / ``LayerNorm_0`` the stem,
    ``LayerNorm_{s}`` + ``Conv_{s}`` the downsample ahead of stage ``s``,
    ``LayerNorm_4`` + ``Dense_0`` the head; ``ConvNeXtBlock_{j}``, numbered
    in call order over all stages, goes to ``stages.{s}.{i}``, its stage
    read off its width (the stages' widths increase). Conv kernels HWIO ->
    OIHW (the depthwise ``(7, 7, 1, C)`` -> ``(C, 1, 7, 7)``), Dense kernels
    transposed, LayerNorm ``scale`` -> ``weight``, ``layer_scale`` ->
    ``gamma``. Load it with ``model.load_state_dict(sd)`` (strict)."""
    leaves = _leaves(params)
    widths = {}
    for path, arr in leaves.items():
        m = re.fullmatch(r"ConvNeXtBlock_(\d+)", path[0])
        if m and path[1:] == ("layer_scale",):
            widths[int(m.group(1))] = arr.shape[0]
    stage_of = {w: s for s, w in enumerate(sorted(set(widths.values())))}
    first = {}
    for j in sorted(widths):
        first.setdefault(widths[j], j)
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in leaves.items():
        m = re.fullmatch(r"ConvNeXtBlock_(\d+)", path[0])
        if m:
            j = int(m.group(1))
            w = widths[j]
            prefix = f"stages.{stage_of[w]}.{j - first[w]}"
            if path[1:] == ("layer_scale",):
                sd[f"{prefix}.gamma"] = torch.from_numpy(arr.copy())
                continue
            if len(path) != 3 or path[1] not in _CONVNEXT_BLOCK_NAMES:
                raise KeyError(f"params leaf {'/'.join(path)} has no torch "
                               "counterpart")
            prefix = f"{prefix}.{_CONVNEXT_BLOCK_NAMES[path[1]]}"
        elif len(path) == 2 and path[0] in _CONVNEXT_NAMES:
            prefix = _CONVNEXT_NAMES[path[0]]
        else:
            raise KeyError(f"params leaf {'/'.join(path)} has no torch "
                           "counterpart")
        key, val = _convnext_leaf(prefix, path, arr)
        sd[key] = val
    return sd
