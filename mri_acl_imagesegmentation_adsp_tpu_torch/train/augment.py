"""Batched geometric augmentation on the device (NCHW).

Counterpart: ``mri_acl_imagesegmentation_adsp_tpu/train/augment.py``:
``AugParams`` and the recipes (:25-44), ``sample_params`` (:47-75), the
inverse-mapped affine warp ``_warp_one`` (:92-156) and ``augment_batch``
(:332-362). The recipes follow the reference's albumentations pipelines:

  none   : identity
  light  : HorizontalFlip(p=.5) + ShiftScaleRotate(shift .03, scale .05,
           rotate 10 deg, p=.5, border constant 0)
  medium : HorizontalFlip(p=.5) + VerticalFlip(p=.1) + ShiftScaleRotate(
           .05, .10, 15 deg, p=.7, border constant 0)

Flips come first, then the shift-scale-rotate warp of the samples whose
``apply_ssr`` is set: each output pixel maps back to a source position,
the image is sampled bilinearly and the mask by nearest, and a source
outside the image gives 0. The JAX package runs the same warp on the TPU
through a gather-free two-pass lowering (``_warp_batch_separable``); that
is a TPU device and is not ported. ``heavy`` (elastic) is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class AugParams(NamedTuple):
    """Per-sample parameters, each a ``(B,)`` tensor."""
    hflip: torch.Tensor      # bool
    vflip: torch.Tensor      # bool
    apply_ssr: torch.Tensor  # bool
    shift_y: torch.Tensor    # fraction of H
    shift_x: torch.Tensor    # fraction of W
    scale: torch.Tensor      # multiplicative
    angle: torch.Tensor      # radians


_RECIPES = {
    "light": dict(hflip_p=0.5, vflip_p=0.0, ssr_p=0.5,
                  shift=0.03, scale=0.05, rot_deg=10.0),
    "medium": dict(hflip_p=0.5, vflip_p=0.1, ssr_p=0.7,
                   shift=0.05, scale=0.10, rot_deg=15.0),
}
RECIPES = ("none",) + tuple(_RECIPES)


def check_recipe(recipe: str) -> None:
    if recipe == "heavy":
        raise NotImplementedError(
            "aug 'heavy' (elastic deformation, train/augment.py "
            "_elastic_field) is not ported yet; use none, light or medium")
    if recipe not in RECIPES:
        raise ValueError(f"unknown aug recipe {recipe!r}; one of {RECIPES}")


def sample_params(generator: torch.Generator, batch: int,
                  recipe: str) -> AugParams:
    """Draw a batch's parameters on the generator's device."""
    check_recipe(recipe)
    dev = generator.device
    if recipe == "none":
        f = torch.zeros(batch, dtype=torch.bool, device=dev)
        z = torch.zeros(batch, device=dev)
        return AugParams(f, f, f, z, z, torch.ones(batch, device=dev), z)
    cfg = _RECIPES[recipe]

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator,
                                           device=dev)
    return AugParams(
        hflip=u(0.0, 1.0) < cfg["hflip_p"],
        vflip=u(0.0, 1.0) < cfg["vflip_p"],
        apply_ssr=u(0.0, 1.0) < cfg["ssr_p"],
        shift_y=u(-cfg["shift"], cfg["shift"]),
        shift_x=u(-cfg["shift"], cfg["shift"]),
        scale=1.0 + u(-cfg["scale"], cfg["scale"]),
        angle=u(-cfg["rot_deg"], cfg["rot_deg"]) * (math.pi / 180.0),
    )


def warp_affine(x: torch.Tensor, y: torch.Tensor, p: AugParams
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift-scale-rotate every sample of ``x`` ``(B, C, H, W)`` float and
    ``y`` ``(B, H, W)`` about the image centre (``_warp_one`` batched; the
    ``apply_ssr`` gate is the caller's)."""
    b, c, h, w = x.shape
    dev = x.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    col = lambda t: t.float().view(b, 1, 1)  # noqa: E731
    # destination coordinates about the centre, less the translation
    dy = yy - cy - col(p.shift_y) * h
    dx = xx - cx - col(p.shift_x) * w
    cos, sin = torch.cos(-col(p.angle)), torch.sin(-col(p.angle))
    inv_s = 1.0 / col(p.scale)
    sy = (sin * dx + cos * dy) * inv_s + cy
    sx = (cos * dx - sin * dy) * inv_s + cx

    valid = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
    y0 = torch.clamp(torch.floor(sy).long(), 0, h - 2)
    x0 = torch.clamp(torch.floor(sx).long(), 0, w - 2)
    fy = sy - y0
    fx = sx - x0

    flat = x.reshape(b, c, h * w)

    def at(rows, cols):
        idx = (rows * w + cols).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)
    wy0, wy1 = (1 - fy)[:, None], fy[:, None]
    wx0, wx1 = (1 - fx)[:, None], fx[:, None]
    val = (wy0 * (wx0 * at(y0, x0) + wx1 * at(y0, x0 + 1))
           + wy1 * (wx0 * at(y0 + 1, x0) + wx1 * at(y0 + 1, x0 + 1)))
    img = torch.where(valid[:, None], val, torch.zeros_like(val))

    # nearest for the mask: the corner that rounding fy / fx selects
    ny = y0 + (fy >= 0.5).long()
    nx = x0 + (fx >= 0.5).long()
    near = torch.gather(y.reshape(b, h * w), 1,
                        (ny * w + nx).reshape(b, h * w)).reshape(b, h, w)
    return img.to(x.dtype), torch.where(valid, near, torch.zeros_like(near))


def apply_params(x: torch.Tensor, y: torch.Tensor, p: AugParams
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flips, then the warp where ``apply_ssr`` is set; the other samples
    pass through bit-exact."""
    hf, vf = p.hflip.view(-1, 1, 1), p.vflip.view(-1, 1, 1)
    x = torch.where(hf[:, None], x.flip(3), x)
    y = torch.where(hf, y.flip(2), y)
    x = torch.where(vf[:, None], x.flip(2), x)
    y = torch.where(vf, y.flip(1), y)
    xw, yw = warp_affine(x, y, p)
    gate = p.apply_ssr.view(-1, 1, 1)
    return torch.where(gate[:, None], xw, x), torch.where(gate, yw, y)


def augment_batch(x: torch.Tensor, y: torch.Tensor,
                  generator: torch.Generator, recipe: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment ``x`` ``(B, C, H, W)`` float and ``y`` ``(B, H, W)`` with
    parameters drawn from ``generator``; same shapes out."""
    check_recipe(recipe)
    if recipe == "none":
        return x, y
    return apply_params(x, y, sample_params(generator, x.shape[0], recipe))
