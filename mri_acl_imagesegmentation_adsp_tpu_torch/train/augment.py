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
is a TPU device and is not ported.

  heavy  : medium + an elastic displacement with p=.5 (``_elastic_field``
           :78-89): per sample, uniform noise in [-1, 1] for each of dy and
           dx, Gaussian-blurred (sigma 6 px, reflect border), divided by its
           standard deviation and scaled to alpha / 3 = 20 / 3 px, added to
           the (affine or identity) source position of every pixel.

jax.random's bits cannot be drawn in torch, so a sample's field comes from
a torch generator seeded with the sample's ``elastic_seed`` (drawn, as in
JAX, with the batch's parameters); the field's law and scale are JAX's.

Under data parallelism every rank draws the parameters of the *global*
batch from the same generator state and applies its own rows
(``augment_batch(..., rows=)``), so the generator streams stay equal
across the ranks and ``N`` ranks augment as one rank does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.restoration import gaussian_blur


class AugParams(NamedTuple):
    """Per-sample parameters, each a ``(B,)`` tensor."""
    hflip: torch.Tensor      # bool
    vflip: torch.Tensor      # bool
    apply_ssr: torch.Tensor  # bool
    shift_y: torch.Tensor    # fraction of H
    shift_x: torch.Tensor    # fraction of W
    scale: torch.Tensor      # multiplicative
    angle: torch.Tensor      # radians
    apply_elastic: Optional[torch.Tensor] = None   # bool (heavy)
    elastic_seed: Optional[torch.Tensor] = None    # int64 (heavy)

    def rows(self, rows: slice) -> "AugParams":
        """The parameters of the samples ``rows``."""
        return AugParams(*(None if t is None else t[rows] for t in self))


_RECIPES = {
    "light": dict(hflip_p=0.5, vflip_p=0.0, ssr_p=0.5,
                  shift=0.03, scale=0.05, rot_deg=10.0, elastic_p=0.0),
    "medium": dict(hflip_p=0.5, vflip_p=0.1, ssr_p=0.7,
                   shift=0.05, scale=0.10, rot_deg=15.0, elastic_p=0.0),
    "heavy": dict(hflip_p=0.5, vflip_p=0.1, ssr_p=0.7,
                  shift=0.05, scale=0.10, rot_deg=15.0, elastic_p=0.5),
}
RECIPES = ("none",) + tuple(_RECIPES)

ELASTIC_ALPHA = 20.0     # displacement magnitude (px)
ELASTIC_SIGMA = 6.0      # smoothing sigma (px)
_INT32_MAX = 2 ** 31 - 1


def check_recipe(recipe: str) -> None:
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
    p = AugParams(
        hflip=u(0.0, 1.0) < cfg["hflip_p"],
        vflip=u(0.0, 1.0) < cfg["vflip_p"],
        apply_ssr=u(0.0, 1.0) < cfg["ssr_p"],
        shift_y=u(-cfg["shift"], cfg["shift"]),
        shift_x=u(-cfg["shift"], cfg["shift"]),
        scale=1.0 + u(-cfg["scale"], cfg["scale"]),
        angle=u(-cfg["rot_deg"], cfg["rot_deg"]) * (math.pi / 180.0),
    )
    if cfg["elastic_p"] > 0:    # light and medium draw no more numbers
        p = p._replace(
            apply_elastic=u(0.0, 1.0) < cfg["elastic_p"],
            elastic_seed=torch.randint(0, _INT32_MAX, (batch,),
                                       generator=generator, device=dev))
    return p


def elastic_field(seed: int, h: int, w: int,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """``(2, H, W)`` f32 displacement ``(dy, dx)`` in pixels of one sample:
    uniform noise in [-1, 1] from a generator seeded with ``seed``, blurred
    (sigma ``ELASTIC_SIGMA``), divided by its standard deviation and scaled
    by ``ELASTIC_ALPHA / 3``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.rand((2, h, w), generator=gen, device=device) * 2.0 - 1.0
    d = gaussian_blur(noise, ELASTIC_SIGMA)
    std = d.reshape(2, -1).std(dim=1, correction=0).view(2, 1, 1)
    return d / (std + 1e-6) * (ELASTIC_ALPHA / 3.0)


def elastic_fields(p: AugParams, h: int, w: int,
                   device: torch.device) -> torch.Tensor:
    """``(B, 2, H, W)``: the field of each sample whose ``apply_elastic``
    is set, zeros elsewhere."""
    out = torch.zeros((len(p.elastic_seed), 2, h, w), device=device)
    for i in torch.nonzero(p.apply_elastic).flatten().tolist():
        out[i] = elastic_field(int(p.elastic_seed[i]), h, w, device)
    return out


def _affine_sources(p: AugParams, b: int, h: int, w: int,
                    dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, H, W)`` source rows and columns of the shift-scale-rotate
    about the image centre."""
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
    return sy, sx


def warp_affine(x: torch.Tensor, y: torch.Tensor, p: AugParams
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift-scale-rotate every sample of ``x`` ``(B, C, H, W)`` float and
    ``y`` ``(B, H, W)`` about the image centre (``_warp_one`` batched; the
    ``apply_ssr`` gate is the caller's)."""
    b, _, h, w = x.shape
    return _sample(x, y, *_affine_sources(p, b, h, w, x.device))


def warp_elastic(x: torch.Tensor, y: torch.Tensor, p: AugParams,
                 fields: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_warp_one(elastic=True)`` batched: every sample is sampled at its
    affine source where ``apply_ssr`` is set (else its own pixel), moved by
    ``fields`` ``(B, 2, H, W)`` where ``apply_elastic`` is set."""
    b, _, h, w = x.shape
    sy, sx = _affine_sources(p, b, h, w, x.device)
    yy = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w)
    ssr = p.apply_ssr.view(b, 1, 1)
    sy = torch.where(ssr, sy, yy.expand(b, h, w))
    sx = torch.where(ssr, sx, xx.expand(b, h, w))
    el = p.apply_elastic.view(b, 1, 1)
    sy = torch.where(el, sy + fields[:, 0], sy)
    sx = torch.where(el, sx + fields[:, 1], sx)
    return _sample(x, y, sy, sx)


def _sample(x: torch.Tensor, y: torch.Tensor, sy: torch.Tensor,
            sx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` bilinearly and ``y`` by nearest at the source positions
    ``(B, H, W)``; a source outside the image gives 0."""
    b, c, h, w = x.shape
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


def apply_params(x: torch.Tensor, y: torch.Tensor, p: AugParams,
                 fields: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flips, then the warp where ``apply_ssr`` is set; the other samples
    pass through bit-exact. With elastic parameters (heavy) every sample
    goes through :func:`warp_elastic`, with ``fields`` or else the fields
    of its seeds (a sample with neither warp is sampled at its own
    pixels, which is exact)."""
    hf, vf = p.hflip.view(-1, 1, 1), p.vflip.view(-1, 1, 1)
    x = torch.where(hf[:, None], x.flip(3), x)
    y = torch.where(hf, y.flip(2), y)
    x = torch.where(vf[:, None], x.flip(2), x)
    y = torch.where(vf, y.flip(1), y)
    if p.apply_elastic is not None:
        if fields is None:
            fields = elastic_fields(p, x.shape[2], x.shape[3], x.device)
        xw, yw = warp_elastic(x, y, p, fields)
        return xw, yw
    xw, yw = warp_affine(x, y, p)
    gate = p.apply_ssr.view(-1, 1, 1)
    return torch.where(gate[:, None], xw, x), torch.where(gate, yw, y)


def augment_batch(x: torch.Tensor, y: torch.Tensor,
                  generator: torch.Generator, recipe: str,
                  rows: Optional[slice] = None, batch: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment ``x`` ``(B, C, H, W)`` float and ``y`` ``(B, H, W)`` with
    parameters drawn from ``generator``; same shapes out. With ``rows``,
    ``x`` and ``y`` are those rows of a ``batch``-row global batch: the
    whole batch's parameters are drawn and the rows' applied."""
    check_recipe(recipe)
    if recipe == "none":
        return x, y
    p = sample_params(generator, batch if rows is not None else x.shape[0],
                      recipe)
    return apply_params(x, y, p if rows is None else p.rows(rows))
