"""Plain training steps of the segmentation recipe, from the same weights,
rows and augmentation seed as the port's first steps.

The recipe is the reference project's (``runs/corpus_scale_b8/args.json``
in the repository): augmentation ``light``, dice_bce, AdamW (lr 1e-3,
weight decay 1e-4) after a clip of the global gradient norm at 5.0. Each
step, written anew from the published definitions:

* the batch's images as the store keeps them (rounded to bfloat16), one
  channel;
* ``light`` augmentation (albumentations ``HorizontalFlip(p=.5)`` and
  ``ShiftScaleRotate(shift .03, scale .05, rotate 10 deg, p=.5)``, border
  0): per sample seven uniform draws from the augmentation generator, in
  the order hflip, vflip, apply, shift y, shift x, scale, angle, each
  ``lo + (hi - lo) * torch.rand(B)``; flips first, then each pixel of a
  warped sample mapped back about the image centre, the image sampled
  bilinearly and the mask at the nearest corner, a source outside the
  image giving 0;
* the forward pass in train mode (BatchNorm from the batch), float32 with
  TF32 off;
* the loss ``0.5 * dice + 0.5 * bce``: smp's batch-global soft Dice of
  the sigmoid (no smoothing, 1e-7 floor, zero for an empty target) and
  the mean binary cross-entropy with logits;
* the clip: ``n = sqrt(sum g^2)`` over all gradients, every gradient
  times ``5 / n`` when ``n >= 5`` (optax, no epsilon);
* AdamW (optax): ``m = .9 m + .1 g``, ``v = .999 v + .001 g^2``,
  ``p -= lr * (m / (1 - .9^t) / (sqrt(v / (1 - .999^t)) + 1e-8) + wd * p)``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .models import Net, bn_names, float32_exact

LIGHT = dict(hflip=0.5, vflip=0.0, ssr=0.5, shift=0.03, scale=0.05,
             rot_deg=10.0)


def draw_light(gen: torch.Generator, b: int) -> dict:
    dev = gen.device

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)
    c = LIGHT
    return dict(hflip=u(0.0, 1.0) < c["hflip"], vflip=u(0.0, 1.0) < c["vflip"],
                ssr=u(0.0, 1.0) < c["ssr"],
                shift_y=u(-c["shift"], c["shift"]),
                shift_x=u(-c["shift"], c["shift"]),
                scale=1.0 + u(-c["scale"], c["scale"]),
                angle=u(-c["rot_deg"], c["rot_deg"]) * (math.pi / 180.0))


def augment(x: torch.Tensor, y: torch.Tensor, p: dict):
    """``x`` ``(B, 1, H, W)`` float32, ``y`` ``(B, H, W)``."""
    b, _, h, w = x.shape
    hf = p["hflip"].view(b, 1, 1)
    x = torch.where(hf[:, None], x.flip(3), x)
    y = torch.where(hf, y.flip(2), y)
    vf = p["vflip"].view(b, 1, 1)
    x = torch.where(vf[:, None], x.flip(2), x)
    y = torch.where(vf, y.flip(1), y)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dev = x.device
    yy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    col = lambda t: t.float().view(b, 1, 1)  # noqa: E731
    dy = yy - cy - col(p["shift_y"]) * h
    dx = xx - cx - col(p["shift_x"]) * w
    a = -col(p["angle"])
    sy = (torch.sin(a) * dx + torch.cos(a) * dy) / col(p["scale"]) + cy
    sx = (torch.cos(a) * dx - torch.sin(a) * dy) / col(p["scale"]) + cx
    inside = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
    y0 = sy.floor().long().clamp(0, h - 2)
    x0 = sx.floor().long().clamp(0, w - 2)
    fy, fx = sy - y0, sx - x0
    img = x[:, 0]
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    val = ((1 - fy) * ((1 - fx) * img[bi, y0, x0] + fx * img[bi, y0, x0 + 1])
           + fy * ((1 - fx) * img[bi, y0 + 1, x0]
                   + fx * img[bi, y0 + 1, x0 + 1]))
    near = y[bi, y0 + (fy >= 0.5).long(), x0 + (fx >= 0.5).long()]
    xw = torch.where(inside, val, torch.zeros_like(val))[:, None]
    yw = torch.where(inside, near, torch.zeros_like(near))
    g = p["ssr"].view(b, 1, 1)
    return torch.where(g[:, None], xw, x), torch.where(g, yw, y)


def dice_bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    n = logits.shape[0]
    prob = torch.sigmoid(logits).reshape(n, -1)
    t = target.reshape(n, -1)
    inter, card = (prob * t).sum(), (prob + t).sum()
    dice = (1.0 - 2.0 * inter / card.clamp_min(1e-7)) * (t.sum() > 0)
    bce = (logits.clamp_min(0) - logits * target
           + torch.log1p(torch.exp(-logits.abs()))).mean()
    return 0.5 * dice + 0.5 * bce


def train_steps(model: str, params: Dict[str, torch.Tensor],
                images: torch.Tensor, masks: torch.Tensor, aug_seed: int,
                recipe: dict, quant: bool = False,
                drop_half: bool = False, jitter: bool = False) -> dict:
    """``images`` ``(steps, B, H, W)`` float32 and ``masks`` ``(steps, B, H,
    W)`` of the steps' rows, on the device to run on. Returns the losses,
    the first clipped gradient's norm and the parameters' change after the
    last step, each leaf's norm in ``params``' order, and every BatchNorm
    channel's batch variance in the first step's forward pass.
    ``drop_half`` plants a fault to read the comparison by: each step's
    second half of the batch left out, the mean taken over the rest.
    ``jitter`` moves every input pixel by one bfloat16 step up or down (a
    sign drawn from the seed of the augmentation): the float32 step's own
    sensitivity, the floor under any comparison of a lower-precision step
    with it."""
    dev = images.device
    with float32_exact():
        names = list(params)
        P = {n: params[n].detach().clone().float().requires_grad_()
             for n in names}
        p0 = [params[n].detach().float() for n in names]
        mu = [torch.zeros_like(p) for p in p0]
        nu = [torch.zeros_like(p) for p in p0]
        gen = torch.Generator(device=dev).manual_seed(aug_seed)
        lr, wd, clip = recipe["lr"], recipe["weight_decay"], \
            recipe["max_grad_norm"]
        losses: List[float] = []
        g1 = None
        for t in range(1, images.shape[0] + 1):
            x = images[t - 1].to(torch.bfloat16).float()[:, None]
            if jitter:
                sign = torch.randint(0, 2, x.shape, generator=torch.Generator(
                    device=dev).manual_seed(aug_seed + t), device=dev) * 2 - 1
                x = x * (1 + sign * 2.0 ** -8)
            y = masks[t - 1]
            x, y = augment(x, y, draw_light(gen, x.shape[0]))
            if drop_half:
                x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
            stats: dict = {}
            logits = Net(model, P, train=True, quant=quant,
                         checkpoint=True, capture=stats)(x)
            if t == 1:
                bn_vars = torch.cat([stats[n] for n, _ in bn_names(model)])
            loss = dice_bce(logits, y[:, None].float())
            grads = torch.autograd.grad(loss, [P[n] for n in names])
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            if norm >= clip:
                grads = [g * (clip / norm).float() for g in grads]
            if g1 is None:
                g1 = torch.stack([g.double().norm() for g in grads])
            with torch.no_grad():
                for i, n in enumerate(names):
                    g = grads[i]
                    mu[i].mul_(0.9).add_(g, alpha=0.1)
                    nu[i].mul_(0.999).addcmul_(g, g, value=0.001)
                    upd = (mu[i] / (1 - 0.9 ** t)) / (
                        (nu[i] / (1 - 0.999 ** t)).sqrt() + 1e-8)
                    P[n].sub_(lr * (upd + wd * P[n]))
            losses.append(float(loss.detach()))
        delta = torch.stack([(P[n].detach() - p0[i]).double().norm()
                             for i, n in enumerate(names)])
    return {"losses": losses, "grad_norms": g1.cpu(),
            "delta_norms": delta.cpu(), "bn_vars": bn_vars.cpu()}
