"""Plain served answers: the k-space chain, then the model in float32 in
eval mode."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .kspace_chain import chain
from .models import Net, float32_exact

BLOCK = 8     # slices a forward pass, so that the reference stays small


@torch.no_grad()
def answer(model: str, params: Dict[str, torch.Tensor],
           stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
           kpair: torch.Tensor, out_hw: int, control: bool = False) -> dict:
    """``{"logits": (S, H, W) float32, "body_mask": (S, H, W) bool}`` on
    the host for one ``(S, H, W, 2)`` k-space volume (on the device to run
    on). ``control`` computes the chain in bfloat16 and the model in fp8."""
    with float32_exact():
        x, body = chain(kpair, bf16=control, out=(out_hw, out_hw))
        net = Net(model, params, train=False, stats=stats, quant=control)
        logits = torch.cat([net(x[i:i + BLOCK].float())[:, 0].cpu()
                            for i in range(0, x.shape[0], BLOCK)])
    return {"logits": logits, "body_mask": body.cpu()}
