"""FLOPs a slice of each configuration's model, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's plain
model (``reference/models.py``) on the meta device: the convolutions'
multiply-adds counted twice, nothing for BatchNorm, activations or
resizing. Training counts the forward and the backward pass (no gradient
for the input image, no recomputation); serving the forward pass.
"""

from __future__ import annotations

from functools import lru_cache

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.models import Net, bn_names, param_shapes


@lru_cache(maxsize=None)
def flops_per_slice(model: str, h: int, w: int, backward: bool) -> int:
    dev = torch.device("meta")
    P = {n: torch.empty(s, device=dev, requires_grad=backward)
         for n, s in param_shapes(model)}
    stats = {n: (torch.empty(c, device=dev), torch.empty(c, device=dev))
             for n, c in bn_names(model)}
    x = torch.empty((1, 1, h, w), device=dev)
    with FlopCounterMode(display=False) as counter:
        if backward:
            Net(model, P, train=True)(x).sum().backward()
        else:
            with torch.no_grad():
                Net(model, P, train=False, stats=stats)(x)
    return int(counter.get_total_flops())
