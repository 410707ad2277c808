"""A configuration's weights made from the seed on the device.

One truncated-normal draw fills every convolution at once, scaled by each
weight's He-normal standard deviation (fan-in, truncated at two standard
deviations, as the port's ``init_weights`` draws it leaf by leaf on the
host); BatchNorm scales are 1, shifts and the head's bias 0, running
statistics 0 and 1. Each input channel's 3x3 head kernel is then made
zero-sum: the features it reads are ReLU outputs with large positive
means, which would otherwise put every logit of a volume on one side of
the threshold; zero-sum, the logits straddle it as a trained model's do.
A BatchNorm with these running statistics keeps the eval-mode network a
plain ReLU network, which carries a rounding error forward about as far
as a trained one (statistics fitted to data would make it chaotic: a
0.2 % change of the input moves the logits by their own size).

Training normalizes by the batch, and a BatchNorm-ReLU network at a
random initialization is chaotic there whatever its statistics: with
shifts at 0, moving every input pixel by one bfloat16 step moves the
median leaf's first gradient norm, in float32, as far as the whole bf16
step does, so no comparison of gradients could tell bf16 from fp8. With
``bn_shift`` 1 (the training traffic's setting) most ReLUs pass their
input and the network carries rounding forward as a trained one does.

The tensors are float32, the type the port keeps its parameters in (the
``amp`` recipe computes in bfloat16 from them). Both sides get the same
tensors by name: the port copies them into its modules, the reference
reads them as they are.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..reference.models import bn_names, param_shapes

TRUNC_STD = 0.87962566103423978   # std of a unit normal cut to [-2, 2]


def make_weights(model: str, gen: torch.Generator, bn_shift: float = 0.0
                 ) -> Tuple[Dict[str, torch.Tensor],
                            Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
    """``(params, running)``: every parameter by name, and every
    BatchNorm's running ``(mean, var)``, on the generator's device.
    ``bn_shift`` starts every BatchNorm shift there instead of at 0."""
    dev = gen.device
    shapes = param_shapes(model)
    convs = [(n, s) for n, s in shapes if len(s) == 4]
    sizes = [math.prod(s) for _, s in convs]
    flat = torch.empty(sum(sizes), device=dev)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    std = torch.tensor([(2.0 / math.prod(s[1:])) ** 0.5 / TRUNC_STD
                        for _, s in convs], device=dev)
    flat *= torch.repeat_interleave(
        std, torch.tensor(sizes, device=dev), output_size=flat.numel())
    params = dict(zip([n for n, _ in convs],
                      (t.view(s) for t, (_, s) in zip(
                          torch.split(flat, sizes), convs))))
    head = params["head.weight"]
    head -= head.mean(dim=(2, 3), keepdim=True)
    for n, s in shapes:
        if len(s) == 1:
            fill = (1.0 if n.endswith(".weight") else
                    bn_shift if n != "head.bias" else 0.0)
            params[n] = torch.full(s, fill, device=dev)
    running = {n: (torch.zeros(c, device=dev), torch.ones(c, device=dev))
               for n, c in bn_names(model)}
    return {n: params[n] for n, _ in shapes}, running
