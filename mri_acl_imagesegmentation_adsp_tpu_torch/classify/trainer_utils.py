"""The classifier's primary schedulers as lr factors of the epoch index.

The port's own copy of
``mri_acl_imagesegmentation_adsp_tpu/classify/trainer_utils.py`` (the
vendored ``model/extra_model_utils.py:17-55``): exponentiallr ``gamma^e``;
multistep ``gamma^(milestones passed)``; cosine ``CosineAnnealingLR(T_max
= 3)``; plat and none constant (the trainer's always-on secondary
ReduceLROnPlateau does the reducing).
"""

from __future__ import annotations

import math
from typing import Callable


def make_scheduler(args) -> Callable[[int], float]:
    name = getattr(args, "scheduler", "none")
    gamma = getattr(args, "gamma", 0.95)
    milestones = tuple(getattr(args, "lr_decay_steps", ()))

    if name == "exponentiallr":
        return lambda e: gamma ** e
    if name == "multistep":
        return lambda e: gamma ** sum(1 for m in milestones if e >= m)
    if name == "cosine":
        t_max = 3

        def cosine(e: int) -> float:
            r = e % (2 * t_max)
            if r > t_max:
                r = 2 * t_max - r
            return 0.5 * (1 + math.cos(math.pi * r / t_max))
        return cosine
    return lambda e: 1.0
