"""The body-mask kernels' share of their roofline in the traced window:
the least time of every request's open/close and connected components at
its ``(S, 640, 368)`` stack (``counts/mask_kernels.py``) over the device
time of the kernels of ``csrc/open_close.cu`` and ``csrc/label_prop.cu``
that they launch, matched by name."""

import re

from benchmark.counts.mask_kernels import (LABEL_KERNELS, OPEN_CLOSE_KERNELS,
                                           mask_kernels_bound_s)


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("mask_shapes"):
        return None
    pat = re.compile(r"\b(%s)\b" % "|".join(OPEN_CLOSE_KERNELS
                                             + LABEL_KERNELS))
    spent = sum(t for n, t in tr["device_time_by_name"].items()
                if pat.search(n))
    if spent <= 0:
        return None
    bound = sum(mask_kernels_bound_s(tuple(s)) for s in ctx["mask_shapes"])
    return 100.0 * bound / spent
