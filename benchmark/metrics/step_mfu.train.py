"""Model FLOPs of the traced window's training steps (forward and backward
a slice, ``counts/flops.py``) over the window's seconds, as a share of the
H100's dense bf16 peak (``counts/peaks.py``)."""

from benchmark.counts.peaks import BF16_FLOP_PER_S


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("steps"):
        return None
    flops = ctx["flops_per_slice"] * ctx["batch"] * ctx["steps"]
    return 100.0 * flops / tr["window_s"] / BF16_FLOP_PER_S
