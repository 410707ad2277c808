"""Forward FLOPs of every slice the runner segmented in the traced window
(``counts/flops.py``) over the window's seconds, as a share of the H100's
dense bf16 peak (``counts/peaks.py``)."""

from benchmark.counts.peaks import BF16_FLOP_PER_S


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not ctx.get("slices"):
        return None
    flops = ctx["flops_per_slice"] * ctx["slices"]
    return 100.0 * flops / tr["window_s"] / BF16_FLOP_PER_S
