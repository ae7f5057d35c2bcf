"""``mfu.train`` (%): the model FLOPs of the optimiser steps in the traced
window (3 forwards of the batch a step, ``benchmark/harness/counts.py``;
recomputation under remat not counted) over the window's length times the
card's float32 peak."""

from benchmark.harness.counts import PEAK_FLOPS


def read(ctx):
    if ctx.trace is None or ctx.work["kind"] != "train":
        return None
    flops = ctx.work["steps"] * ctx.counts["step_flops"]
    return 100.0 * flops / (ctx.trace.window_s * PEAK_FLOPS)
