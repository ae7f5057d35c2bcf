"""``mfu.rollout`` (%): the model FLOPs of the rollout steps in the traced
window (``benchmark/harness/counts.py``: the least work of one forward a
step) over the window's length times the card's float32 peak."""

from benchmark.harness.counts import PEAK_FLOPS


def read(ctx):
    if ctx.trace is None or ctx.work["kind"] != "rollout":
        return None
    flops = ctx.work["steps"] * ctx.counts["forward_flops"]
    return 100.0 * flops / (ctx.trace.window_s * PEAK_FLOPS)
