"""``backward_ms.train`` (ms): device milliseconds per optimiser step of the
work launched inside the profiler's ``autograd::engine::evaluate_function``
ranges (the autograd backward that ``loss.backward()`` runs, with remat's
recomputation), in the traced window."""

PREFIX = "autograd::engine::evaluate_function"


def read(ctx):
    if ctx.trace is None or ctx.work["kind"] != "train" or not ctx.work["steps"]:
        return None
    ranges, seconds = ctx.trace.device_s_under(lambda name: name.startswith(PREFIX))
    if not ranges or seconds <= 0:
        return None
    return 1e3 * seconds / ctx.work["steps"]
