"""``morton_select_roofline`` (%): the Morton select kernel's (B7) share of
its roofline. Each launch's bound is the larger of 9 operations per (query,
candidate), 3 block candidates a query over every curve copy, at the
float32 peak, and its candidates in and ids and distances out at the HBM
peak (the operations bound it at both cells' shapes). It is divided by the
device time of the kernels whose name :data:`KERNEL` matches (the port's
``select_kernel<K>``, not torch's index or masked selects), summed over the
traced window, each launch counted."""

import re

from benchmark.harness.counts import bound_s

KERNEL = re.compile(r"(?<![A-Za-z0-9_])select_kernel<")


def read(ctx):
    b7 = ctx.counts.get("b7")
    if ctx.trace is None or b7 is None:
        return None
    count, seconds = ctx.trace.kernels(lambda name: KERNEL.search(name) is not None)
    if not count or seconds <= 0:
        return None
    return 100.0 * count * bound_s(*b7)[0] / seconds
