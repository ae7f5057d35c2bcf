"""``idle_share.train`` (%): the share of the traced window in which no
kernel, copy or memset ran on the card: 1 - (union of their intervals) /
(window length), both from the one traced window."""


def read(ctx):
    if ctx.trace is None or ctx.work["kind"] != "train":
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
