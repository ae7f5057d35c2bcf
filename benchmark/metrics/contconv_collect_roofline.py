"""``contconv_collect_roofline`` (%): the ContConv layers' share of their
roofline. The bound of each layer call is the larger of its operations
(B3's rule: 2 ci co per receiver-cell pair plus 16 ci per live edge, pairs
and edges counted on the reference's own graph) at the float32 peak and its
bytes (node features, neighbour ids, edge geometry and filter bank in, the
output out) at the HBM peak; at 100k bodies and both filter resolutions the
operations bound it. It is divided by the device time of the work launched
inside the ``bench.contconv_collect`` host ranges that the benchmark opens
around each layer's forward (the layer's gathers and its collect)."""

from benchmark.harness.counts import bound_s


def read(ctx):
    layers = ctx.counts.get("contconv_layers")
    if ctx.trace is None or not layers:
        return None
    calls, seconds = ctx.trace.device_s_under(lambda name: name == "bench.contconv_collect")
    if not calls or seconds <= 0:
        return None
    per_forward = sum(bound_s(f, b)[0] for f, b in layers)
    return 100.0 * (calls / len(layers)) * per_forward / seconds
