"""Rollout traffic: a galaxy rolled forward by the surrogate.

Traffic file keys: ``n_bodies``; ``segment_steps``, the length of each call
of the program's ``autoregressive_rollout`` (each segment starts from the
last state of the one before); ``graph_refresh``, the graph's rebuild
interval inside a segment; ``samples``, how many timed steps are kept for
the check; ``rate_metric``, the name of the end-to-end metric the rate is
reported under (a mix that paces the card differently has a rate, and a
bound, of its own); ``limits`` of the numbers compared.

The window runs whole segments until ``--seconds`` have passed; each
segment completes ``segment_steps - 1`` new steps of every body (its row 0
is the state it started from, its acceleration predicted again).

The check follows the program step by step from its own state: for the
first step of the window (from the benchmark's initial galaxy) and for a
seeded sample of ``samples`` timed steps, kept by reservoir sampling over
all segments, the reference takes the program's state before the step (and
the positions its graph was built from), rebuilds the graph with its own
Morton search, runs its own forward pass and leapfrog kick and drift, and
compares:

- ``acc_gap``: the largest gap of an acceleration component over the
  largest reference component (graph build and forward);
- ``state_ulps``: the largest gap, in float32 units in the last place of
  the reference, of a position or velocity after the step from the
  reference's kicks and drift, which take the program's state before the
  step and the program's acceleration of the step (judged by ``acc_gap``).
  The two sides run the same float32 operations in the same order, so a
  sound step is exact and the limit is 0. (A step moves a body by far less
  than its coordinates' rounding, so only an exact comparison can see a
  step that is not taken.)
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import counts, inputs, port, weights
from benchmark.reference import models as ref_models
from benchmark.reference import morton

# receivers a block in the reference forward
REF_ROWS = {"gnn": 131072, "contconv": 4096}


def setup(ctx):
    from nbody_tpu_torch.train.rollout import autoregressive_rollout

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n = tr["n_bodies"]
    p, v, m = inputs.galaxy(ctx.seed, 0, n, cfg)
    pos0, vel0, mass = (torch.from_numpy(x).to(dev) for x in (p, v, m))
    model = port.build_model(cfg, weights.draw(cfg, ctx.seed, dev), dev, training=False)
    st = SimpleNamespace(model=model, pos0=pos0, vel0=vel0, mass=mass, run=autoregressive_rollout,
                         hooks=[])
    if ctx.trace and cfg["model"] == "contconv":
        st.hooks = _collect_spans(model)
    # one whole segment builds and loads every kernel and fills the allocator
    _segment(st, cfg, tr, pos0, vel0)
    kept = tr["samples"] + 1
    shape = (kept, n, 3)
    st.slots = {k: torch.empty(shape, dtype=torch.float32, device=dev)
                for k in ("pos_prev", "vel_prev", "acc_prev", "pos", "vel", "acc", "graph_pos")}
    st.slot_meta = [None] * kept
    st.start_acc = torch.empty((n, 3), dtype=torch.float32, device=dev)
    st.rng = np.random.default_rng([int(ctx.seed), 11])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def _segment(st, cfg, tr, pos, vel):
    return st.run(st.model, pos, vel, st.mass, tr["segment_steps"], cfg["dt"],
                  graph_refresh=tr["graph_refresh"])


def _collect_spans(model):
    """Host ranges ``bench.contconv_collect`` around each ContConv layer's
    forward, from forward hooks: the device work launched inside them is the
    layer's (its gathers and its collect)."""
    open_ranges = []

    def pre(mod, args):
        rf = torch.profiler.record_function("bench.contconv_collect")
        rf.__enter__()
        open_ranges.append(rf)

    def post(mod, args, out):
        open_ranges.pop().__exit__(None, None, None)

    handles = []
    for layer in port.conv_layers(model):
        handles += [layer.register_forward_pre_hook(pre), layer.register_forward_hook(post)]
    return handles


def _keep(st, slot, seg, s, ps, vs, accs, refresh):
    r0 = s if refresh <= 1 else (s - 1) - (s - 1) % refresh
    for key, src in (("pos_prev", ps[s - 1]), ("vel_prev", vs[s - 1]), ("acc_prev", accs[s - 1]),
                     ("pos", ps[s]), ("vel", vs[s]), ("acc", accs[s]), ("graph_pos", ps[r0])):
        st.slots[key][slot].copy_(src)
    st.slot_meta[slot] = (seg, s)


def window(st, ctx, seconds):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    steps = tr["segment_steps"]
    k = tr["samples"]
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    pos, vel = st.pos0, st.vel0
    segs = 0
    t0 = time.perf_counter()
    while True:
        ps, vs, accs = _segment(st, cfg, tr, pos, vel)
        if segs == 0:
            st.start_acc.copy_(accs[0])
            _keep(st, k, 0, 1, ps, vs, accs, tr["graph_refresh"])
        s = int(st.rng.integers(1, steps))
        slot = segs if segs < k else int(st.rng.integers(0, segs + 1))
        if slot < k:
            _keep(st, slot, segs, s, ps, vs, accs, tr["graph_refresh"])
        bad += (~torch.isfinite(ps[-1]).all()) | (~torch.isfinite(vs[-1]).all())
        pos, vel = ps[-1].clone(), vs[-1].clone()
        del ps, vs, accs
        segs += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    new_steps = segs * (steps - 1)
    n = tr["n_bodies"]
    return {"kind": "rollout", "seconds": elapsed, "segments": segs, "steps": new_steps,
            "attempted": segs, "failed": int(bad),
            "end_to_end": {tr["rate_metric"]: n * new_steps / elapsed}}


def release(st):
    for h in st.hooks:
        h.remove()
    st.model = st.run = None


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _ulps(a, b):
    """The largest gap of ``a`` from ``b`` in float32 units in the last place
    of ``b``."""
    mag = torch.clamp(b.abs(), min=torch.finfo(torch.float32).tiny)
    spacing = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return float(((a.double() - b.double()).abs() / spacing.double()).max())


def check(st, ctx, control=False):
    """[(name, value, limit)] and the counts the per-layer metrics read."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    dt, spec = cfg["dt"], cfg["graph"]
    w = weights.draw(cfg, ctx.seed, dev)
    rows = REF_ROWS[cfg["model"]]
    prec = "tf32" if control else "float32"
    mass = st.mass

    def fwd(pos, idx, valid, precision):
        return ref_models.forward(w, cfg, pos, mass, idx, valid, precision=precision, rows=rows)

    acc_gap = state_ulps = 0.0
    pairs = []
    with torch.no_grad():
        idx, valid = morton.graph(spec, st.pos0)
        a_ref = fwd(st.pos0, idx, valid, "float32")
        a_prog = fwd(st.pos0, idx, valid, prec) if control else st.start_acc
        acc_gap = _gap(a_prog, a_ref)
        if cfg["model"] == "contconv":
            pairs.append(_pairs_edges(cfg, st.pos0, idx, valid))
        for slot, meta in enumerate(st.slot_meta):
            if meta is None:
                continue
            sl = {key: t[slot] for key, t in st.slots.items()}
            v_half = sl["vel_prev"] + 0.5 * dt * sl["acc_prev"]
            pos_r = sl["pos_prev"] + dt * v_half
            gpos = pos_r if tr["graph_refresh"] <= 1 else sl["graph_pos"]
            idx, valid = morton.graph(spec, gpos)
            a_r = fwd(pos_r, idx, valid, "float32")
            if control:
                a_p = fwd(pos_r, idx, valid, prec)
                pos_p, vel_p = pos_r, v_half + 0.5 * dt * a_p
            else:
                a_p, pos_p, vel_p = sl["acc"], sl["pos"], sl["vel"]
            acc_gap = max(acc_gap, _gap(a_p, a_r))
            vel_r = v_half + 0.5 * dt * a_p
            state_ulps = max(state_ulps, _ulps(pos_p, pos_r), _ulps(vel_p, vel_r))
            if cfg["model"] == "contconv":
                pairs.append(_pairs_edges(cfg, pos_r, idx, valid))
    lim = tr["limits"]
    numbers = [("acc_gap", acc_gap, lim["acc_gap"]), ("state_ulps", state_ulps, lim["state_ulps"])]
    return numbers, _counts(cfg, tr, pairs)


def _pairs_edges(cfg, pos, idx, valid):
    """Per conv layer (receiver-cell pairs, live edges) of one graph."""
    mapped, window, _ = ref_models.conv_geometry(pos, idx, valid, cfg["radius"])
    out = []
    n = pos.shape[0]
    for d in cfg["filter_resolution"][:cfg["continuous_conv_layers"]]:
        cells, cw = ref_models.corners(mapped, d)
        live = (window[..., None] > 0) & (cw != 0)
        z = d ** 3
        keys = (torch.arange(n, device=pos.device)[:, None, None] * z + cells)[live]
        out.append((float(torch.unique(keys).numel()), float((window > 0).sum())))
    return out


def _counts(cfg, tr, pairs):
    """Work per forward and per graph build, for the per-layer metrics."""
    n = tr["n_bodies"]
    spec = cfg["graph"]
    k = spec["k"] if spec["kind"] == "knn" else spec["k_max"]
    out = {"b7": counts.b7_counts(n, k, spec["block"], spec["n_copies"])}
    if cfg["model"] == "gnn":
        out["forward_flops"] = counts.gnn_forward_flops(n, k, cfg)
    else:
        layers = [tuple(float(np.mean([p[i][j] for p in pairs])) for j in range(2))
                  for i in range(cfg["continuous_conv_layers"])]
        dim = cfg["continuous_conv_dim"]
        out["forward_flops"] = counts.contconv_forward_flops(n, k, cfg, layers)
        out["contconv_layers"] = [counts.b3_counts(n, k, pe, ed, dim, dim, d)
                                  for (pe, ed), d in zip(layers, cfg["filter_resolution"])]
    return out
