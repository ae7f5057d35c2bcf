"""Times B3 (ContConv collect), B4 (its filter gradient), B5 (its feature
gradient) and B6 (its geometry gradient) step by step on the geometry of a
Morton radius graph of spiral bodies:

    python -m nbody_tpu_torch.experiments.contconv_bench --n-bodies 2000 100000 --d 6 4

Per body count and filter resolution D it prints one JSON row: the pair
count of the plan and its spread over the receivers and the cells, whether
the plan equals its plain version, B3-B6 and the bins, B5's dG product and
its unbin pass against their plain versions (max |d| / max |plain|),
milliseconds (CUDA events) of the plan, the bins, the dG product, the unbin
pass and of the whole B3, B4, B5 and B6 calls, with the rows of one
profiled call of each, B6's device ms a call (all its kernels, and its
geometry pass alone), and the scratch bytes, beside the least time an H100
could take for the call (``bound_ms``; B6's own, ``b6_bound_ms``, counts
the edges of zero window that it keeps). ``--digests PATH`` keeps the
SHA-256 of B3's, B4's and B5's outputs: the first run writes them, a later
one (from another checkout, for an A/B) reports whether its bits equal
them. It uses only what every version of the port since its B5 redesign
has, so a copy placed in an older checkout times that one. On the CPU
(``--device cpu``) every step is its plain version and the times are host
times of those.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import torch

from nbody_tpu_torch.experiments.common import resolve_device
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.models.contconv import conv_geometry
from nbody_tpu_torch.ops import contconv_kernel as cck
from nbody_tpu_torch.ops.interpolate import trilinear_corners
from nbody_tpu_torch.ops.radius import radius_neighbors
from nbody_tpu_torch.utils import prng, timing
from nbody_tpu_torch.utils.timing import cuda_time_ms, profile_ms


def _ms(fn, dev, reps):
    if dev.type == "cuda":
        return cuda_time_ms(fn, reps=reps, warmup=1)
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def bound_ms(pairs: int, m: int, k: int, ci: int, co: int, d: int):
    """(ms, "operations" or "bytes"): the larger of the call's FP32
    operations (2 ci co a (receiver, cell) pair, 2 ci an edge corner) and its
    bytes (geometry, features or their cotangent, bank and an (M, co)
    operand, each once) at the card's peaks; the same for B3, B4 and B5."""
    return timing.bound_ms(2.0 * pairs * ci * co + 16.0 * m * k * ci,
                           4.0 * (4 * m * k + m * k * ci + d ** 3 * ci * co + m * co))


def b6_bound_ms(gxyz, win, ci: int, co: int, d: int):
    """B6's (ms, "operations" or "bytes"): 2 ci co a (receiver, cell) pair
    of every edge's live corners, the edges of zero window included (the
    window's cotangent does not vanish there), and 2 ci an (edge, live
    corner); bytes: the geometry, features, bank and ``dout`` read once and
    the four (M, k) cotangents written once."""
    m, k = win.shape
    pairs = corners = 0
    rows = max(1, (1 << 22) // k)
    for r0 in range(0, m, rows):
        sl = slice(r0, r0 + rows)
        cidx, cw = trilinear_corners(torch.stack([g[sl] for g in gxyz], -1).reshape(-1, 3), d)
        live = cw != 0
        recv = torch.arange(r0, r0 + win[sl].shape[0], device=win.device).repeat_interleave(k)
        pairs += torch.unique(recv[:, None].expand_as(cidx)[live] * d ** 3
                              + cidx[live].long()).numel()
        corners += int(live.sum())
    return timing.bound_ms(2.0 * pairs * ci * co + 2.0 * corners * ci,
                           4.0 * (8 * m * k + m * k * ci + d ** 3 * ci * co + m * co))


def _digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def bench(n: int, d: int, k: int, width: int, dev: torch.device, reps: int = 5,
          digests: dict = None) -> dict:
    """One row for ``n`` spiral bodies at filter resolution ``d``. With
    ``digests``, B3's, B4's and B5's output digests go in under this row's
    key, or are compared with the ones there."""
    gen = torch.Generator().manual_seed(n + d)
    pos, _, _ = generate_spiral(prng.PRNGKey(n + 5), n, device=dev)
    impl = "kernel" if dev.type == "cuda" else "dense"
    idx, valid = radius_neighbors(pos, 1.0, k, method="morton", impl=impl)
    geom = conv_geometry(pos[None], idx[None], valid[None], 1.0)
    grid = (geom["mapped"][0] + 1.0) * ((d - 1) / 2.0)
    gxyz = tuple(grid[..., a].contiguous() for a in range(3))
    win = geom["window"][0].contiguous()
    fj = torch.randn(n, width, generator=gen).to(dev)[idx.long()].contiguous()
    filters = torch.randn(d ** 3, width, width, generator=gen).to(dev)
    dout = torch.randn(n, width, generator=gen).to(dev)
    args = (*gxyz, win, fj, filters)
    cuda = dev.type == "cuda"

    plan = cck.pair_plan(*gxyz, win, d=d)
    want_plan = cck.pair_plan_torch(*gxyz, win, d=d)
    counts = (plan.rstart[1:] - plan.rstart[:-1]).float()
    q = torch.quantile(counts, torch.tensor([0.5, 0.9, 0.99], device=dev)).tolist()
    row = {"n_bodies": n, "d": d, "k": k, "width": width, "device": str(dev),
           "pairs": plan.cell_r.numel(), "pairs_per_receiver_mean": float(counts.mean()),
           "pairs_per_receiver_p50_p90_p99_max": [*q, float(counts.max())],
           "live_edges": int((win != 0).sum()),
           "pairs_per_cell_mean_max": [plan.cell_r.numel() / d ** 3,
                                       int((plan.coff[1:] - plan.coff[:-1]).max())],
           "plan_equals_plain": all(torch.equal(a, b) for a, b in zip(plan, want_plan))}
    row["bound_ms"], row["bound_by"] = bound_ms(row["pairs"], n, k, width, width, d)

    bins = cck._bins_cuda if cuda else (
        lambda p, *a: cck.pair_bins_torch(p, *a[:5], d=a[5]))
    g = bins(plan, *gxyz, win, fj, d)
    row["bins_vs_plain"] = _rel(g[:, :width], cck.pair_bins_torch(plan, *gxyz, win, fj, d=d))
    del g
    if cuda:
        items = cck._plan_cuda(*gxyz, win, d)[1]  # the work items of this plan
        ft, dpad = cck._f_transposed(filters), cck._padded_rows(dout)

        def dg_step():
            return cck._product_cuda(dpad, True, ft, plan, items, width, width, d)

        def unbins_step(dg):
            return cck._unbins_cuda(plan, dg, *gxyz, win, d, torch.empty_like(fj))
    else:
        def dg_step():
            return cck.pair_dg_torch(plan, dout, filters)

        def unbins_step(dg):
            return cck.pair_unbins_torch(plan, dg, *gxyz, win, d=d)
    dg = dg_step()
    want_dg = cck.pair_dg_torch(plan, dout, filters)
    row["dg_vs_plain"] = _rel(dg[:, :width], want_dg)
    row["unbins_vs_plain"] = _rel(unbins_step(dg), cck.pair_unbins_torch(
        plan, want_dg, *gxyz, win, d=d))
    out = cck.contconv_collect(*args, d=d)
    d_f = cck.contconv_bwd_filters(*args, dout, d=d)
    dfeat = cck.contconv_bwd_feat(*args, dout, d=d)
    geo = cck.contconv_bwd_geom(*args, dout, d=d)
    row["b3_vs_plain"] = _rel(out, cck.contconv_collect_torch(*args, d=d))
    want = cck.contconv_collect_bwd_torch(*args, dout, d=d)
    row["b4_vs_plain"] = _rel(d_f, want[5])
    row["b5_vs_plain"] = _rel(dfeat, want[4])
    row["b6_vs_plain"] = max(_rel(g, w) for g, w in zip(geo, want[:4]))
    del want
    row["same_bits_twice"] = (torch.equal(out, cck.contconv_collect(*args, d=d)) and
                              torch.equal(d_f, cck.contconv_bwd_filters(*args, dout, d=d)) and
                              torch.equal(dfeat, cck.contconv_bwd_feat(*args, dout, d=d)) and
                              all(torch.equal(a, b) for a, b in
                                  zip(geo, cck.contconv_bwd_geom(*args, dout, d=d))))
    if digests is not None:
        key, mine = f"{n}_{d}", {"b3": _digest(out), "b4": _digest(d_f), "b5": _digest(dfeat)}
        if key in digests:
            row["bits_equal_saved"] = {b: mine[b] == digests[key][b] for b in mine}
        else:
            digests[key] = mine
    del out, d_f, dfeat, geo
    row["b6_bound_ms"], row["b6_bound_by"] = b6_bound_ms(gxyz, win, width, width, d)

    row["plan_ms"] = _ms(lambda: cck.pair_plan(*gxyz, win, d=d), dev, reps)
    row["bins_ms"] = _ms(lambda: bins(plan, *gxyz, win, fj, d), dev, reps)
    row["b3_ms"] = _ms(lambda: cck.contconv_collect(*args, d=d), dev, reps)
    row["b4_ms"] = _ms(lambda: cck.contconv_bwd_filters(*args, dout, d=d), dev, reps)
    row["dg_ms"] = _ms(dg_step, dev, reps)
    row["unbins_ms"] = _ms(lambda: unbins_step(dg), dev, reps)
    row["b5_ms"] = _ms(lambda: cck.contconv_bwd_feat(*args, dout, d=d), dev, reps)
    row["b6_ms"] = _ms(lambda: cck.contconv_bwd_geom(*args, dout, d=d), dev, reps)
    if cuda:
        for key, fn in (("b3", lambda: cck.contconv_collect(*args, d=d)),
                        ("b4", lambda: cck.contconv_bwd_filters(*args, dout, d=d)),
                        ("b5", lambda: cck.contconv_bwd_feat(*args, dout, d=d)),
                        ("b6", lambda: cck.contconv_bwd_geom(*args, dout, d=d))):
            busy, top = profile_ms(fn, dev, top=8)
            row[f"{key}_busy_ms"] = busy
            row[f"{key}_rows_ms"] = {name[:48]: ms for name, ms in top}
        events = timing.kernel_events(lambda: cck.contconv_bwd_geom(*args, dout, d=d), reps)
        geom = [t for name, t in events if "bwd_geom" in name]
        row["b6_device_ms"] = sum(t for _, t in events) / reps
        row["b6_kernels_a_call"] = len(events) / reps
        row["b6_geometry_pass_device_ms"] = sum(geom) / max(len(geom), 1)
        nitems = cck._item_rows(plan.cell_r.numel(), d ** 3)[1]  # B4: a partial bank an item
        # B5: the dG rows (the bins' buffer in a backward that runs B4 too)
        # and the transposed bank
        row["scratch_bytes"] = {"plan": sum(t.numel() * t.element_size() for t in plan),
                                "bins": dg.numel() * 4, "products": dg.numel() * 4,
                                "partial_banks": nitems * width * width * 4,
                                "dg": dg.numel() * 4, "bank_transposed": ft.numel() * 4}
    return row


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-bodies", type=int, nargs="+", default=[100_000])
    p.add_argument("--d", type=int, nargs="+", default=[6, 4])
    p.add_argument("--neighbors", type=int, default=32)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (the CPU only as --device cpu)")
    p.add_argument("--digests", default=None,
                   help="JSON file of output digests: written by the first run, compared "
                        "by the later ones")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    digests = None
    if args.digests:
        digests = {}
        if os.path.exists(args.digests):
            with open(args.digests) as f:
                digests = json.load(f)
    rows = []
    for n in args.n_bodies:
        for d in args.d:
            rows.append(bench(n, d, args.neighbors, args.width, dev, digests=digests))
            print(json.dumps(rows[-1]), flush=True)
    if args.digests:
        with open(args.digests, "w") as f:
            json.dump(digests, f)
    return rows


if __name__ == "__main__":
    main()
