"""Continuous-convolution collect and its backward — the port of
``nbody_tpu/ops/contconv_kernel.py``.

:func:`contconv_collect` computes, per receiver m,

    out[m] = sum_e window[m, e] * feat_j[m, e] @ T(F at (gx, gy, gz)[m, e])

with T the trilinear interpolation of the (D^3, ci, co) filter bank at the
edge's grid coordinates (clamped to [0, D - 1]); the sum over edges, the
mean left to the caller. For CUDA tensors it launches B3, hand-written CUDA
in ``nbody_tpu_torch/csrc/contconv.cu`` that replaces the Pallas
``_collect_kernel``; for CPU tensors it runs the plain-torch twin
:func:`contconv_collect_torch`, which is also the ``impl="dense"`` layer of
``models/contconv.py``.

On the card B3, B4 and B5 run over one (receiver, cell) pair plan
(:func:`pair_plan`): the distinct cells each receiver's live corners touch,
listed cell-major with receivers ascending inside a cell (four launches: the
receivers' cell masks, their prefix sum, the cells' counts, every pair's
place). A bin kernel then reads every live edge's feature row once and
writes the compacted bins ``g[pair]``; B3 multiplies each cell's contiguous
rows by that cell of the bank and adds a receiver's products in cell order,
B4 multiplies their transpose by the gathered ``dout`` rows. B5 runs the
same grouped product on the ``dout`` rows gathered by receiver and the bank
transposed (``dG[pair]``), then the bins backwards: per edge the
corner-weighted sum of its pairs' dG rows, each ``dfeat`` row written once.
The plan's plain version (:func:`pair_plan_torch`) and the plain passes
over a plan (:func:`pair_bins_torch`, :func:`pair_collect_torch`,
:func:`pair_filter_grad_torch`, :func:`pair_dg_torch`,
:func:`pair_unbins_torch`) hold that rule without a card.

The gradient is a ``torch.autograd.Function`` that saves its inputs only,
as the JAX custom VJP does (the backward rebuilds one plan for B4, B5 and
B6, and one (rows, round4(ci)) buffer holds B4's bins and then the dG rows
that B5 and B6 both read), and whose backward launches, on the card, the
kernels of the Pallas ``_collect_bwd_rule``:

- B4 :func:`contconv_bwd_filters` (``_bwd_filters_kernel``) when the
  filters need a gradient,
- B5 :func:`contconv_bwd_feat` (``_bwd_feat_kernel``) when ``feat_j`` does,
- B6 :func:`contconv_bwd_geom` (``_bwd_geom_kernel``) only when a geometry
  input (gx, gy, gz, window) does: parameter-only training never launches
  it, as XLA drops the unused JAX call. B6 runs over a plan that keeps the
  edges of zero window (``pair_plan(all_edges=True)``: the window's
  cotangent does not vanish there), the dG rows of B5's product, and a
  geometry pass that forms each (edge, live corner)'s feature . dG dot
  (plain version :func:`pair_geom_torch`); a backward that wants it builds
  that plan for B4 and B5 as well.

On the CPU each of them runs its part of :func:`contconv_collect_bwd_torch`,
the plain backward. Every wrapper counts its launches in
``<wrapper>.launches``: one per call (or per backward it serves), however
many kernels the call runs; B3, B4 and B5 also by filter resolution, in
``<wrapper>.launches_by_d``.

The caller gathers ``feat_j`` (M, k, ci) itself, as the JAX layer does (1.6
GB at 100k bodies, k = 32, ci = 128, which the card holds). B3 and B4 read
each live edge's row once, B5 writes each once; their scratch is the plan
(10 bytes a pair), the bins or B5's dG rows and, for B3, the products
(``round4(ci)`` and ``round4(co)`` floats a pair), and B4's partial banks,
one (ci, co) bank a work item. The scratch
is sized without asking the device where the most pairs the shape can have,
M min(8k, D^3), keep bins and products under ``_NO_READ_BYTES`` (a few
thousand receivers: launches so short that a wait would leave the card idle
while the host catches up); above that from the pair count read on the host,
the call's one wait (B4 and B5 in a backward take the row count from its
forward; a backward with B6 reads its own plan's). B6 reads each feature row
once.

The kernels take any k, ci and co, and d >= 2 with d^3 <= 32767 (the plan
keeps a cell in 16 bits), where one warp's tables (its receiver's cell ->
row table, 2 d^3 bytes, and a row per edge corner) fit the card's shared
memory; a launch raises ``RuntimeError`` on another shape.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import torch

from nbody_tpu_torch.ops import build
from nbody_tpu_torch.ops.interpolate import trilinear_corners

# elements of one (rows, D^3, ci) bin slab in the twins
_TWIN_ELEMS = 1 << 25
# B3's and B4's products run over work items of a cell's pair rows: about
# this many items (16 waves of one resident block on 132 SMs), of at least
# _ITEM_ROWS rows each, a multiple of the kernels' row tiles (128 and 64)
_PRODUCT_ITEMS = 2112
_ITEM_ROWS = 512
# bins plus products of the most pairs a shape can have, in bytes, up to
# which the plan is sized by that bound and the host never waits for the
# pair count
_NO_READ_BYTES = 2 << 30

_LIB: Optional[ctypes.CDLL] = None

_LIMITS = ("the kernels take d >= 2 with d^3 <= 32767 and any k, ci and co, within "
           "227 KB of shared memory a block")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load_library("contconv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.contconv_plan_masks.argtypes = [ptr] * 4 + [i32] * 4 + [ptr] * 4
        lib.contconv_plan_cells.argtypes = [ptr] * 2 + [i32] * 3 + [ptr] * 7
        lib.contconv_pair_bins.argtypes = [ptr] * 8 + [i32] * 4 + [ptr] * 2
        lib.contconv_pair_unbins.argtypes = [ptr] * 8 + [i32] * 4 + [ptr] * 2
        lib.contconv_pair_product.argtypes = [ptr] * 5 + [i32] * 5 + [ptr] * 2
        lib.contconv_row_sum.argtypes = [ptr] * 3 + [i32] * 2 + [ptr] * 2
        lib.contconv_bwd_filters.argtypes = [ptr] * 5 + [i32] * 5 + [ptr] * 3
        lib.contconv_pair_geom.argtypes = [ptr] * 9 + [i32] * 4 + [ptr] * 5
        for fn in (lib.contconv_plan_masks, lib.contconv_plan_cells,
                   lib.contconv_pair_bins, lib.contconv_pair_unbins,
                   lib.contconv_pair_product, lib.contconv_row_sum,
                   lib.contconv_bwd_filters, lib.contconv_pair_geom):
            fn.restype = i32
        _LIB = lib
    return _LIB


def contconv_collect_torch(gx, gy, gz, window, feat_j, filters, *, d: int):
    """Plain-torch twin of B3: per edge a corner-weight row over the D^3
    cells (scatter of the 8 trilinear weights), bins g = onehot^T @
    (window * feat_j), then one product with the flattened filter bank. Row
    chunks bound the (rows, D^3, ci) bins. Full float32 on the card: TF32
    matmuls must be off."""
    m, k = window.shape
    z, ci, co = filters.shape
    f_flat = filters.reshape(z * ci, co)
    rows = max(1, _TWIN_ELEMS // (z * max(ci, k)))
    outs = []
    for r0 in range(0, m, rows):
        sl = slice(r0, r0 + rows)
        mc = window[sl].shape[0]
        coords = torch.stack([gx[sl], gy[sl], gz[sl]], dim=-1).reshape(-1, 3)
        cidx, cw = trilinear_corners(coords, d)
        oh = torch.zeros((mc * k, z), dtype=cw.dtype, device=cw.device)
        oh = oh.scatter_add(1, cidx.long(), cw).reshape(mc, k, z)
        wf = feat_j[sl] * window[sl, :, None]
        g = torch.bmm(oh.transpose(1, 2), wf)  # (mc, D^3, ci)
        outs.append(g.reshape(mc, z * ci) @ f_flat)
    if not outs:
        return torch.zeros((0, co), dtype=filters.dtype, device=filters.device)
    return torch.cat(outs)


def _edge_corners(gx, gy, gz, d):
    """Per edge its 8 corner cells (x, y, z order), their trilinear weights,
    the weights' derivatives along x, y and z, and which corners are live
    (each of the three axis weights non-zero), each (rows, k, 8). The
    derivative of an axis weight is JAX's ``_dtent``: -1 / +1 for the lower
    / upper corner where the fraction lies in (0, 1), else 0 (integer and
    clamped coordinates)."""
    c = torch.stack([gx, gy, gz], dim=-1).clamp(0.0, d - 1)
    lo = torch.clamp(torch.floor(c), max=d - 2)
    f = c - lo
    lo = lo.long()
    inside = ((f > 0) & (f < 1)).to(f.dtype)
    w_ax = (1.0 - f, f)
    dw_ax = (-inside, inside)
    live_ax = (f != 1, f != 0)
    cells, ws, dws, lives = [], [], ([], [], []), []
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                o = (ox, oy, oz)
                cells.append(((lo[..., 0] + ox) * d + lo[..., 1] + oy) * d + lo[..., 2] + oz)
                w = [w_ax[o[a]][..., a] for a in range(3)]
                ws.append(w[0] * w[1] * w[2])
                lives.append(live_ax[ox][..., 0] & live_ax[oy][..., 1] & live_ax[oz][..., 2])
                for a in range(3):
                    terms = [dw_ax[o[b]][..., b] if b == a else w[b] for b in range(3)]
                    dws[a].append(terms[0] * terms[1] * terms[2])
    return (torch.stack(cells, -1), torch.stack(ws, -1),
            tuple(torch.stack(x, -1) for x in dws), torch.stack(lives, -1))


def contconv_collect_bwd_torch(gx, gy, gz, window, feat_j, filters, dout, *, d: int,
                               need=(True,) * 6):
    """Plain backward of the collect (B4-B6 together): the cotangents
    (dgx, dgy, dgz, dwindow, dfeat_j, dfilters) of :func:`contconv_collect`
    for the output cotangent ``dout`` (M, co). ``need`` says which inputs
    want one (the order above); the others come back as None, and the
    geometry four are computed together when any of them is needed.

    With dG[m, cell] = F_cell @ dout[m] and s = feat_j[m, e] . dG[m, cell]:
    dF = g^T dout (g the bins of the forward); dfeat = window * sum_corners
    w dG; dwindow = sum_corners w s; dgx = window * sum_corners (dw/dgx) s,
    and so for y and z, with JAX's tent' convention (:func:`_edge_corners`).
    Row chunks bound the (rows, D^3, ci) intermediates."""
    m, k = window.shape
    z, ci, co = filters.shape
    geom, want_feat, want_f = any(need[:4]), need[4], need[5]
    f_flat = filters.reshape(z * ci, co)
    dev, dt = window.device, window.dtype
    d_f = torch.zeros((z * ci, co), dtype=dt, device=dev) if want_f else None
    dfeat, dgeo = [], [[], [], [], []]
    rows = max(1, _TWIN_ELEMS // (z * (ci + k)))
    for r0 in range(0, m, rows):
        sl = slice(r0, r0 + rows)
        mc = window[sl].shape[0]
        win, fj, dsl = window[sl], feat_j[sl], dout[sl]
        cell, w, (dwx, dwy, dwz), _ = _edge_corners(gx[sl], gy[sl], gz[sl], d)
        oh = torch.zeros((mc, k, z), dtype=dt, device=dev).scatter_add(2, cell, w)
        if want_f:
            g = torch.bmm(oh.transpose(1, 2), fj * win[..., None])  # (mc, D^3, ci)
            d_f += g.reshape(mc, z * ci).T @ dsl
        if not (want_feat or geom):
            continue
        dg = (dsl @ f_flat.T).reshape(mc, z, ci)  # dG[m, cell, :]
        if want_feat:
            dfeat.append(torch.bmm(oh, dg) * win[..., None])
        if geom:
            s = torch.bmm(fj, dg.transpose(1, 2)).gather(2, cell)  # (mc, k, 8)
            dgeo[0].append(win * (dwx * s).sum(-1))
            dgeo[1].append(win * (dwy * s).sum(-1))
            dgeo[2].append(win * (dwz * s).sum(-1))
            dgeo[3].append((w * s).sum(-1))

    def cat(parts, shape):
        return torch.cat(parts) if parts else torch.zeros(shape, dtype=dt, device=dev)

    geo = (tuple(cat(p, (m, k)) for p in dgeo) if geom else (None,) * 4)
    return (*geo, cat(dfeat, (m, k, ci)) if want_feat else None,
            d_f.reshape(z, ci, co) if want_f else None)


class PairPlan(NamedTuple):
    """The distinct (receiver, cell) pairs of one geometry, P of them: the
    cells that a receiver's live corners touch. An edge is live when its
    window is non-zero (in B6's plan, ``all_edges``, always), a corner when
    each of its three axis weights is. Receiver-major, a receiver's pairs are
    rows ``rstart[m] : rstart[m + 1]``, cells ascending; cell-major, a
    cell's pairs are rows ``coff[c] : coff[c + 1]``, receivers ascending.
    The bins and B3's products are stored cell-major."""

    rstart: torch.Tensor   # (M + 1,) int32
    cell_r: torch.Tensor   # (P,) int16, the cell of each receiver-major row
    slot_of: torch.Tensor  # (P,) int32, receiver-major row -> cell-major row
    recv_of: torch.Tensor  # (P,) int32, the receiver of each cell-major row
    coff: torch.Tensor     # (D^3 + 1,) int32

    # A plan sized by a bound (on the card) has more rows than pairs: the P
    # pairs come first in either order (``rstart[-1] == coff[-1] == P``),
    # the spare rows belong to no receiver and no cell and are never read.


def _live_corners(gx, gy, gz, window, d, all_edges=False):
    """Per edge corner its cell, weight and whether it adds anything, each
    (M, k, 8); with ``all_edges`` a corner of an edge of zero window counts
    too."""
    if d < 2:
        raise ValueError(f"the pair plan needs d >= 2, got {d}")
    cell, w, _, live = _edge_corners(gx, gy, gz, d)
    return cell, w, live if all_edges else live & (window != 0)[..., None]


def pair_plan_torch(gx, gy, gz, window, *, d: int, all_edges: bool = False) -> PairPlan:
    """Plain version of the plan kernels: the pairs are the distinct
    (receiver, cell) keys of the live corners, in key order (``all_edges``:
    of every edge, B6's plan). Index preparation by torch calls, as the
    Morton sort in ``ops/spatial.py``."""
    m = window.shape[0]
    z = d ** 3
    cell, _, live = _live_corners(gx, gy, gz, window, d, all_edges)
    recv = torch.arange(m, device=window.device)[:, None, None].expand_as(cell)
    keys = torch.unique(recv[live] * z + cell[live])  # sorted
    recv_r = torch.div(keys, z, rounding_mode="floor").int()
    rstart = torch.zeros(m + 1, dtype=torch.int32, device=window.device)
    rstart[1:] = torch.cumsum(torch.bincount(recv_r, minlength=m), 0)
    # cell-major: a stable sort by cell keeps the receivers ascending
    cells, perm = torch.sort((keys % z).to(torch.int16), stable=True)
    slot_of = torch.empty(keys.numel(), dtype=torch.int32, device=window.device)
    slot_of[perm] = torch.arange(keys.numel(), dtype=torch.int32, device=window.device)
    coff = torch.searchsorted(cells, torch.arange(z + 1, dtype=cells.dtype,
                                                  device=window.device), out_int32=True)
    return PairPlan(rstart, (keys % z).to(torch.int16), slot_of, recv_r[perm], coff)


def _pair_rows(plan: PairPlan, recv, cell, z: int):
    """The cell-major rows in ``plan`` of the pairs (recv, cell)."""
    m = plan.rstart.numel() - 1
    p = int(plan.rstart[-1])
    counts = (plan.rstart[1:] - plan.rstart[:-1]).long()
    recv_r = torch.repeat_interleave(torch.arange(m, device=recv.device), counts)
    row = torch.searchsorted(recv_r * z + plan.cell_r[:p].long(), recv * z + cell)
    return plan.slot_of[row].long()


def _corner_rows(plan: PairPlan, gx, gy, gz, window, d: int):
    """Every live corner of the geometry as (receiver, edge, window * corner
    weight, the cell-major row of its pair in ``plan``)."""
    cell, w, live = _live_corners(gx, gy, gz, window, d)
    recv, edge, corner = live.nonzero(as_tuple=True)
    return (recv, edge, window[recv, edge] * w[recv, edge, corner],
            _pair_rows(plan, recv, cell[live], d ** 3))


def pair_bins_torch(plan: PairPlan, gx, gy, gz, window, feat_j, *, d: int):
    """Plain version of the bin kernel: g (P, ci), row ``s`` the sum of
    window * corner weight * feature over the live corners of pair ``s``
    (cell-major)."""
    recv, edge, wt, row = _corner_rows(plan, gx, gy, gz, window, d)
    g = torch.zeros((plan.cell_r.numel(), feat_j.shape[2]), dtype=feat_j.dtype,
                    device=feat_j.device)
    return g.index_add_(0, row, wt[:, None] * feat_j[recv, edge])


def pair_unbins_torch(plan: PairPlan, dg, gx, gy, gz, window, *, d: int):
    """Plain version of B5's unbin pass, the bins run backwards: dfeat (M,
    k, ci), row (m, e) the sum of window * corner weight * ``dg`` row of the
    corner's pair over the edge's live corners (zeros for a dead edge)."""
    m, k = window.shape
    recv, edge, wt, row = _corner_rows(plan, gx, gy, gz, window, d)
    out = torch.zeros((m * k, dg.shape[1]), dtype=dg.dtype, device=dg.device)
    return out.index_add_(0, recv * k + edge, wt[:, None] * dg[row]).reshape(m, k, -1)


def pair_geom_torch(plan: PairPlan, dg, gx, gy, gz, window, feat_j, *, d: int):
    """Plain version of B6's geometry pass over a plan that keeps the edges
    of zero window (``pair_plan(..., all_edges=True)``) and its dG rows
    (:func:`pair_dg_torch`): for every edge, dead ones included, and each
    live corner, s = feat_j[m, e] . dg[row of the corner's pair]; then dwindow
    = sum w s and dgx = sum (dtent_x wy wz) (window s), and so for y and z,
    over the edge's live corners (JAX's tent', :func:`_edge_corners`).
    Returns (dgx, dgy, dgz, dwindow), each (M, k). Corners in chunks bound
    the gathered rows."""
    m, k = window.shape
    cell, w, dws, live = _edge_corners(gx, gy, gz, d)
    recv, edge, corner = live.nonzero(as_tuple=True)
    rows = _pair_rows(plan, recv, cell[live], d ** 3)
    out = torch.zeros((4, m * k), dtype=dg.dtype, device=dg.device)
    step = max(1, _TWIN_ELEMS // max(feat_j.shape[2], 1))
    for a in range(0, recv.numel(), step):
        r, e, c = recv[a:a + step], edge[a:a + step], corner[a:a + step]
        s = (feat_j[r, e] * dg[rows[a:a + step]]).sum(-1)
        ws = window[r, e] * s
        terms = torch.stack([dws[0][r, e, c] * ws, dws[1][r, e, c] * ws,
                             dws[2][r, e, c] * ws, w[r, e, c] * s])
        out.index_add_(1, r * k + e, terms)
    return tuple(out.reshape(4, m, k))


def _cell_rows(plan: PairPlan):
    """(cell, first row, end row) of every cell that has pairs."""
    coff = plan.coff.tolist()
    return [(c, a, b) for c, (a, b) in enumerate(zip(coff[:-1], coff[1:])) if b > a]


def pair_collect_torch(plan: PairPlan, g, filters, m: int):
    """Plain version of B3's product and row sum over a plan: each cell's
    bin rows times that cell of the bank, then every receiver's products
    added up; (M, co)."""
    y = torch.empty((g.shape[0], filters.shape[2]), dtype=g.dtype, device=g.device)
    for c, a, b in _cell_rows(plan):
        y[a:b] = g[a:b] @ filters[c]
    out = torch.zeros((m, filters.shape[2]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, plan.recv_of.long(), y)


def pair_filter_grad_torch(plan: PairPlan, g, dout, z: int):
    """Plain version of B4's product over a plan: dF[cell] = the cell's bin
    rows transposed times the ``dout`` rows of their receivers; (D^3, ci,
    co)."""
    d_f = torch.zeros((z, g.shape[1], dout.shape[1]), dtype=g.dtype, device=g.device)
    for c, a, b in _cell_rows(plan):
        d_f[c] = g[a:b].T @ dout[plan.recv_of[a:b].long()]
    return d_f


def pair_dg_torch(plan: PairPlan, dout, filters):
    """Plain version of B5's product over a plan: dG (P, ci), row ``s`` the
    ``dout`` row of the pair's receiver times its cell of the bank
    transposed, dG[s] = F[cell] @ dout[recv_of[s]]."""
    dg = torch.zeros((plan.cell_r.numel(), filters.shape[1]), dtype=dout.dtype,
                     device=dout.device)
    for c, a, b in _cell_rows(plan):
        dg[a:b] = dout[plan.recv_of[a:b].long()] @ filters[c].T
    return dg


def _check_all(gx, gy, gz, window, feat_j, filters, d, dout=None):
    m, k = window.shape
    z, ci, co = filters.shape
    for name, t in zip(("gx", "gy", "gz", "window"), (gx, gy, gz, window)):
        build.check(name, t, (m, k))
    build.check("feat_j", feat_j, (m, k, ci))
    build.check("filters", filters, (d * d * d, ci, co))
    if dout is not None:
        build.check("dout", dout, (m, co))


def _f_transposed(filters):
    """F^T as (D^3 * co, round4(ci)) rows, zero pad columns: the kernels
    read 16-byte vectors of 4 consecutive columns."""
    z, ci, co = filters.shape
    ft = filters.transpose(1, 2).reshape(z * co, ci)
    if ci % 4:
        ft = torch.nn.functional.pad(ft, (0, 4 - ci % 4))
    return ft.contiguous()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _count(wrapper, d: int) -> None:
    """One launch of B3, B4 or B5, also under its filter resolution (a
    model's layers differ in it)."""
    wrapper.launches += 1
    wrapper.launches_by_d[d] += 1


def _item_rows(p: int, z: int):
    """The rows of a work item of the grouped products for a plan of ``p``
    rows, and an upper bound of the item count (the grid: the true count
    stays on the device)."""
    rows = max(_ITEM_ROWS, -(-p // (_PRODUCT_ITEMS * _ITEM_ROWS)) * _ITEM_ROWS)
    return rows, p // rows + z


def _work_items(plan: PairPlan, z: int):
    """The grouped products' work items: every cell's pair rows cut into
    pieces of at most ``rows`` rows, so that the blocks' work is even however
    uneven the cells are. Returns the cells' first items ``istart`` (z + 1,
    int32), ``rows`` and the bound of the item count. Plain version of what
    plan_cells_kernel writes on the card."""
    rows, bound = _item_rows(plan.cell_r.numel(), z)
    n_c = plan.coff[1:] - plan.coff[:-1]
    istart = torch.zeros(z + 1, dtype=torch.int32, device=plan.coff.device)
    istart[1:] = torch.cumsum((n_c + (rows - 1)) // rows, 0)
    return istart, rows, bound


def _plan_rows(m: int, k: int, d: int, ci: int, co: int) -> Optional[int]:
    """The rows to give a plan without asking the device for its pair count:
    the most pairs the shape can have, where bins and products of that many
    rows stay under ``_NO_READ_BYTES``; else None (the count is read)."""
    most = m * min(8 * k, d ** 3)
    width = -(-ci // 4) * 4 + -(-co // 4) * 4
    return most if 4 * most * width <= _NO_READ_BYTES else None


def _plan_cuda(gx, gy, gz, window, d: int, rows: Optional[int] = None,
               all_edges: bool = False):
    """The plan on the card and its work items, ``(PairPlan, (istart, item
    rows, item bound))``: masks and counts (plan_masks_kernel), their prefix
    sum, then the cells' counts and every pair's place
    (plan_cell_counts_kernel, plan_cells_kernel). The lists have ``rows``
    rows, which must hold every pair (:func:`_plan_rows`, or the rows of an
    earlier plan of the same geometry and ``all_edges``); with None the pair
    count is read on the host here, the call's one wait for the device.
    ``all_edges`` keeps the edges of zero window (B6's plan)."""
    m, k = window.shape
    dev = window.device
    z = d ** 3
    lib = _lib()

    def ints(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    masks, counts, cell_counts = ints(m, -(-z // 32)), ints(m + 1), ints(z)
    what = f"contconv plan launch (d={d}, k={k}; {_LIMITS})"
    with torch.cuda.device(dev):
        rc = lib.contconv_plan_masks(gx.data_ptr(), gy.data_ptr(), gz.data_ptr(),
                                     window.data_ptr(), m, k, d, int(all_edges),
                                     masks.data_ptr(), counts.data_ptr(),
                                     cell_counts.data_ptr(), _stream())
    build.raise_on(rc, what)
    rstart = torch.cumsum(counts, 0, dtype=torch.int32)
    p = int(rstart[-1]) if rows is None else rows
    plan = PairPlan(rstart, ints(p, dtype=torch.int16), ints(p), ints(p), ints(z + 1))
    istart = ints(z + 1)
    item_rows, bound = _item_rows(p, z)
    with torch.cuda.device(dev):
        rc = lib.contconv_plan_cells(masks.data_ptr(), rstart.data_ptr(), m, d, item_rows,
                                     cell_counts.data_ptr(), plan.cell_r.data_ptr(),
                                     plan.slot_of.data_ptr(), plan.recv_of.data_ptr(),
                                     plan.coff.data_ptr(), istart.data_ptr(), _stream())
    build.raise_on(rc, what)
    return plan, (istart, item_rows, bound)


def pair_plan(gx, gy, gz, window, *, d: int, all_edges: bool = False) -> PairPlan:
    """The (receiver, cell) pair plan of B3-B5 for (M, k) float32 geometry
    (``all_edges``: B6's, which keeps the edges of zero window): the plan
    kernels for CUDA tensors, :func:`pair_plan_torch` on the CPU."""
    if build.on_cpu(gx, gy, gz, window):
        return pair_plan_torch(gx, gy, gz, window, d=d, all_edges=all_edges)
    for name, t in zip(("gx", "gy", "gz", "window"), (gx, gy, gz, window)):
        build.check(name, t, tuple(window.shape))
    return _plan_cuda(gx, gy, gz, window, d, all_edges=all_edges)[0]


def _bins_cuda(plan: PairPlan, gx, gy, gz, window, feat_j, d: int):
    """g (P, round4(ci)) from the bin kernel, pad columns zero."""
    m, k, ci = feat_j.shape
    g = torch.empty((plan.cell_r.numel(), -(-ci // 4) * 4), dtype=torch.float32,
                    device=window.device)
    with torch.cuda.device(window.device):
        rc = _lib().contconv_pair_bins(
            gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), window.data_ptr(),
            feat_j.data_ptr(), plan.rstart.data_ptr(), plan.cell_r.data_ptr(),
            plan.slot_of.data_ptr(), m, k, ci, d, g.data_ptr(), _stream())
    build.raise_on(rc, f"contconv bins launch (d={d}, k={k}, ci={ci}; {_LIMITS})")
    return g


def _unbins_cuda(plan: PairPlan, dg, gx, gy, gz, window, d: int, out):
    """B5's unbin pass into ``out`` (M, k, ci) from dG (rows, round4(ci))."""
    m, k, ci = out.shape
    with torch.cuda.device(window.device):
        rc = _lib().contconv_pair_unbins(
            gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), window.data_ptr(), dg.data_ptr(),
            plan.rstart.data_ptr(), plan.cell_r.data_ptr(), plan.slot_of.data_ptr(), m, k,
            ci, d, out.data_ptr(), _stream())
    build.raise_on(rc, f"contconv unbin launch (d={d}, k={k}, ci={ci}; {_LIMITS})")
    return out


def _geom_cuda(plan: PairPlan, dg, gx, gy, gz, window, feat_j, d: int):
    """B6's geometry pass, (dgx, dgy, dgz, dwindow) each (M, k), from dG
    (rows, round4(ci)) over a plan that keeps the edges of zero window."""
    m, k, ci = feat_j.shape
    outs = [torch.empty((m, k), dtype=torch.float32, device=window.device)
            for _ in range(4)]
    with torch.cuda.device(window.device):
        rc = _lib().contconv_pair_geom(
            gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), window.data_ptr(),
            feat_j.data_ptr(), dg.data_ptr(), plan.rstart.data_ptr(), plan.cell_r.data_ptr(),
            plan.slot_of.data_ptr(), m, k, ci, d, *(o.data_ptr() for o in outs), _stream())
    build.raise_on(rc, f"contconv_bwd_geom launch (d={d}, k={k}, ci={ci}; {_LIMITS})")
    return tuple(outs)


def _padded_rows(x):
    """(rows, n) float32 as rows of round4(n) floats at a 16-byte aligned
    base, pad columns zero: the grouped product reads 16-byte vectors. A
    copy only where ``x`` is not so already."""
    n = x.shape[1]
    if n % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros((x.shape[0], -(-n // 4) * 4))
    out[:, :n] = x
    return out


def _product_cuda(a, gather, bank, plan: PairPlan, items, kd: int, nd: int, d: int,
                  out=None):
    """The grouped product over the plan's cell-major rows, (rows, round4(nd)):
    row s is A[s] (``a``'s row s, or its row recv_of[s] with ``gather``)
    times the pair's cell of ``bank`` (D^3 * kd, round4(nd)). ``out``, when
    given, is a buffer of that shape to write into."""
    istart, rows, nitems = items
    if out is None:
        out = torch.empty((plan.cell_r.numel(), -(-nd // 4) * 4), dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        rc = _lib().contconv_pair_product(
            a.data_ptr(), plan.recv_of.data_ptr() if gather else None, bank.data_ptr(),
            plan.coff.data_ptr(), istart.data_ptr(), kd, nd, d, rows, nitems,
            out.data_ptr(), _stream())
    build.raise_on(rc, f"contconv grouped product launch (d={d}, kd={kd}, nd={nd}; "
                       f"{_LIMITS})")
    return out


def _launch(gx, gy, gz, window, feat_j, filters, d):
    """B3 on the card: plan, bins, the grouped product y = g @ F_cell and
    the receivers' row sums. Returns the output and the plan's rows."""
    m, k = window.shape
    z, ci, co = filters.shape
    out = torch.empty((m, co), dtype=torch.float32, device=window.device)
    if m == 0:
        return out, 0
    plan, items = _plan_cuda(gx, gy, gz, window, d, _plan_rows(m, k, d, ci, co))
    _count(contconv_collect, d)
    rows_p = plan.cell_r.numel()
    if rows_p == 0:
        return out.zero_(), 0
    g = _bins_cuda(plan, gx, gy, gz, window, feat_j, d)
    y = _product_cuda(g, False, _padded_rows(filters.reshape(z * ci, co)), plan, items,
                      ci, co, d)
    with torch.cuda.device(window.device):
        rc = _lib().contconv_row_sum(y.data_ptr(), plan.rstart.data_ptr(),
                                     plan.slot_of.data_ptr(), m, co, out.data_ptr(),
                                     _stream())
    build.raise_on(rc, f"contconv_collect launch (d={d}, k={k}, ci={ci}, co={co}; "
                       f"{_LIMITS})")
    return out, rows_p


def _backward_cuda(gx, gy, gz, window, feat_j, filters, dout, d: int, want_feat: bool,
                   want_f: bool, want_geom: bool = False, plan_rows: Optional[int] = None):
    """B4, B5 and/or B6 on the card over one plan of the geometry, ``(dfeat,
    dF, (dgx, dgy, dgz, dwindow))`` (None for what is not wanted). The plan
    keeps the edges of zero window where B6 is wanted; it has ``plan_rows``
    rows (the forward's, which hold only for a plan without them), else the
    shape's bound or the device's count (:func:`_plan_rows`). B4: the bins,
    then dF[cell] = G_cell^T dout[receivers] over work items whose partial
    banks are summed in item order. B5 and B6: dG = dout[receivers] @
    F_cell^T over the same work items, written into the bins' buffer once
    B4 has read it (one (rows, round4(ci)) buffer for all three); then B5's
    unbin pass and B6's geometry pass each read it. Each wrapper served
    counts one launch."""
    m, k = window.shape
    z, ci, co = filters.shape
    dev = window.device
    dfeat = torch.empty((m, k, ci), dtype=torch.float32, device=dev) if want_feat else None
    d_f = torch.empty((z, ci, co), dtype=torch.float32, device=dev) if want_f else None
    geo = (tuple(torch.zeros((m, k), dtype=torch.float32, device=dev) for _ in range(4))
           if want_geom else None)
    if m == 0:
        return dfeat, None if d_f is None else d_f.zero_(), geo
    if want_geom or plan_rows is None:
        plan_rows = _plan_rows(m, k, d, ci, co)
    plan, items = _plan_cuda(gx, gy, gz, window, d, plan_rows, all_edges=want_geom)
    for want, wrapper in ((want_f, contconv_bwd_filters), (want_feat, contconv_bwd_feat)):
        if want:
            _count(wrapper, d)
    if want_geom:
        contconv_bwd_geom.launches += 1
    if plan.cell_r.numel() == 0:
        return (*(None if t is None else t.zero_() for t in (dfeat, d_f)), geo)
    buf = None
    if want_f:
        istart, rows, nitems = items
        buf = _bins_cuda(plan, gx, gy, gz, window, feat_j, d)
        partial = torch.empty((nitems, ci, co), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = _lib().contconv_bwd_filters(
                buf.data_ptr(), dout.data_ptr(), plan.coff.data_ptr(),
                plan.recv_of.data_ptr(), istart.data_ptr(), ci, co, d, rows, nitems,
                partial.data_ptr(), d_f.data_ptr(), _stream())
        build.raise_on(rc, f"contconv_bwd_filters launch (d={d}, k={k}, ci={ci}, co={co}; "
                           f"{_LIMITS})")
        del partial
    if want_feat or want_geom:
        buf = _product_cuda(_padded_rows(dout), True, _f_transposed(filters), plan, items,
                            co, ci, d, out=buf)
    if want_feat:
        _unbins_cuda(plan, buf, gx, gy, gz, window, d, dfeat)
    if want_geom:
        geo = _geom_cuda(plan, buf, gx, gy, gz, window, feat_j, d)
    return dfeat, d_f, geo


def contconv_bwd_filters(gx, gy, gz, window, feat_j, filters, dout, *, d: int,
                         plan_rows: Optional[int] = None):
    """B4: the filters' cotangent (D^3, ci, co) of :func:`contconv_collect`
    for ``dout`` (M, co); ``filters`` gives the shape only. On the card:
    plan and bins as in B3, then dF[cell] = G_cell^T dout[receivers] over
    work items whose partial banks are summed in item order (deterministic).
    ``plan_rows``, the rows of this geometry's plan where the caller has them
    (the forward's), spares the plan its wait for the device."""
    if build.on_cpu(gx, gy, gz, window, feat_j, filters, dout):
        return contconv_collect_bwd_torch(gx, gy, gz, window, feat_j, filters, dout, d=d,
                                          need=(False,) * 5 + (True,))[5]
    _check_all(gx, gy, gz, window, feat_j, filters, d, dout)
    return _backward_cuda(gx, gy, gz, window, feat_j, filters, dout, d, False, True,
                          plan_rows=plan_rows)[1]


def contconv_bwd_feat(gx, gy, gz, window, feat_j, filters, dout, *, d: int):
    """B5: the ``feat_j`` cotangent (M, k, ci) of :func:`contconv_collect`
    for ``dout`` (M, co); ``feat_j`` gives the shape only. On the card: the
    plan, dG[pair] = F_cell @ dout[receiver] over its cell-major rows, then
    per edge window * the corner-weighted sum of its pairs' dG rows, each
    element written once (deterministic). Any ci."""
    if build.on_cpu(gx, gy, gz, window, feat_j, filters, dout):
        return contconv_collect_bwd_torch(gx, gy, gz, window, feat_j, filters, dout, d=d,
                                          need=(False,) * 4 + (True, False))[4]
    _check_all(gx, gy, gz, window, feat_j, filters, d, dout)
    return _backward_cuda(gx, gy, gz, window, feat_j, filters, dout, d, True, False)[0]


def contconv_bwd_geom(gx, gy, gz, window, feat_j, filters, dout, *, d: int):
    """B6: the cotangents (dgx, dgy, dgz, dwindow), each (M, k), of
    :func:`contconv_collect` for ``dout`` (M, co), with JAX's tent'
    convention (0 at integer and clamped grid coordinates). On the card: a
    plan that keeps the edges of zero window, B5's product dG[pair] = F_cell
    @ dout[receiver], then per edge and live corner s = feat_j[m, e] .
    dG[pair] and the four cotangents' sums over the corners, each element
    written once (deterministic). Any ci."""
    if build.on_cpu(gx, gy, gz, window, feat_j, filters, dout):
        return contconv_collect_bwd_torch(gx, gy, gz, window, feat_j, filters, dout, d=d,
                                          need=(True,) * 4 + (False, False))[:4]
    _check_all(gx, gy, gz, window, feat_j, filters, d, dout)
    return _backward_cuda(gx, gy, gz, window, feat_j, filters, dout, d, False, False,
                          want_geom=True)[2]


class _Collect(torch.autograd.Function):
    """B3 (the twin on the CPU) with B4-B6 as its backward, each launched
    only for the inputs that need a gradient. Saves the inputs only, and the
    rows of the forward's plan (an integer): the backward rebuilds one plan
    for B4, B5 and B6, without waiting for the device to learn its size
    where B6 is not wanted."""

    @staticmethod
    def forward(ctx, gx, gy, gz, window, feat_j, filters, d):
        ctx.d = d
        ctx.plan_rows = None
        ctx.save_for_backward(gx, gy, gz, window, feat_j, filters)
        if window.is_cuda:
            out, ctx.plan_rows = _launch(gx, gy, gz, window, feat_j, filters, d)
            return out
        return contconv_collect_torch(gx, gy, gz, window, feat_j, filters, d=d)

    @staticmethod
    def backward(ctx, dout):
        args = (*ctx.saved_tensors, dout.contiguous())
        need = ctx.needs_input_grad
        geom = any(need[:4])
        if not (geom or need[4] or need[5]):
            dfeat = d_f = geo = None
        elif dout.is_cuda:  # B4, B5 and B6 on one plan, one buffer
            dfeat, d_f, geo = _backward_cuda(*args, ctx.d, need[4], need[5], geom,
                                             ctx.plan_rows)
        else:
            geo = contconv_bwd_geom(*args, d=ctx.d) if geom else None
            dfeat = contconv_bwd_feat(*args, d=ctx.d) if need[4] else None
            d_f = contconv_bwd_filters(*args, d=ctx.d) if need[5] else None
        geo = geo or (None,) * 4
        return (*(g if n else None for g, n in zip(geo, need[:4])), dfeat, d_f, None)


def contconv_collect(gx, gy, gz, window, feat_j, filters, *, d: int):
    """Fused collect, the port of the JAX ``contconv_collect``;
    differentiable in every input (B4-B6 on the card).

    :param gx, gy, gz: (M, k) float32 per-edge grid coordinates (clamped
        to [0, d - 1] inside).
    :param window: (M, k) float32 edge weights; 0 kills an edge.
    :param feat_j: (M, k, ci) float32 gathered neighbour features.
    :param filters: (d^3, ci, co) float32 flat filter bank.
    :param d: filter grid resolution; the kernels take any k, ci and co and
        d >= 2 with d^3 <= 32767, within their shared memory, and a launch
        raises ``RuntimeError`` on other shapes.
    :return: (M, co) float32, the sum over edges.
    """
    if not build.on_cpu(gx, gy, gz, window, feat_j, filters):
        _check_all(gx, gy, gz, window, feat_j, filters, d)
    return _Collect.apply(gx, gy, gz, window, feat_j, filters, d)


contconv_collect.launches = 0
contconv_collect.launches_by_d = collections.Counter()
contconv_bwd_filters.launches = 0
contconv_bwd_filters.launches_by_d = collections.Counter()
contconv_bwd_feat.launches = 0
contconv_bwd_feat.launches_by_d = collections.Counter()
contconv_bwd_geom.launches = 0
