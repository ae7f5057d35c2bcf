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

The gradient is a ``torch.autograd.Function`` that saves its inputs only,
as the JAX custom VJP does, and whose backward launches, on the card, the
kernels of the Pallas ``_collect_bwd_rule``:

- B4 :func:`contconv_bwd_filters` (``_bwd_filters_kernel``) when the
  filters need a gradient,
- B5 :func:`contconv_bwd_feat` (``_bwd_feat_kernel``) when ``feat_j`` does,
- B6 :func:`contconv_bwd_geom` (``_bwd_geom_kernel``) only when a geometry
  input (gx, gy, gz, window) does: parameter-only training never launches
  it, as XLA drops the unused JAX call.

On the CPU each of them runs its part of :func:`contconv_collect_bwd_torch`,
the plain backward. Every wrapper counts its launches in ``<wrapper>.launches``.

The caller gathers ``feat_j`` (M, k, ci) itself, as the JAX layer does (1.6
GB at 100k bodies, k = 32, ci = 128, which the card holds); the kernels read
each edge's row once for each of its 8 corner cells.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nbody_tpu_torch.ops import build
from nbody_tpu_torch.ops.interpolate import trilinear_corners

# elements of one (rows, D^3, ci) bin slab in the twins
_TWIN_ELEMS = 1 << 25
# B4's target grid, ~4 waves of its 2 resident blocks on 132 SMs: the
# receiver tiles are cut into as many chunks (partial banks) as that needs
_B4_BLOCKS = 1056
_B4_SLAB = 128  # ci rows of B4's dF tile (csrc/contconv.cu SLAB)

_LIB: Optional[ctypes.CDLL] = None

_LIMITS = ("the kernels take 2 <= d <= 10, k <= 64, co <= 128 (and ci <= 128 "
           "for B5/B6) within 227 KB of shared memory")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load_library("contconv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.contconv_collect.argtypes = [ptr] * 6 + [i32] * 5 + [ptr, ptr]
        lib.contconv_bwd_filters.argtypes = [ptr] * 6 + [i32] * 6 + [ptr] * 3
        lib.contconv_bwd_feat.argtypes = [ptr] * 6 + [i32] * 5 + [ptr] * 2
        lib.contconv_bwd_geom.argtypes = [ptr] * 7 + [i32] * 5 + [ptr] * 5
        for fn in (lib.contconv_collect, lib.contconv_bwd_filters,
                   lib.contconv_bwd_feat, lib.contconv_bwd_geom):
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
    """Per edge its 8 corner cells (x, y, z order), their trilinear weights
    and the weights' derivatives along x, y and z, each (rows, k, 8). The
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
    cells, ws, dws = [], [], ([], [], [])
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                o = (ox, oy, oz)
                cells.append(((lo[..., 0] + ox) * d + lo[..., 1] + oy) * d + lo[..., 2] + oz)
                w = [w_ax[o[a]][..., a] for a in range(3)]
                ws.append(w[0] * w[1] * w[2])
                for a in range(3):
                    terms = [dw_ax[o[b]][..., b] if b == a else w[b] for b in range(3)]
                    dws[a].append(terms[0] * terms[1] * terms[2])
    return (torch.stack(cells, -1), torch.stack(ws, -1),
            tuple(torch.stack(x, -1) for x in dws))


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
        cell, w, (dwx, dwy, dwz) = _edge_corners(gx[sl], gy[sl], gz[sl], d)
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


def _launch(gx, gy, gz, window, feat_j, filters, d):
    m, k = window.shape
    z, ci, co = filters.shape
    out = torch.empty((m, co), dtype=torch.float32, device=window.device)
    if m == 0:
        return out
    lib = _lib()
    # the kernel reads F rows as 16-byte vectors: pad co to a multiple of 4
    f_rows = filters.reshape(z * ci, co)
    if co % 4:
        f_rows = torch.nn.functional.pad(f_rows, (0, 4 - co % 4))
    with torch.cuda.device(window.device):
        rc = lib.contconv_collect(
            gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), window.data_ptr(),
            feat_j.data_ptr(), f_rows.data_ptr(), m, k, ci, co, d,
            out.data_ptr(), _stream())
    build.raise_on(rc, f"contconv_collect launch (d={d}, k={k}, ci={ci}, co={co}; {_LIMITS})")
    contconv_collect.launches += 1
    return out


def contconv_bwd_filters(gx, gy, gz, window, feat_j, filters, dout, *, d: int):
    """B4: the filters' cotangent (D^3, ci, co) of :func:`contconv_collect`
    for ``dout`` (M, co); ``filters`` gives the shape only. Deterministic:
    per-chunk partial banks summed in chunk order."""
    if build.on_cpu(gx, gy, gz, window, feat_j, filters, dout):
        return contconv_collect_bwd_torch(gx, gy, gz, window, feat_j, filters, dout, d=d,
                                          need=(False,) * 5 + (True,))[5]
    _check_all(gx, gy, gz, window, feat_j, filters, d, dout)
    m, k = window.shape
    z, ci, co = filters.shape
    dev = window.device
    d_f = torch.empty((z, ci, co), dtype=torch.float32, device=dev)
    if m == 0:
        return d_f.zero_()
    ntiles = -(-m // 64)
    slabs = -(-ci // _B4_SLAB)
    nchunk = max(1, min(ntiles, -(-_B4_BLOCKS // (z * slabs))))
    partial = (torch.empty((nchunk, z, ci, co), dtype=torch.float32, device=dev)
               if nchunk > 1 else None)
    with torch.cuda.device(dev):
        rc = _lib().contconv_bwd_filters(
            gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), window.data_ptr(),
            feat_j.data_ptr(), dout.data_ptr(), m, k, ci, co, d, nchunk,
            None if partial is None else partial.data_ptr(), d_f.data_ptr(), _stream())
    build.raise_on(rc, f"contconv_bwd_filters launch (d={d}, k={k}, ci={ci}, co={co}; "
                       f"{_LIMITS})")
    contconv_bwd_filters.launches += 1
    return d_f


def contconv_bwd_feat(gx, gy, gz, window, feat_j, filters, dout, *, d: int):
    """B5: the ``feat_j`` cotangent (M, k, ci) of :func:`contconv_collect`
    for ``dout`` (M, co); each element has one writer, cells in a fixed
    order."""
    if build.on_cpu(gx, gy, gz, window, feat_j, filters, dout):
        return contconv_collect_bwd_torch(gx, gy, gz, window, feat_j, filters, dout, d=d,
                                          need=(False,) * 4 + (True, False))[4]
    _check_all(gx, gy, gz, window, feat_j, filters, d, dout)
    m, k = window.shape
    z, ci, co = filters.shape
    dfeat = torch.empty((m, k, ci), dtype=torch.float32, device=window.device)
    if m == 0:
        return dfeat
    ft = _f_transposed(filters)
    with torch.cuda.device(window.device):
        rc = _lib().contconv_bwd_feat(
            gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), window.data_ptr(),
            dout.data_ptr(), ft.data_ptr(), m, k, ci, co, d, dfeat.data_ptr(), _stream())
    build.raise_on(rc, f"contconv_bwd_feat launch (d={d}, k={k}, ci={ci}, co={co}; "
                       f"{_LIMITS})")
    contconv_bwd_feat.launches += 1
    return dfeat


def contconv_bwd_geom(gx, gy, gz, window, feat_j, filters, dout, *, d: int):
    """B6: the cotangents (dgx, dgy, dgz, dwindow), each (M, k), of
    :func:`contconv_collect` for ``dout`` (M, co), with JAX's tent'
    convention (0 at integer and clamped grid coordinates)."""
    if build.on_cpu(gx, gy, gz, window, feat_j, filters, dout):
        return contconv_collect_bwd_torch(gx, gy, gz, window, feat_j, filters, dout, d=d,
                                          need=(True,) * 4 + (False, False))[:4]
    _check_all(gx, gy, gz, window, feat_j, filters, d, dout)
    m, k = window.shape
    z, ci, co = filters.shape
    outs = [torch.empty((m, k), dtype=torch.float32, device=window.device)
            for _ in range(4)]
    if m == 0:
        return tuple(outs)
    ft = _f_transposed(filters)
    with torch.cuda.device(window.device):
        rc = _lib().contconv_bwd_geom(
            gx.data_ptr(), gy.data_ptr(), gz.data_ptr(), window.data_ptr(),
            feat_j.data_ptr(), dout.data_ptr(), ft.data_ptr(), m, k, ci, co, d,
            *(o.data_ptr() for o in outs), _stream())
    build.raise_on(rc, f"contconv_bwd_geom launch (d={d}, k={k}, ci={ci}, co={co}; "
                       f"{_LIMITS})")
    contconv_bwd_geom.launches += 1
    return tuple(outs)


class _Collect(torch.autograd.Function):
    """B3 (the twin on the CPU) with B4-B6 as its backward, each launched
    only for the inputs that need a gradient. Saves the inputs only."""

    @staticmethod
    def forward(ctx, gx, gy, gz, window, feat_j, filters, d):
        ctx.d = d
        ctx.save_for_backward(gx, gy, gz, window, feat_j, filters)
        if window.is_cuda:
            return _launch(gx, gy, gz, window, feat_j, filters, d)
        return contconv_collect_torch(gx, gy, gz, window, feat_j, filters, d=d)

    @staticmethod
    def backward(ctx, dout):
        args = (*ctx.saved_tensors, dout.contiguous())
        need = ctx.needs_input_grad
        geo = (contconv_bwd_geom(*args, d=ctx.d) if any(need[:4]) else (None,) * 4)
        dfeat = contconv_bwd_feat(*args, d=ctx.d) if need[4] else None
        d_f = contconv_bwd_filters(*args, d=ctx.d) if need[5] else None
        return (*(g if n else None for g, n in zip(geo, need[:4])), dfeat, d_f, None)


def contconv_collect(gx, gy, gz, window, feat_j, filters, *, d: int):
    """Fused collect, the port of the JAX ``contconv_collect``;
    differentiable in every input (B4-B6 on the card).

    :param gx, gy, gz: (M, k) float32 per-edge grid coordinates (clamped
        to [0, d - 1] inside).
    :param window: (M, k) float32 edge weights; 0 kills an edge.
    :param feat_j: (M, k, ci) float32 gathered neighbour features.
    :param filters: (d^3, ci, co) float32 flat filter bank.
    :param d: filter grid resolution; the kernels take 2 <= d <= 10,
        k <= 64 and co <= 128 (the backward B5/B6 also ci <= 128), within
        their shared memory, and a launch raises ``RuntimeError`` on other
        shapes.
    :return: (M, co) float32, the sum over edges.
    """
    if not build.on_cpu(gx, gy, gz, window, feat_j, filters):
        _check_all(gx, gy, gz, window, feat_j, filters, d)
    return _Collect.apply(gx, gy, gz, window, feat_j, filters, d)


contconv_collect.launches = 0
contconv_bwd_filters.launches = 0
contconv_bwd_feat.launches = 0
contconv_bwd_geom.launches = 0
