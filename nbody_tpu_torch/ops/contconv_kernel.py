"""Continuous-convolution collect — the port of
``nbody_tpu/ops/contconv_kernel.py``.

:func:`contconv_collect` computes, per receiver m,

    out[m] = sum_e window[m, e] * feat_j[m, e] @ T(F at (gx, gy, gz)[m, e])

with T the trilinear interpolation of the (D^3, ci, co) filter bank at the
edge's grid coordinates (clamped to [0, D - 1]); the sum over edges, the
mean left to the caller. For CUDA tensors it launches B3, hand-written CUDA
in ``nbody_tpu_torch/csrc/contconv.cu`` that replaces the Pallas
``_collect_kernel``; for CPU tensors it runs the plain-torch twin
:func:`contconv_collect_torch`, which is also the ``impl="dense"`` layer of
``models/contconv.py``. The wrapper counts its launches in
``contconv_collect.launches``.

The caller gathers ``feat_j`` (M, k, ci) itself, as the JAX layer does (1.6
GB at 100k bodies, k = 32, ci = 128, which the card holds); the kernel reads
each edge's row once for each of its 8 corner cells.

Only the forward exists on the card: the backward kernels (B4-B6, the
Pallas ``_bwd_*_kernel``s) come with the training slice, so a gradient
through B3 raises ``NotImplementedError``. The twin is differentiable.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nbody_tpu_torch.ops import build
from nbody_tpu_torch.ops.interpolate import trilinear_corners

# elements of one (rows, D^3, ci) bin slab in the twin
_TWIN_ELEMS = 1 << 25

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load_library("contconv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.contconv_collect.argtypes = [ptr] * 6 + [i32] * 5 + [ptr, ptr]
        lib.contconv_collect.restype = i32
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
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.raise_on(rc, f"contconv_collect launch (d={d}, k={k}, ci={ci}, co={co}; the "
                       "kernel takes 2 <= d <= 10, k <= 64, co <= 128 within 227 KB "
                       "of shared memory)")
    contconv_collect.launches += 1
    return out


class _Collect(torch.autograd.Function):
    """B3 with a backward that refuses: never a silent zero gradient."""

    @staticmethod
    def forward(ctx, gx, gy, gz, window, feat_j, filters, d):
        return _launch(gx, gy, gz, window, feat_j, filters, d)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "no gradient through the B3 collect kernel yet: its backward "
            "kernels (B4-B6) come with the training slice (ROADMAP.md, queue "
            "B); use impl='dense' to differentiate")


def contconv_collect(gx, gy, gz, window, feat_j, filters, *, d: int):
    """Fused collect, the port of the JAX ``contconv_collect``.

    :param gx, gy, gz: (M, k) float32 per-edge grid coordinates (clamped
        to [0, d - 1] inside).
    :param window: (M, k) float32 edge weights; 0 kills an edge.
    :param feat_j: (M, k, ci) float32 gathered neighbour features.
    :param filters: (d^3, ci, co) float32 flat filter bank.
    :param d: filter grid resolution; the kernel takes 2 <= d <= 10,
        k <= 64 and co <= 128, within its shared memory, and its launch
        raises ``RuntimeError`` on other shapes.
    :return: (M, co) float32, the sum over edges.
    """
    if build.on_cpu(gx, gy, gz, window, feat_j, filters):
        return contconv_collect_torch(gx, gy, gz, window, feat_j, filters, d=d)
    m, k = window.shape
    z, ci, co = filters.shape
    for name, t in zip(("gx", "gy", "gz", "window"), (gx, gy, gz, window)):
        build.check(name, t, (m, k))
    build.check("feat_j", feat_j, (m, k, ci))
    build.check("filters", filters, (d * d * d, ci, co))
    return _Collect.apply(gx, gy, gz, window, feat_j, filters, d)


contconv_collect.launches = 0
