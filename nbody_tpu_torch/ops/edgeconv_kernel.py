"""Windowed EdgeConv message sum — the port of ``attic/edgeconv_kernel.py``
(the JAX package's ``nbody_tpu/ops/edgeconv_kernel.py`` before it was moved
to ``attic/``).

The fused EdgeConv forward (``models/gnn.py``) leaves one k-sized step per
layer: ``sum_k valid * tanh(u'_i + v[idx[i, k]])``. The Morton kNN search
draws every candidate from a window of sorted rows, so with rows in Morton
order most edges are near the diagonal. The work is split per graph build:

- :func:`plan_windowed_gather` routes each valid edge either to the window
  kernel (its sender lies within ``half`` rows of the receiver's tile of
  ``tile`` rows) or to a compacted fallback list of static size ``budget``;
- :func:`windowed_tanh_sum` sums the in-window edges: for CUDA tensors it
  launches B11, hand-written CUDA in ``nbody_tpu_torch/csrc/edgeconv.cu``
  that replaces the Pallas ``_windowed_kernel``; for CPU tensors it runs the
  plain version :func:`windowed_tanh_sum_torch`. It counts its launches in
  ``windowed_tanh_sum.launches``;
- :func:`edge_message_sum` sums every edge the plan keeps, in-window and
  taken fallback edges alike. The JAX function adds the fallback list with
  XLA ops after its kernel; here one launch of B11, in the mode that reads
  ``v`` itself and applies the window only to the bfloat16 rounding, sums
  both (its plain version :func:`edge_message_sum_torch` for CPU tensors).
  The launch is counted in ``windowed_tanh_sum.launches``.

Like the JAX kernel it has no gradient: inputs that require one raise. It
stands beside the model as in the JAX package: ``GraphModel`` and the
rollout do not call it.

What the TPU kernel asks of its shapes and the port does not: ``tile`` and
``half`` multiples of 128 and the channel axis padded to 128 lanes. Here
``tile`` is any positive and ``half`` any non-negative row count, and ``d``
any multiple of 4 (the kernel reads 16-byte vectors of 4 channels). A sender
row outside the table reads as zeros, as the zero pad rows of the TPU
kernel's ``vpad`` read; the graph builders give none.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from nbody_tpu_torch.ops import build

_VEC = 4  # channels per 16-byte vector of the kernel
GATHER_DTYPES = (torch.float32, torch.bfloat16)

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load_library("edgeconv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.edgeconv_windowed_tanh_sum.argtypes = [ptr] * 5 + [i32] * 8 + [ptr, ptr]
        lib.edgeconv_windowed_tanh_sum.restype = i32
        _LIB = lib
    return _LIB


def _window_rows(idx: torch.Tensor, tile: int, half: int) -> torch.Tensor:
    """(N, k) bool: the sender of edge (i, k) lies in the window of row i's
    tile, rows [tile_start - half, tile_start + tile + half)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    r = idx.long() - (rows // tile) * tile + half
    return (r >= 0) & (r < tile + 2 * half)


def _tanh_sum_torch(u, table, idx, take, rounded, off: int):
    """``sum_k take * tanh(u[i] + g)``, ``g`` row ``idx + off`` of ``table``
    (zeros outside it), bfloat16-rounded where ``rounded`` (None: nowhere)."""
    j = idx.long() + off
    inside = (j >= 0) & (j < table.shape[0])
    g = torch.where(inside[:, :, None], table[j.clamp(0, table.shape[0] - 1)], 0.0)
    if rounded is not None:
        g = torch.where(rounded[:, :, None], g.to(torch.bfloat16).to(torch.float32), g)
    t = torch.tanh(u[:, None, :] + g)
    return torch.where(take[:, :, None], t, 0.0).sum(dim=1)


def windowed_tanh_sum_torch(u, vpad, idx, mask, *, tile: int = 256, half: int = 384,
                            gather_dtype: torch.dtype = torch.float32):
    """Plain version of B11 (see :func:`windowed_tanh_sum`): gather, tanh,
    masked sum over k."""
    take = mask.bool() & _window_rows(idx, tile, half)
    rounded = take if gather_dtype == torch.bfloat16 else None
    return _tanh_sum_torch(u, vpad, idx, take, rounded, half)


def _check(u, v, idx, masks, gather_dtype):
    """The checks both entry points make; returns True for CPU tensors."""
    n, d = u.shape
    if d % _VEC:
        raise ValueError(f"d={d} must be a multiple of {_VEC} (16-byte channel vectors)")
    if gather_dtype not in GATHER_DTYPES:
        raise ValueError(f"gather_dtype {gather_dtype}: one of {GATHER_DTYPES}")
    if u.requires_grad or v.requires_grad:
        raise RuntimeError("the EdgeConv message sum has no gradient (inference only): "
                           "call it under torch.no_grad() or on detached tensors")
    cpu = build.on_cpu(u, v, idx, *masks)
    build.check("u", u, (n, d))
    build.check("v", v, (v.shape[0], d))
    build.check("idx", idx, (n, idx.shape[1]), torch.int32)
    for m in masks:
        build.check("mask", m, tuple(idx.shape), torch.bool)
    return cpu


def _launch(u, v, idx, mask, mask2, *, off: int, tile: int, half: int,
            gather_dtype: torch.dtype):
    """One launch of B11 (windowed mode without ``mask2``, owned mode with
    it), counted in ``windowed_tanh_sum.launches``."""
    n, d = u.shape
    k = idx.shape[1]
    if n + tile + 2 * half >= 2 ** 31:
        raise ValueError(f"N + tile + 2 * half = {n + tile + 2 * half} must stay below 2^31 "
                         f"(the kernel's 32-bit window test)")
    out = torch.empty((n, d), dtype=torch.float32, device=u.device)
    if n == 0 or k == 0:
        return out.zero_()
    with torch.cuda.device(u.device):
        rc = _lib().edgeconv_windowed_tanh_sum(
            u.data_ptr(), v.data_ptr(), idx.data_ptr(), mask.data_ptr(),
            None if mask2 is None else mask2.data_ptr(), n, v.shape[0], off, d, k, tile,
            half, int(gather_dtype == torch.bfloat16), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.raise_on(rc, f"B11 launch (n={n}, d={d}, k={k}, tile={tile}, half={half}, "
                       f"{'owned' if mask2 is not None else 'windowed'})")
    windowed_tanh_sum.launches += 1
    return out


def windowed_tanh_sum(u, vpad, idx, mask, *, tile: int = 256, half: int = 384,
                      gather_dtype: torch.dtype = torch.float32):
    """B11: masked ``sum_k tanh(u[i] + v[idx[i, k]])`` over the edges whose
    sender lies in the receiver tile's window.

    :param u: (N, d) float32 receiver term with the edge bias folded in
        (``u' = u - b1``); N a multiple of ``tile``, d a multiple of 4.
    :param vpad: (N + 2 * half, d) float32 sender term with ``half`` zero
        rows at each end, rows in the same sorted space as ``idx``.
    :param idx: (N, k) int32 sorted-space sender rows, not offset by the pad.
    :param mask: (N, k) bool, the edges this call owns; an edge outside the
        window is dropped here whatever its mask says.
    :param gather_dtype: ``torch.bfloat16`` rounds the gathered sender
        values to bfloat16 (nearest even) before the add; ``u`` and the sum
        stay float32.
    :return: (N, d) float32.
    """
    n = u.shape[0]
    if tile <= 0 or half < 0:
        raise ValueError(f"tile={tile} must be positive and half={half} non-negative")
    if n % tile:
        raise ValueError(f"N={n} must be a multiple of tile={tile}")
    if vpad.shape[0] != n + 2 * half:
        raise ValueError(f"vpad must have N+2*half={n + 2 * half} rows, got {vpad.shape[0]}")
    if _check(u, vpad, idx, (mask,), gather_dtype):
        return windowed_tanh_sum_torch(u, vpad, idx, mask, tile=tile, half=half,
                                       gather_dtype=gather_dtype)
    return _launch(u, vpad, idx, mask, None, off=half, tile=tile, half=half,
                   gather_dtype=gather_dtype)


windowed_tanh_sum.launches = 0


class WindowPlan(NamedTuple):
    """Routing of one graph's edges between the window kernel and the
    fallback list. A graph stays fixed between refreshes, so one plan serves
    every message pass until the next build. The first five fields are the
    JAX plan's; ``fb_mask`` is the port's own."""

    in_mask: torch.Tensor   # (Np, k) bool: edges the kernel owns (Np: N padded to a tile)
    fb_src: torch.Tensor    # (B,) int32 fallback sender rows (0 in an unused slot)
    fb_dst: torch.Tensor    # (B,) int32 fallback receiver rows (Np in an unused slot)
    fb_valid: torch.Tensor  # (B,) bool
    overflow: torch.Tensor  # () int64: fallback edges beyond the budget. Kernel
    # edges are never dropped; overflow > 0 means ``budget`` was too small
    # and the sum misses that many edges. Callers must check it.
    fb_mask: torch.Tensor   # (Np, k) bool: the fallback list's taken edges, in place


def plan_windowed_gather(idx, valid, *, tile: int = 256, half: int = 384,
                         budget: Optional[int] = None) -> WindowPlan:
    """Split the (N, k) edges: in-window edges go to the kernel, the rest,
    in edge order (so sorted by receiver), into a fallback list of static
    size ``budget`` (default ``N * k // 4``). One stable argsort of the edge
    mask, paid once per graph build. No host synchronisation: ``overflow``
    comes back as a tensor."""
    n, k = idx.shape
    if budget is None:
        budget = (n * k) // 4
    if n % tile:  # pad the receivers to a whole tile; the new slots are invalid
        pad = tile - n % tile
        idx = torch.nn.functional.pad(idx, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, 0, 0, pad))
        n += pad
    valid = valid.bool()
    in_win = _window_rows(idx, tile, half)
    flat_fb = (valid & ~in_win).reshape(-1)
    # fallback edges first, each group in edge order
    order = torch.argsort((~flat_fb).to(torch.uint8), stable=True)[:budget]
    taken = flat_fb[order]
    fb_src = torch.where(taken, idx.reshape(-1)[order], 0).to(torch.int32)
    fb_dst = torch.where(taken, order // k, n).to(torch.int32)
    fb_mask = torch.zeros_like(flat_fb).scatter_(0, order, taken).view(n, k)
    return WindowPlan(valid & in_win, fb_src, fb_dst, taken, flat_fb.sum() - taken.sum(),
                      fb_mask)


def edge_message_sum_torch(u, v, idx, plan: WindowPlan, *, tile: int = 256,
                           half: int = 384, gather_dtype: torch.dtype = torch.float32):
    """Plain version of :func:`edge_message_sum`: a gather over the edges the
    plan keeps, those in the window rounded in bfloat16 mode, and a masked
    sum over k."""
    n = u.shape[0]
    take = (plan.in_mask | plan.fb_mask)[:n]
    rounded = _window_rows(idx, tile, half) if gather_dtype == torch.bfloat16 else None
    return _tanh_sum_torch(u, v, idx, take, rounded, 0)


def edge_message_sum(u, v, idx, plan: WindowPlan, *, tile: int = 256, half: int = 384,
                     gather_dtype: torch.dtype = torch.float32):
    """Masked ``sum_k tanh(u[i] + v[idx[i, k]])`` over every edge the plan
    keeps: its in-window edges and its taken fallback edges. Fallback edges
    beyond the budget stay out (``plan.overflow`` counts them).

    ``u`` carries the folded bias (``u' = u - b1``); rows of ``u``, ``v`` and
    ``idx`` are in the sorted (Morton) space. N may be any size: ``plan``
    covers it padded to whole tiles and must come from the same ``tile`` and
    ``half``. In ``gather_dtype=torch.bfloat16`` the in-window edges read
    ``v`` rounded to bfloat16 and the fallback edges read it unrounded, as in
    the JAX function. For CUDA tensors one launch of B11; returns (N, d)
    float32.
    """
    n = u.shape[0]
    np_ = -(-n // tile) * tile
    if tuple(plan.in_mask.shape) != (np_, idx.shape[1]) or plan.fb_mask.shape != plan.in_mask.shape:
        raise ValueError(f"plan masks {tuple(plan.in_mask.shape)} do not cover N={n} in tiles "
                         f"of {tile}")
    if v.shape[0] != n:
        raise ValueError(f"v must have N={n} rows, got {v.shape[0]}")
    in_mask, fb_mask = plan.in_mask[:n], plan.fb_mask[:n]
    if _check(u, v, idx, (in_mask, fb_mask), gather_dtype):
        return edge_message_sum_torch(u, v, idx, plan, tile=tile, half=half,
                                      gather_dtype=gather_dtype)
    return _launch(u, v, idx, in_mask, fb_mask, off=0, tile=tile, half=half,
                   gather_dtype=gather_dtype)
