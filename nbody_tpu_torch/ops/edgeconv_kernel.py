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
- :func:`edge_message_sum` adds the fallback edges with plain torch ops (a
  gather and a segmented sum over the receiver-sorted list in a fixed
  order, which repeats its bits), as the JAX function adds them with XLA
  ops.

Like the JAX kernel it has no gradient: inputs that require one raise. It
stands beside the model as in the JAX package: ``GraphModel`` and the
rollout do not call it.

What the TPU kernel asks of its shapes and the port does not: ``tile`` and
``half`` multiples of 128 and the channel axis padded to 128 lanes. Here
``tile`` is any positive and ``half`` any non-negative row count, and ``d``
any multiple of 4 (the kernel reads 16-byte vectors of 4 channels).
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
        lib.edgeconv_windowed_tanh_sum.argtypes = [ptr] * 4 + [i32] * 6 + [ptr, ptr]
        lib.edgeconv_windowed_tanh_sum.restype = i32
        _LIB = lib
    return _LIB


def _window_rows(idx: torch.Tensor, tile: int, half: int) -> torch.Tensor:
    """(N, k) bool: the sender of edge (i, k) lies in the window of row i's
    tile, rows [tile_start - half, tile_start + tile + half)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    r = idx.long() - (rows // tile) * tile + half
    return (r >= 0) & (r < tile + 2 * half)


def windowed_tanh_sum_torch(u, vpad, idx, mask, *, tile: int = 256, half: int = 384,
                            gather_dtype: torch.dtype = torch.float32):
    """Plain version of B11 (see :func:`windowed_tanh_sum`): gather, tanh,
    masked sum over k."""
    m = mask.bool() & _window_rows(idx, tile, half)
    g = vpad[(idx.long() + half).clamp(0, vpad.shape[0] - 1)]  # (N, k, d)
    if gather_dtype == torch.bfloat16:
        g = g.to(torch.bfloat16).to(torch.float32)
    t = torch.tanh(u[:, None, :] + g)
    return torch.where(m[:, :, None], t, 0.0).sum(dim=1)


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
    n, d = u.shape
    k = idx.shape[1]
    if tile <= 0 or half < 0:
        raise ValueError(f"tile={tile} must be positive and half={half} non-negative")
    if n % tile:
        raise ValueError(f"N={n} must be a multiple of tile={tile}")
    if vpad.shape[0] != n + 2 * half:
        raise ValueError(f"vpad must have N+2*half={n + 2 * half} rows, got {vpad.shape[0]}")
    if d % _VEC:
        raise ValueError(f"d={d} must be a multiple of {_VEC} (16-byte channel vectors)")
    if gather_dtype not in GATHER_DTYPES:
        raise ValueError(f"gather_dtype {gather_dtype}: one of {GATHER_DTYPES}")
    if u.requires_grad or vpad.requires_grad:
        raise RuntimeError("windowed_tanh_sum has no gradient (inference only): "
                           "call it under torch.no_grad() or on detached tensors")
    cpu = build.on_cpu(u, vpad, idx, mask)
    build.check("u", u, (n, d))
    build.check("vpad", vpad, (n + 2 * half, d))
    build.check("idx", idx, (n, k), torch.int32)
    build.check("mask", mask, (n, k), torch.bool)
    if cpu:
        return windowed_tanh_sum_torch(u, vpad, idx, mask, tile=tile, half=half,
                                       gather_dtype=gather_dtype)
    out = torch.empty((n, d), dtype=torch.float32, device=u.device)
    if n == 0 or k == 0:
        return out.zero_()
    with torch.cuda.device(u.device):
        rc = _lib().edgeconv_windowed_tanh_sum(
            u.data_ptr(), vpad.data_ptr(), idx.data_ptr(), mask.data_ptr(), n, d, k,
            tile, half, int(gather_dtype == torch.bfloat16), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.raise_on(rc, f"windowed_tanh_sum launch (n={n}, d={d}, k={k}, tile={tile}, "
                       f"half={half})")
    windowed_tanh_sum.launches += 1
    return out


windowed_tanh_sum.launches = 0


class WindowPlan(NamedTuple):
    """Routing of one graph's edges between the window kernel and the
    fallback list. A graph stays fixed between refreshes, so one plan serves
    every message pass until the next build."""

    in_mask: torch.Tensor   # (Np, k) bool: edges the kernel owns (Np: N padded to a tile)
    fb_src: torch.Tensor    # (B,) int32 fallback sender rows (0 in an unused slot)
    fb_dst: torch.Tensor    # (B,) int32 fallback receiver rows (Np in an unused slot)
    fb_valid: torch.Tensor  # (B,) bool
    overflow: torch.Tensor  # () int64: fallback edges beyond the budget. Kernel
    # edges are never dropped; overflow > 0 means ``budget`` was too small
    # and the sum misses that many edges. Callers must check it.


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
    return WindowPlan(valid & in_win, fb_src, fb_dst, taken, flat_fb.sum() - taken.sum())


def edge_message_sum(u, v, idx, plan: WindowPlan, *, tile: int = 256, half: int = 384,
                     gather_dtype: torch.dtype = torch.float32):
    """Masked ``sum_k tanh(u[i] + v[idx[i, k]])`` over all valid edges: the
    window kernel for ``plan.in_mask`` and plain torch for the fallback list.

    ``u`` carries the folded bias (``u' = u - b1``); rows of ``u``, ``v`` and
    ``idx`` are in the sorted (Morton) space. N may be any size: rows are
    padded to the plan's whole tiles (``plan`` must come from the same
    ``tile`` and ``half``). Fallback edges read unrounded ``v`` in either
    ``gather_dtype``. Returns (N, d) float32.
    """
    n, d = u.shape
    np_ = plan.in_mask.shape[0]
    if np_ != n:
        rows = (0, 0, 0, np_ - n)
        u, v, idx = (torch.nn.functional.pad(t, rows) for t in (u, v, idx))
    vpad = torch.nn.functional.pad(v, (0, 0, half, half))
    out = windowed_tanh_sum(u.contiguous(), vpad, idx.contiguous(), plan.in_mask,
                            tile=tile, half=half, gather_dtype=gather_dtype)
    if plan.fb_dst.numel() == 0:
        return out[:n]
    dst = plan.fb_dst.long()
    tf = torch.tanh(u[dst.clamp(0, np_ - 1)] + v[plan.fb_src.long()])
    tf = torch.where(plan.fb_valid[:, None], tf, 0.0)
    # The list is sorted by receiver (unused slots, receiver Np, last), and a
    # receiver has at most k edges: its run is summed into the run's first
    # slot by log2(k) shifted adds, in an order that depends on nothing but
    # the list, and each receiver's row then has one writer.
    nslots, step = dst.shape[0], 1
    while step < min(idx.shape[1], nslots):
        same = torch.nn.functional.pad(dst[step:] == dst[:-step], (0, step))
        tf = tf + torch.where(same[:, None], torch.nn.functional.pad(tf[step:], (0, 0, 0, step)),
                              0.0)
        step *= 2
    head = torch.nn.functional.pad(dst[1:] != dst[:-1], (1, 0), value=True)
    fb = torch.zeros((np_ + 1, d), dtype=tf.dtype, device=tf.device)
    fb.index_copy_(0, torch.where(head, dst, np_), tf)  # the others land in the spare row
    return (out + fb[:np_])[:n]
