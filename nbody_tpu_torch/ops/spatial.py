"""Space-filling-curve kNN — the port of ``nbody_tpu/ops/spatial.py``, the
large-N neighbour search.

Particles are sorted along Morton (Z-order) curves; each particle takes its
candidates from a window of its sorted neighbourhood, which adapts to local
density because the curve is hierarchical. Up to four curve copies
(``_COPIES``: identity, shifted, and rotated about z and about y) are
searched and their candidates merged without duplicates.

Two implementations, as in the JAX package, and they are two different
algorithms, not two speeds of one:

- ``impl="dense"`` (JAX ``"xla"``): blocks of ``block`` sorted rows against a
  half-window of ``window`` rows on each side, squared distances from the norm
  expansion |q|^2 + |c|^2 - 2 q.c (a full-float32 batched matmul: TF32 would
  reorder neighbours), k smallest by a stable sort, then a k-pass merge that
  masks duplicate ids. Plain torch on any device.
- ``impl="kernel"`` (JAX ``"pallas"``): the window is structural, the left,
  own and right blocks (3 * block candidates), distances from exact
  coordinate differences, selection by packed ``d2|column`` keys. Two
  hand-written CUDA kernels in ``nbody_tpu_torch/csrc/spatial.cu``: B7
  :func:`morton_select` (replaces the Pallas ``_select_kernel``) and B8
  :func:`morton_merge` (replaces ``_merge_kernel``). Each wrapper runs its
  plain-torch twin (``*_torch``) for CPU tensors and launches its kernel for
  CUDA tensors, and counts launches in ``<wrapper>.launches``.

The JAX package carries positions through ``lax.sort`` as payloads because a
row gather is slow on a TPU; here the sort is ``torch.sort(keys,
stable=True)`` and the payloads are gathers, which the card does well.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Optional, Tuple

import torch

from nbody_tpu_torch.ops import build

_INF = float(torch.finfo(torch.float32).max)
_INF_BITS = 0x7F7FFFFF  # bits of _INF
_BIG = 1e15  # sentinel coordinate of padded and masked rows (d2 ~ 1e30)
_BAD_D2 = 1e29  # a distance at or above this is a sentinel, never a neighbour
_TINY = 2.0 ** -100  # floor of packed distances (see _pack)
_N_BITS = 10  # 1024^3 grid; 3 x 10 bits fit an int32 key
_MAX_Q = 2 ** _N_BITS - 1

_SQ2 = 2.0 ** -0.5
# (rotation, shift) per curve copy, as in the JAX package.
_COPIES = (
    (None, 0.0),
    (None, 0.41),
    (((_SQ2, -_SQ2, 0.0), (_SQ2, _SQ2, 0.0), (0.0, 0.0, 1.0)), 0.17),
    (((_SQ2, 0.0, -_SQ2), (0.0, 1.0, 0.0), (_SQ2, 0.0, _SQ2)), 0.59),
)
IMPLS = ("dense", "kernel")
# the most curve copies one B7 launch takes (a batch's copies stacked): the
# grid's y dimension
MAX_COPIES = 65535

# elements of one (copies, blocks, b, 3b) distance slab in the B7 twin
_TWIN_ELEMS = 1 << 25

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load_library("spatial")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.morton_select.argtypes = [ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.morton_select.restype = i32
        lib.morton_merge.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.morton_merge.restype = i32
        _LIB = lib
    return _LIB


# ------------------------------------------------------------- Morton keys

def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 ``x`` out to every 3rd bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _rotate(pos: torch.Tensor, rot) -> torch.Tensor:
    """``pos @ rot.T`` written out as separate multiplies and adds, so each
    output is ((x r0 + y r1) + z r2) with every operation rounded on its own
    on every device (a BLAS product may contract into FMAs)."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    return torch.stack([x * r[0] + y * r[1] + z * r[2] for r in rot], dim=-1)


def morton_keys(pos: torch.Tensor, mask: Optional[torch.Tensor] = None,
                shift: float = 0.0, rot=None) -> torch.Tensor:
    """(N,) int32 Z-order keys of (N, 3) positions, quantised isotropically
    (one scale: the largest axis span of the masked bounding box) to a
    1024^3 grid. ``shift`` translates the grid by that fraction of the box;
    ``rot`` pre-rotates positions (3x3 row-major). Masked rows get INT32_MAX
    keys, so they sort last. A batch ``(B, N, 3)`` (with a ``(B, N)`` mask)
    gives ``(B, N)``, each scene quantised in its own box: the keys of a
    call on that scene alone."""
    if rot is not None:
        pos = _rotate(pos, rot)
    if mask is not None:
        m = mask.bool()[..., None]
        lo = torch.where(m, pos, float("inf")).amin(-2, keepdim=True)
        hi = torch.where(m, pos, float("-inf")).amax(-2, keepdim=True)
    else:
        lo, hi = pos.amin(-2, keepdim=True), pos.amax(-2, keepdim=True)
    span = torch.clamp((hi - lo).amax(-1, keepdim=True), min=1e-30)
    q = torch.clamp((pos - lo) * (_MAX_Q / span) + shift * _MAX_Q,
                    0, _MAX_Q).to(torch.int32)
    key = _part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1) | (_part1by2(q[..., 2]) << 2)
    if mask is not None:
        key = torch.where(mask.bool(), key, torch.full_like(key, 0x7FFFFFFF))
    return key


def _curve_order(pos, mask, n_copies):
    """(C, N) int64 permutations sorting rows along each curve copy (stable,
    so equal keys keep row order); a batch (B, N, 3) gives (B, C, N)."""
    keys = torch.stack([morton_keys(pos, mask, shift=s, rot=r)
                        for r, s in _COPIES[:n_copies]], dim=-2)
    return torch.sort(keys, dim=-1, stable=True).indices


# ------------------------------------------------------- impl="dense" path

def _select_k(d2: torch.Tensor, k: int):
    """Per row the k smallest of ``d2`` (..., W) -> (sel, vals); equal
    values in column order (a stable sort), which is what the JAX package's
    argmin passes and ``lax.top_k`` give."""
    vals, sel = torch.sort(d2, dim=-1, stable=True)
    return sel[..., :k], vals[..., :k]


def _copy_pass_dense(pos, order, k, block, window, include_self):
    """One curve copy, JAX ``_copy_pass``: blocks of ``block`` sorted rows
    against a window of ``block + 2 * window`` rows.

    :return: (qg (npad,), ids (npad, k), d2 (npad, k)) in sorted order; pad
        rows carry qg == n."""
    n, b, w = pos.shape[0], block, window
    nb = -(-n // b)
    npad = nb * b
    dev = pos.device
    spos = torch.full((npad + 2 * w, 3), _BIG, dtype=pos.dtype, device=dev)
    spos[w:w + n] = pos[order]
    sg = torch.full((npad + 2 * w,), n, dtype=torch.int32, device=dev)
    sg[w:w + n] = order.to(torch.int32)
    q = spos[w:w + npad].reshape(nb, b, 3)
    c = spos.unfold(0, b + 2 * w, b).transpose(1, 2)  # (nb, b + 2w, 3)
    cg = sg.unfold(0, b + 2 * w, b)  # (nb, b + 2w)
    d2 = ((q * q).sum(-1)[:, :, None] + (c * c).sum(-1)[:, None, :]
          - 2.0 * torch.bmm(q, c.transpose(1, 2)))
    bad = d2 >= _BAD_D2
    if not include_self:
        rows = torch.arange(b, device=dev)[:, None]
        cols = torch.arange(b + 2 * w, device=dev)[None, :]
        bad = bad | (cols == rows + w)  # row r's own column is r + w
    d2 = torch.where(bad, _INF, torch.clamp(d2, min=0.0))
    sel, sd2 = _select_k(d2, k)
    ids = torch.gather(cg[:, None, :].expand(nb, b, b + 2 * w), 2, sel)
    return sg[w:w + npad], ids.reshape(npad, k), sd2.reshape(npad, k)


def _merge_dedup(cand, d2, k):
    """JAX ``_merge_dedup``: k passes, each taking the row minimum (first
    column on ties) and masking every slot that holds the picked id."""
    dd = d2.clone()
    ids, vals = [], []
    for _ in range(k):
        am = torch.argmin(dd, dim=1, keepdim=True)
        vals.append(torch.gather(dd, 1, am)[:, 0])
        picked = torch.gather(cand, 1, am)
        ids.append(picked[:, 0])
        dd = torch.where(cand == picked, _INF, dd)
    return torch.stack(ids, 1), torch.stack(vals, 1)


# ------------------------------------------- impl="kernel" path: B7 and B8

def _nbits(ncols: int) -> int:
    return max((ncols - 1).bit_length(), 1)


def _pack(d2: torch.Tensor, cols: torch.Tensor, nbits: int) -> torch.Tensor:
    """int32 keys: the bits of max(d2, 2^-100) (non-negative floats order as
    their bits do) with the low ``nbits`` bits replaced by the column. The
    floor keeps a zero distance off the denormals, whose column bits a
    flush-to-zero would erase."""
    bits = torch.clamp(d2, min=_TINY).view(torch.int32)
    return (bits & ~((1 << nbits) - 1)) | cols


def _unpack(keys: torch.Tensor, nbits: int) -> torch.Tensor:
    return (keys & ~((1 << nbits) - 1)).view(torch.float32)


def morton_select_torch(cand: torch.Tensor, k: int, block: int,
                        include_self: bool):
    """Plain-torch twin of B7 (see :func:`morton_select`)."""
    c_, L, _ = cand.shape
    b = block
    nb = L // b - 2
    nbits = _nbits(3 * b)
    dev = cand.device
    gid = cand[..., 3].contiguous().view(torch.int32)
    rows = torch.arange(b, device=dev)[:, None]
    cols = torch.arange(3 * b, device=dev, dtype=torch.int32)[None, :]
    ids = torch.empty((c_, nb * b, k), dtype=torch.int32, device=dev)
    d2s = torch.empty((c_, nb * b, k), dtype=torch.float32, device=dev)
    step = max(1, _TWIN_ELEMS // (c_ * b * 3 * b))
    for i0 in range(0, nb, step):
        i1 = min(nb, i0 + step)
        win = cand[:, i0 * b:(i1 + 2) * b].unfold(1, 3 * b, b)  # (C, m, 4, 3b)
        q = cand[:, (i0 + 1) * b:(i1 + 1) * b, :3].reshape(c_, i1 - i0, b, 3)
        dx = win[:, :, None, 0, :] - q[..., 0:1]
        dy = win[:, :, None, 1, :] - q[..., 1:2]
        dz = win[:, :, None, 2, :] - q[..., 2:3]
        d2 = dx * dx + dy * dy + dz * dz  # (C, m, b, 3b), no FMA contraction
        bad = d2 >= _BAD_D2
        if not include_self:
            bad = bad | (cols == rows + b)  # query row r is column b + r
        d2 = torch.where(bad, _INF, torch.clamp(d2, min=0.0))
        keys = torch.topk(_pack(d2, cols, nbits), k, dim=-1, largest=False,
                          sorted=True).values
        g = gid[:, i0 * b:(i1 + 2) * b].unfold(1, 3 * b, b)  # (C, m, 3b)
        sel = (keys & ((1 << nbits) - 1)).long()
        ids[:, i0 * b:i1 * b] = torch.gather(
            g[:, :, None, :].expand(-1, -1, b, -1), 3, sel).reshape(c_, -1, k)
        d2s[:, i0 * b:i1 * b] = _unpack(keys, nbits).reshape(c_, -1, k)
    return ids, d2s


def morton_select(cand: torch.Tensor, k: int, block: int, include_self: bool):
    """B7: for every curve copy and block of ``block`` queries in curve
    order, the ``k`` smallest packed keys over the 3 * block candidates of
    the left, own and right blocks (any k <= 3 * block; above 32 the kernel
    selects in slabs of 32).

    :param cand: (C, (nb + 2) * block, 4) float32 [x, y, z, gid bits]: the
        sorted positions with one block of _BIG sentinels before and at
        least one after, the int32 original row ids bit-cast into column 3.
        Query row r of block i is candidate row (i + 1) * block + r.
    :return: (ids (C, nb * block, k) int32 original row ids, d2 (C, nb *
        block, k) float32 distances with the column bits cleared). A
        sentinel distance comes back as ~3.4e38, which the caller's
        d2 < 1e29 test drops.
    """
    if build.on_cpu(cand):
        return morton_select_torch(cand, k, block, include_self)
    c_, L = cand.shape[0], cand.shape[1]
    nb = L // block - 2
    build.check("cand", cand, (c_, (nb + 2) * block, 4))
    if not (nb > 0 and 0 < k <= 3 * block and block <= 682 and c_ <= MAX_COPIES):
        raise ValueError(f"morton_select: {c_} copies, nb={nb}, k={k}, block={block} "
                         f"(the kernel takes k <= 3 * block, block <= 682 and at most "
                         f"{MAX_COPIES} copies, the grid's y)")
    ids = torch.empty((c_, nb * block, k), dtype=torch.int32, device=cand.device)
    d2s = torch.empty((c_, nb * block, k), dtype=torch.float32, device=cand.device)
    with torch.cuda.device(cand.device):
        rc = _lib().morton_select(
            cand.data_ptr(), c_, nb, block, k, int(include_self),
            _nbits(3 * block), ids.data_ptr(), d2s.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.raise_on(rc, "morton_select launch")
    morton_select.launches += 1
    return ids, d2s


morton_select.launches = 0


def morton_merge_torch(cand: torch.Tensor, d2: torch.Tensor, k: int):
    """Plain-torch twin of B8 (see :func:`morton_merge`)."""
    w = cand.shape[1]
    nbits = _nbits(w)
    cols = torch.arange(w, device=cand.device, dtype=torch.int32)[None, :]
    keys = _pack(torch.clamp(d2, min=0.0), cols, nbits)
    ids, vals = [], []
    for _ in range(k):
        mn = keys.amin(dim=1, keepdim=True)
        # exactly one hit while candidates remain; an exhausted row sums
        # every slot (wrapping like int32), as the kernel does
        pid = torch.where(keys == mn, cand, 0).sum(1, keepdim=True).to(torch.int32)
        ids.append(pid[:, 0])
        vals.append(mn[:, 0])
        keys = torch.where(cand == pid, _INF_BITS, keys)
    return torch.stack(ids, 1), _unpack(torch.stack(vals, 1), nbits)


def morton_merge(cand: torch.Tensor, d2: torch.Tensor, k: int):
    """B8: per row, the ``k`` nearest unique ids among the C * k candidates
    of all curve copies (k passes; each masks every slot holding the picked
    id, which removes its duplicates). The kernel equals
    :func:`morton_merge_torch` bit for bit on any input whose distances
    hold no NaN: duplicates, unsorted copies and rows with fewer than k
    unique ids included (``merge_kernel`` in csrc/spatial.cu).

    :param cand: (N, W) int32 candidate ids, W <= 2048 (the packed keys
        hold the column in 11 bits, as JAX's ``_pack_d2_cols`` asserts).
    :param d2: (N, W) float32 their squared distances.
    :return: (ids (N, k) int32, d2 (N, k) float32); an exhausted row's
        surplus slots carry d2 ~3.4e38.
    """
    if build.on_cpu(cand, d2):
        return morton_merge_torch(cand, d2, k)
    n, w = cand.shape
    build.check("cand", cand, (n, w), torch.int32)
    build.check("d2", d2, (n, w))
    if not (0 < w <= 2048 and k > 0):
        raise ValueError(f"morton_merge: width {w} and k {k} (the packed keys take "
                         "at most 2048 candidates a row)")
    ids = torch.empty((n, k), dtype=torch.int32, device=cand.device)
    vals = torch.empty((n, k), dtype=torch.float32, device=cand.device)
    if n == 0:
        return ids, vals
    with torch.cuda.device(cand.device):
        rc = _lib().morton_merge(
            cand.data_ptr(), d2.data_ptr(), n, w, k, _nbits(w), ids.data_ptr(),
            vals.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.raise_on(rc, "morton_merge launch")
    morton_merge.launches += 1
    return ids, vals


morton_merge.launches = 0


def _candidates(pos, order, block):
    """B7's input for all curve copies (JAX ``_copy_passes_pallas``): each
    copy's sorted positions with their original row ids bit-cast into column
    3, one block of sentinels before and after. A batch, ``pos`` (B, N, 3)
    and ``order`` (B, C, N), stacks its scenes' copies scene-major, B * C of
    them: the sentinel blocks keep every window inside its own copy.

    :return: (cand (C, npad + 2 * block, 4), qg (C, npad)); qg maps each
        sorted query row to its original row (pad rows carry n)."""
    n = order.shape[-1]
    b = block
    npad = -(-n // b) * b
    dev = pos.device
    rows = (pos[order] if pos.dim() == 2 else
            pos[torch.arange(pos.shape[0], device=dev)[:, None, None], order])
    copies = rows.shape[:-2].numel()
    cand = torch.full((copies, npad + 2 * b, 4), _BIG, dtype=torch.float32, device=dev)
    cand[:, b:b + n, :3] = rows.reshape(copies, n, 3)
    sg = torch.full((copies, npad + 2 * b), n, dtype=torch.int32, device=dev)
    sg[:, b:b + n] = order.reshape(copies, n).to(torch.int32)
    cand[..., 3] = sg.view(torch.float32)
    return cand, sg[:, b:b + npad]


def _to_rows(qg, ids, d2, n, scenes: int = 1):
    """Every copy's (npad, k) results scattered back to original row order
    and laid side by side: (N, C * k) ids and distances, copy c in columns
    c*k .. c*k + k - 1 (JAX's concatenation). Pad rows (qg == n) land in a
    dropped row. A batch's ``scenes * C`` copies (scene-major, as
    :func:`_candidates` stacks them) give (scenes * N, C * k), scene s in
    rows s*N .. s*N + N - 1."""
    copies, _, k = ids.shape
    c_ = copies // scenes
    slot = (torch.arange(copies, device=ids.device)[:, None] * (n + 1) + qg.long()).reshape(-1)
    idx_buf = torch.full((copies * (n + 1), k), -1, dtype=torch.int32, device=ids.device)
    d2_buf = torch.full((copies * (n + 1), k), _INF, dtype=torch.float32, device=ids.device)
    idx_buf[slot] = ids.reshape(-1, k)
    d2_buf[slot] = d2.reshape(-1, k)

    def side_by_side(buf):
        return (buf.view(scenes, c_, n + 1, k)[:, :, :n].permute(0, 2, 1, 3)
                .reshape(scenes * n, c_ * k).contiguous())

    return side_by_side(idx_buf), side_by_side(d2_buf)


# ------------------------------------------------------------- entry points

def _dense_small(pos, k, mask, include_self):
    """Small-N case: one dense block of exact differences covers all rows."""
    n = pos.shape[0]
    d = pos[None, :, :] - pos[:, None, :]
    d2 = (d * d).sum(-1)
    bad = torch.zeros_like(d2, dtype=torch.bool)
    if not include_self:
        bad |= torch.eye(n, dtype=torch.bool, device=pos.device)
    if mask is not None:
        bad |= ~mask.bool()[None, :]
    sel, sd2 = _select_k(torch.where(bad, _INF, d2), k)
    valid = sd2 < _BAD_D2
    if mask is not None:
        valid = valid & mask.bool()[:, None]
    return torch.where(valid, sel, 0).to(torch.int32), valid


def knn_morton(pos: torch.Tensor, k: int, mask: Optional[torch.Tensor] = None,
               include_self: bool = False, window: int = 64, block: int = 256,
               n_copies: int = 4, impl: str = "dense",
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate k nearest neighbours in O(N * window) — the contract of
    :func:`nbody_tpu_torch.ops.knn.knn_neighbors`: (N, k) int32 ids and
    (N, k) bool validity, invalid slots pointing at 0.

    :param window: half-window of the dense impl (a block row sees
        window..window + block candidates a side). The kernel impl's window
        is structural (one block a side) and ignores it.
    :param block: rows per block; the kernel impl takes block <= 682 (its
        packed keys hold the column of 3 * block candidates in 11 bits).
    :param n_copies: curve copies to union (<= 4).
    :param impl: "dense" (plain torch) or "kernel" (B7 + B8; their twins
        for CPU tensors). The two are different algorithms.
    """
    _check_impl(impl, window, block)
    n = pos.shape[0]
    k = min(k, n)
    n_copies = min(n_copies, len(_COPIES))
    if n <= max(2 * window + 1, 2 * block):
        return _dense_small(pos, k, mask, include_self)
    if impl == "kernel":
        return _kernel_search(pos, k, mask, include_self, block, n_copies)

    order = _curve_order(pos, mask, n_copies)
    # masked rows move to the sentinel: never a neighbour
    posm = pos if mask is None else torch.where(mask.bool()[:, None], pos, _BIG)
    outs = [_copy_pass_dense(posm, order[c], k, block, window, include_self)
            for c in range(n_copies)]
    qg, ids, d2 = (torch.stack(t) for t in zip(*outs))
    idx, d2 = _merge_dedup(*_to_rows(qg, ids, d2, n), k)
    return _valid_ids(idx, d2, mask, n)


def _check_impl(impl, window, block):
    if impl not in IMPLS:
        raise ValueError(f"unknown knn_morton impl {impl!r}: one of {IMPLS}")
    if impl == "kernel" and window != 64:
        warnings.warn(
            "knn_morton(impl='kernel') has a structural window (== block); "
            f"the window={window} argument is ignored, tune `block` instead",
            stacklevel=3)
    if impl == "kernel" and 3 * block > 2048:
        raise ValueError(
            f"knn_morton(impl='kernel') supports block <= 682 (each select "
            f"row scans 3*block packed candidates, max 2048); got "
            f"block={block}. Use impl='dense' for larger blocks.")


def _valid_ids(idx, d2, mask, n):
    """The search's (ids, validity): sentinel distances and masked rows are
    invalid, and invalid slots point at 0."""
    valid = d2 < _BAD_D2
    if mask is not None:
        valid = valid & mask.bool()[..., None]
    idx = torch.where(valid, idx, 0)
    return torch.clamp(idx, 0, n - 1).to(torch.int32), valid


def _kernel_search(pos, k, mask, include_self, block, n_copies):
    """The kernel impl past the small-N branch on one scene (N, 3), or on a
    batch (B, N, 3) with one B7 launch over its B * C curve copies and one B8
    launch over its B * N rows: B7 reads each copy's own windows and B8
    works row by row, so each scene gets the ids of a call on it alone."""
    lead, n = pos.shape[:-2], pos.shape[-2]
    order = _curve_order(pos, mask, n_copies)
    # masked rows move to the sentinel: never a neighbour
    posm = pos if mask is None else torch.where(mask.bool()[..., None], pos, _BIG)
    cand, qg = _candidates(posm, order, block)
    ids, d2 = morton_select(cand, k, block, include_self)
    idx, d2 = morton_merge(*_to_rows(qg, ids, d2, n, lead.numel()), k)
    return _valid_ids(idx.view(*lead, n, k), d2.view(*lead, n, k), mask, n)


def batched_knn_morton(pos, k, mask=None, include_self=False, window=64,
                       block=256, n_copies=4, impl="dense"):
    """:func:`knn_morton` over a leading batch axis: (B, N, 3) -> (B, N, k),
    each scene what a call on it alone gives. With ``impl="kernel"`` past
    the small-N branch the batch is one search: one B7 launch over its B x C
    curve copies and one B8 launch over its B x N rows. The dense impl and
    the small-N branch run scene by scene (torch ops, no kernel)."""
    bsz, n = pos.shape[0], pos.shape[1]
    if impl == "kernel" and bsz and n > max(2 * window + 1, 2 * block):
        _check_impl(impl, window, block)
        return _kernel_search(pos, min(k, n), mask, include_self, block,
                              min(n_copies, len(_COPIES)))
    outs = [knn_morton(pos[b], k, mask=None if mask is None else mask[b],
                       include_self=include_self, window=window, block=block,
                       n_copies=n_copies, impl=impl)
            for b in range(bsz)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))
