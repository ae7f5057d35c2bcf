"""Frozen plain copy of the Morton (Z-order) neighbour search that the
surrogates' large-N graphs use: the semantics of the program's kernel
search (select over the left, own and right blocks of each curve copy by
packed ``d2|column`` keys, then a merge of the copies without duplicate
ids), and the radius cut on top of it.

Every float operation is written as the search defines it (exact
coordinate differences, no contracted multiply-adds, a true division for
the quantisation scale), so on one device the same positions give the same
neighbour ids.
"""

from __future__ import annotations

import torch

INF = float(torch.finfo(torch.float32).max)
INF_BITS = 0x7F7FFFFF
BIG = 1e15  # sentinel coordinate of padded rows
BAD_D2 = 1e29  # a distance at or above this is a sentinel
TINY = 2.0 ** -100  # floor of packed distances
MAX_Q = 1023  # 10 bits an axis
SQ2 = 2.0 ** -0.5
COPIES = (
    (None, 0.0),
    (None, 0.41),
    (((SQ2, -SQ2, 0.0), (SQ2, SQ2, 0.0), (0.0, 0.0, 1.0)), 0.17),
    (((SQ2, 0.0, -SQ2), (0.0, 1.0, 0.0), (SQ2, 0.0, SQ2)), 0.59),
)
# elements of one (copies, blocks, block, 3 block) distance slab
SLAB = 1 << 25


def _part1by2(x):
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _rotate(pos, rot):
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    return torch.stack([x * r[0] + y * r[1] + z * r[2] for r in rot], dim=-1)


def morton_keys(pos, shift=0.0, rot=None):
    """(N,) int32 keys of (N, 3) positions on a 1024^3 grid scaled by the
    largest axis span of the bounding box."""
    if rot is not None:
        pos = _rotate(pos, rot)
    lo, hi = pos.amin(0, keepdim=True), pos.amax(0, keepdim=True)
    span = torch.clamp((hi - lo).amax(-1, keepdim=True), min=1e-30)
    scale = torch.full_like(span, MAX_Q) / span
    q = torch.clamp((pos - lo) * scale + shift * MAX_Q, 0, MAX_Q).to(torch.int32)
    return _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)


def _nbits(ncols):
    return max((ncols - 1).bit_length(), 1)


def _pack(d2, cols, nbits):
    bits = torch.clamp(d2, min=TINY).view(torch.int32)
    return (bits & ~((1 << nbits) - 1)) | cols


def _unpack(keys, nbits):
    return (keys & ~((1 << nbits) - 1)).view(torch.float32)


def _select(cand, gid, k, b, include_self):
    """Per copy and query row, the k smallest packed keys over the 3 b
    candidates of its left, own and right blocks."""
    c_, L, _ = cand.shape
    nb = L // b - 2
    nbits = _nbits(3 * b)
    dev = cand.device
    rows = torch.arange(b, device=dev)[:, None]
    cols = torch.arange(3 * b, device=dev, dtype=torch.int32)[None, :]
    ids = torch.empty((c_, nb * b, k), dtype=torch.int32, device=dev)
    d2s = torch.empty((c_, nb * b, k), dtype=torch.float32, device=dev)
    step = max(1, SLAB // (c_ * b * 3 * b))
    for i0 in range(0, nb, step):
        i1 = min(nb, i0 + step)
        win = cand[:, i0 * b:(i1 + 2) * b].unfold(1, 3 * b, b)  # (C, m, 3, 3b)
        q = cand[:, (i0 + 1) * b:(i1 + 1) * b].reshape(c_, i1 - i0, b, 3)
        dx = win[:, :, None, 0, :] - q[..., 0:1]
        dy = win[:, :, None, 1, :] - q[..., 1:2]
        dz = win[:, :, None, 2, :] - q[..., 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        bad = d2 >= BAD_D2
        if not include_self:
            bad = bad | (cols == rows + b)
        d2 = torch.where(bad, INF, torch.clamp(d2, min=0.0))
        keys = torch.topk(_pack(d2, cols, nbits), k, dim=-1, largest=False, sorted=True).values
        g = gid[:, i0 * b:(i1 + 2) * b].unfold(1, 3 * b, b)  # (C, m, 3b)
        sel = (keys & ((1 << nbits) - 1)).long()
        ids[:, i0 * b:i1 * b] = torch.gather(
            g[:, :, None, :].expand(-1, -1, b, -1), 3, sel).reshape(c_, -1, k)
        d2s[:, i0 * b:i1 * b] = _unpack(keys, nbits).reshape(c_, -1, k)
    return ids, d2s


def _merge(cand, d2, k):
    """Per row the k nearest unique ids among all copies' candidates."""
    w = cand.shape[1]
    nbits = _nbits(w)
    cols = torch.arange(w, device=cand.device, dtype=torch.int32)[None, :]
    keys = _pack(torch.clamp(d2, min=0.0), cols, nbits)
    ids, vals = [], []
    for _ in range(k):
        mn = keys.amin(dim=1, keepdim=True)
        pid = torch.where(keys == mn, cand, 0).sum(1, keepdim=True).to(torch.int32)
        ids.append(pid[:, 0])
        vals.append(mn[:, 0])
        keys = torch.where(cand == pid, INF_BITS, keys)
    return torch.stack(ids, 1), _unpack(torch.stack(vals, 1), nbits)


def _dense_small(pos, k, include_self):
    n = pos.shape[0]
    d = pos[None, :, :] - pos[:, None, :]
    d2 = (d * d).sum(-1)
    if not include_self:
        d2 = torch.where(torch.eye(n, dtype=torch.bool, device=pos.device), INF, d2)
    vals, sel = torch.sort(d2, dim=-1, stable=True)
    valid = vals[:, :k] < BAD_D2
    return torch.where(valid, sel[:, :k], 0).to(torch.int32), valid


def knn(pos, k, include_self=False, block=256, n_copies=4, window=64):
    """(idx (N, k) int32, valid (N, k) bool) of one scene's (N, 3)
    positions: the nearest k along ``n_copies`` Morton curves, or the exact
    k nearest where one dense block covers the scene (N <= max(2 window +
    1, 2 block))."""
    n = pos.shape[0]
    k = min(k, n)
    if n <= max(2 * window + 1, 2 * block):
        return _dense_small(pos, k, include_self)
    b = block
    keys = torch.stack([morton_keys(pos, shift=s, rot=r) for r, s in COPIES[:n_copies]])
    order = torch.sort(keys, dim=-1, stable=True).indices  # (C, N)
    npad = -(-n // b) * b
    c_ = order.shape[0]
    cand = torch.full((c_, npad + 2 * b, 3), BIG, dtype=torch.float32, device=pos.device)
    cand[:, b:b + n] = pos[order]
    sg = torch.full((c_, npad + 2 * b), n, dtype=torch.int32, device=pos.device)
    sg[:, b:b + n] = order.to(torch.int32)
    ids, d2 = _select(cand, sg, k, b, include_self)
    qg = sg[:, b:b + npad]
    # every copy's rows back in original order, the copies side by side
    slot = (torch.arange(c_, device=pos.device)[:, None] * (n + 1) + qg.long()).reshape(-1)
    idx_buf = torch.full((c_ * (n + 1), k), -1, dtype=torch.int32, device=pos.device)
    d2_buf = torch.full((c_ * (n + 1), k), INF, dtype=torch.float32, device=pos.device)
    idx_buf[slot] = ids.reshape(-1, k)
    d2_buf[slot] = d2.reshape(-1, k)

    def side_by_side(buf):
        return buf.view(c_, n + 1, k)[:, :n].permute(1, 0, 2).reshape(n, c_ * k).contiguous()

    idx, d2 = _merge(side_by_side(idx_buf), side_by_side(d2_buf), k)
    valid = d2 < BAD_D2
    idx = torch.where(valid, idx, 0)
    return torch.clamp(idx, 0, n - 1).to(torch.int32), valid


def radius(pos, r, k_max=32, include_self=True, block=256, n_copies=4):
    """Neighbours within ``r`` among the nearest ``k_max`` of the Morton
    search, the cut ``d^2 < r^2`` taken on distances recomputed from the
    positions, with r^2 squared in float32."""
    idx, valid = knn(pos, min(k_max, pos.shape[0]), include_self=include_self,
                     block=block, n_copies=n_copies)
    d = pos[idx.long()] - pos[:, None, :]
    d2 = (d * d).sum(-1)
    r2 = float(torch.tensor(float(r), dtype=torch.float32) ** 2)
    valid = valid & (d2 < r2)
    return torch.where(valid, idx, 0).to(torch.int32), valid


def graph(spec, pos):
    """The graph a configuration's ``graph`` block asks for, on (N, 3)
    positions."""
    if spec["kind"] == "knn":
        return knn(pos, spec["k"], include_self=spec["include_self"], block=spec["block"],
                   n_copies=spec["n_copies"], window=spec["window"])
    return radius(pos, spec["radius"], k_max=spec["k_max"], include_self=spec["include_self"],
                  block=spec["block"], n_copies=spec["n_copies"])
