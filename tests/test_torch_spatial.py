"""The port's Morton search (``nbody_tpu_torch/ops/spatial.py``) and radius
search against the JAX package on the same numpy inputs.

Bars and their sources:

- Morton keys: bit for bit (int32 bit operations on the same float32
  quantisation).
- ``knn_morton``: ``impl="kernel"`` (the B7/B8 twins) against JAX
  ``impl="pallas_interpret"`` and ``impl="dense"`` against JAX ``"xla"``:
  identical (ids, valid) on >= 99.9 % of rows, and every differing row a
  near-tie, its sorted neighbour distances equal to 2^-12 relative (the
  packed-key truncation of ``nbody_tpu/ops/spatial.py:247-249``).
- Recall >= 0.99 against exact kNN (``tests/test_spatial.py:69-76,132-141``).
- Mask, self and no-duplicate cases as in ``tests/test_spatial.py:89-165``.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ics import generate_spiral as jgenerate_spiral
from nbody_tpu.ops import radius as jradius
from nbody_tpu.ops import spatial as jsp
from nbody_tpu_torch.experiments.select_bench import merge_edge_rows
from nbody_tpu_torch.ics import generate_disk, generate_spiral
from nbody_tpu_torch.utils import prng
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.ops import knn as tknn
from nbody_tpu_torch.ops import radius as tradius
from nbody_tpu_torch.ops import spatial as tsp
from nbody_tpu_torch.train.graphs import build_graph

JAX_IMPL = {"kernel": "pallas_interpret", "dense": "xla"}


def _spiral_np(n, seed):
    import jax

    return np.array(jgenerate_spiral(jax.random.PRNGKey(seed), n)[0])


def _d2(pos, r, ids):
    d = pos[ids].astype(np.float64) - pos[r].astype(np.float64)
    return np.sort((d * d).sum(-1))


def _assert_same_or_near_tie(pos, got, want):
    gi, gv = (t.numpy() for t in got)
    wi, wv = (np.asarray(t) for t in want)
    assert gi.shape == wi.shape and gi.dtype == np.int32
    same = (gi == wi).all(1) & (gv == wv).all(1)
    assert same.mean() >= 0.999, same.mean()
    for r in np.nonzero(~same)[0]:
        np.testing.assert_allclose(_d2(pos, r, gi[r][gv[r]]), _d2(pos, r, wi[r][wv[r]]),
                                   rtol=2.0 ** -12)


def _recall(got, want):
    gi, gv = (t.numpy() for t in got)
    wi, wv = (t.numpy() for t in want)
    hits = tot = 0
    for a, va, b, vb in zip(gi, gv, wi, wv):
        exact = set(b[vb].tolist())
        hits += len(exact & set(a[va].tolist()))
        tot += len(exact)
    return hits / max(tot, 1)


@functools.lru_cache(maxsize=None)
def _spiral_500k():
    return _spiral_np(500_000, 0)


@pytest.mark.parametrize("copy", range(4))
def test_morton_keys_bit_for_bit(copy):
    """Also at 500,000 bodies of the 2M-10M artifacts' ICs, where a scale
    rounded otherwise than JAX's once put 53 keys a quantum away."""
    rot, shift = jsp._COPIES[copy]
    for pos in (_spiral_np(3000, 1), _spiral_500k()):
        mask = np.arange(len(pos)) < len(pos) - 100
        for m in (None, mask):
            want = np.asarray(jsp.morton_keys(jnp.asarray(pos),
                                              None if m is None else jnp.asarray(m),
                                              shift=shift, rot=rot))
            got = tsp.morton_keys(torch.from_numpy(pos),
                                  None if m is None else torch.from_numpy(m),
                                  shift=shift, rot=rot)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("k,include_self", [(10, False), (32, True), (40, False)])
def test_knn_morton_matches_jax(impl, k, include_self):
    pos = np.random.default_rng(k).normal(size=(2000, 3)).astype(np.float32)
    # unique keys on the unshifted curve; the shifted copies tie only where
    # the shift clips a coordinate at the box edge, and both packages' sorts
    # keep tied rows in row order
    keys = tsp.morton_keys(torch.from_numpy(pos)).numpy()
    assert len(np.unique(keys)) == len(keys)
    kw = dict(block=128) if impl == "kernel" else {}
    want = jsp.knn_morton(jnp.asarray(pos), k, include_self=include_self,
                          impl=JAX_IMPL[impl], **kw)
    got = tsp.knn_morton(torch.from_numpy(pos), k, include_self=include_self,
                         impl=impl, **kw)
    _assert_same_or_near_tie(pos, got, want)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_knn_morton_masked_matches_jax(impl):
    pos = _spiral_np(1500, 2)
    mask = np.arange(1500) < 1400
    kw = dict(block=128) if impl == "kernel" else dict(window=32, block=128)
    want = jsp.knn_morton(jnp.asarray(pos), 6, mask=jnp.asarray(mask),
                          impl=JAX_IMPL[impl], **kw)
    got = tsp.knn_morton(torch.from_numpy(pos), 6, mask=torch.from_numpy(mask),
                         impl=impl, **kw)
    _assert_same_or_near_tie(pos, got, want)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("maker", [generate_disk, generate_spiral])
def test_knn_morton_recall(impl, maker):
    pos, _, _ = maker(prng.PRNGKey(11), 3000)
    exact = tknn.knn_neighbors(pos, 10)
    got = tsp.knn_morton(pos, 10, block=128, impl=impl)
    assert _recall(got, exact) >= 0.99


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_knn_morton_mask_self_dedup(impl):
    kw = dict(block=128) if impl == "kernel" else dict(window=16, block=128)
    pos = torch.from_numpy(np.random.default_rng(7).normal(size=(900, 3)).astype(np.float32))
    mask = torch.arange(900) < 800
    idx, valid = tsp.knn_morton(pos, 4, mask=mask, impl=impl, **kw)
    assert not (idx[valid] >= 800).any()
    assert not valid[800:].any()
    idx_s, valid_s = tsp.knn_morton(pos, 4, include_self=True, impl=impl, **kw)
    assert torch.equal(idx_s[:, 0], torch.arange(900, dtype=torch.int32))
    assert valid_s.all()
    idx_d, valid_d = tsp.knn_morton(pos, 10, impl=impl, **kw)
    for i in range(0, 900, 7):
        ids = idx_d[i][valid_d[i]].tolist()
        assert len(ids) == len(set(ids))


def test_small_n_branch_matches_jax_and_exact():
    pos = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    mask = np.arange(50) < 40
    for m, inc in ((None, False), (mask, False), (None, True)):
        want = jsp.knn_morton(jnp.asarray(pos), 4, include_self=inc,
                              mask=None if m is None else jnp.asarray(m))
        got = tsp.knn_morton(torch.from_numpy(pos), 4, include_self=inc,
                             mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    exact = tknn.knn_neighbors(torch.from_numpy(pos), 5)
    assert _recall(tsp.knn_morton(torch.from_numpy(pos), 5, impl="kernel"), exact) == 1.0


def test_batched_knn_morton_and_build_graph():
    pos = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 700, 3)).astype(np.float32))
    idx, valid = tsp.batched_knn_morton(pos, 5, block=128, impl="kernel")
    assert idx.shape == (2, 700, 5)
    idx1, _ = tsp.knn_morton(pos[1], 5, block=128, impl="kernel")
    assert torch.equal(idx[1], idx1)
    idx_b, _ = build_graph(("knn", {"k": 5, "method": "morton", "block": 128,
                                    "impl": "kernel"}), pos)
    assert torch.equal(idx_b, idx)
    m = GraphModel(neighbors=10, knn_method="morton", knn_impl="kernel", knn_window=48)
    kind, kw = m.graph_spec
    assert kind == "knn" and kw == {"k": 10, "include_self": False, "method": "morton",
                                    "window": 48, "block": 256, "n_copies": 4,
                                    "impl": "kernel"}
    with pytest.raises(ValueError):
        tsp.knn_morton(pos[0], 5, impl="pallas")
    with pytest.raises(ValueError):
        tsp.knn_morton(pos[0], 5, impl="kernel", block=700)


@pytest.mark.parametrize("method,impl", [("exact", "dense"), ("morton", "dense"),
                                         ("morton", "kernel")])
def test_radius_neighbors_match_jax(method, impl):
    pos = _spiral_np(1200, 4)
    mask = np.arange(1200) < 1150
    kw = dict(method=method, impl=JAX_IMPL[impl]) if method == "morton" else {}
    want = jradius.radius_neighbors(jnp.asarray(pos), 1.0, 32, mask=jnp.asarray(mask), **kw)
    got = tradius.radius_neighbors(torch.from_numpy(pos), 1.0, 32,
                                   mask=torch.from_numpy(mask), method=method, impl=impl)
    if method == "exact":  # top-k tie order may differ: compare neighbour sets
        for a, va, b, vb in zip(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                                np.asarray(want[1])):
            assert sorted(a[va].tolist()) == sorted(b[vb].tolist())
    else:
        _assert_same_or_near_tie(pos, got, want)
    b_idx, b_valid = tradius.batched_radius_neighbors(
        torch.from_numpy(pos)[None], 1.0, 32, method=method, impl=impl)
    assert b_idx.shape == (1, 1200, 32)
    assert not got[1][1150:].any()


_EMPTY = (1 << 32) - 1


def _walk(nchunk, own):
    """B7's chunk order for one warp (csrc/spatial.cu): its own chunk, then
    right and left in turn, the rest of one side when the other runs out."""
    order, left, right = [own], own, own + 1
    for step in range(1, nchunk):
        if right < nchunk and (left == 0 or step & 1):
            order.append(right)
            right += 1
        else:
            left -= 1
            order.append(left)
    return order


def _select_walk_plain(cand, k, block, include_self):
    """A plain version of B7's walk, all warps of every block at once (a
    partial last warp padded with lanes that never keep a candidate, as the
    kernel's are): each warp's 32-column chunks in the kernel's order; per
    chunk each lane keeps the candidates whose d2 is under its threshold's
    distance and whose key is under its threshold (its k-th key at the last
    merge), merges them into its K sorted keys (K - k zeros, then its k
    smallest), and takes its new threshold, the last of them. A chunk that
    the kernel skips (every lane's box distance above its threshold) must
    hold no kept candidate. Above k = 32 the walk runs once a slab of 32
    outputs, keeping only keys above the last key of the slab before.
    Returns (ids, d2) as ``morton_select_torch`` does."""
    if k > 32:
        c_, L, _ = cand.shape
        nq = (L // block - 2) * block
        ids = torch.empty((c_, nq, k), dtype=torch.int32)
        d2s = torch.empty((c_, nq, k), dtype=torch.float32)
        floor = None
        for j0 in range(0, k, 32):
            ks = min(32, k - j0)
            ids[..., j0:j0 + ks], d2s[..., j0:j0 + ks], floor = _select_slab_plain(
                cand, ks, block, include_self, floor)
        return ids, d2s
    return _select_slab_plain(cand, k, block, include_self, None)[:2]


def _select_slab_plain(cand, k, block, include_self, floor):
    """One slab of :func:`_select_walk_plain`: the k smallest keys above
    ``floor`` (None: all), with each lane's last key (its top[K - 1])."""
    c_, L, _ = cand.shape
    b = block
    nb = L // b - 2
    ncol, nbits = 3 * b, tsp._nbits(3 * b)
    cm = (1 << nbits) - 1
    K = 8 if k <= 8 and floor is None else 16 if k <= 16 and floor is None else 32
    nchunk, nwarp = -(-ncol // 32), -(-b // 32)
    win = cand.unfold(1, ncol, b)[:, :, :3].permute(0, 1, 3, 2)  # (C, nb, 3b, 3)
    gid = cand[..., 3].contiguous().view(torch.int32).unfold(1, ncol, b)  # (C, nb, 3b)
    r = torch.arange(nwarp * 32).reshape(nwarp, 32)
    live = r < b
    q = win[:, :, torch.where(live, b + r, b)]  # (C, nb, W, 32, 3)
    top = torch.full((c_, nb, nwarp, 32, K), _EMPTY, dtype=torch.long)
    top[..., :K - k] = 0  # below every packed key
    thr = torch.where(live, _EMPTY, 0).expand(c_, nb, -1, -1)
    thr_d2 = torch.where(live, float("inf"), -1.0).expand(c_, nb, -1, -1)
    walks = torch.tensor([_walk(nchunk, (b + 32 * w) // 32) for w in range(nwarp)])
    skipped = 0
    for step in range(nchunk):
        cols = walks[:, step, None] * 32 + torch.arange(32)  # (W, 32)
        valid = cols < ncol
        p = win[:, :, cols.clamp(max=ncol - 1)]  # (C, nb, W, 32 columns, 3)
        d = [p[:, :, :, None, :, a] - q[..., a, None] for a in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]  # (C, nb, W, lanes, columns)
        bad = d2 >= tsp._BAD_D2
        if not include_self:
            bad = bad | (cols[:, None, :] == (b + r)[:, :, None])
        keys = tsp._pack(torch.where(bad, tsp._INF, torch.clamp(d2, min=0.0)),
                         cols[:, None, :].to(torch.int32), nbits).long()
        keep = ~(d2 > thr_d2[..., None]) & (keys < thr[..., None]) & valid[:, None, :]
        if floor is not None:
            keep = keep & (keys > floor[..., None])
        lo = torch.where(valid[..., None], p, float("inf")).amin(3)  # (C, nb, W, 3)
        hi = torch.where(valid[..., None], p, float("-inf")).amax(3)
        g = torch.clamp(torch.maximum(lo[:, :, :, None] - q, q - hi[:, :, :, None]), min=0.0)
        lb = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]
        skip = (lb > thr_d2).all(-1)  # (C, nb, W)
        assert not keep[skip].any()
        skipped += int(skip.sum())
        merged = torch.cat([top, torch.where(keep, keys, _EMPTY)], -1)
        top = torch.sort(merged, -1).values[..., :K]
        thr = torch.where(live, top[..., K - 1], 0)
        hi_d2 = (thr | cm).to(torch.int32).view(torch.float32)
        thr_d2 = torch.where(live, torch.where(thr >= tsp._INF_BITS & ~cm, float("inf"), hi_d2),
                             -1.0)
    sel = top[..., K - k:].reshape(c_, nb, nwarp * 32, k)[:, :, :b]
    assert (sel < _EMPTY).all() and (skipped > 0 or floor is not None)
    ids = torch.gather(gid, 2, (sel & cm).reshape(c_, nb, -1)).reshape(c_, nb * b, k)
    return (ids, (sel & ~cm).to(torch.int32).view(torch.float32).reshape(c_, nb * b, k),
            top[..., K - 1])


@functools.lru_cache(maxsize=None)
def _window_candidates(n, block):
    """B7's input for a spiral of ``n`` bodies, 5% of them masked: their
    sentinels sit in curve order, inside windows."""
    pos, _, _ = generate_spiral(prng.PRNGKey(6), n)
    mask = torch.ones(n, dtype=torch.bool)
    mask[torch.randperm(n, generator=torch.Generator().manual_seed(n))[:n // 20]] = False
    order = tsp._curve_order(pos, None, 4)
    return tsp._candidates(torch.where(mask[:, None], pos, tsp._BIG), order, block)[0]


@pytest.mark.parametrize("n,block,k,include_self", [
    *((1500, 128, k, inc) for k, inc in ((1, False), (8, False), (10, True), (17, False),
                                         (32, True), (32, False))),
    *((2100, 256, k, inc) for k, inc in ((8, False), (10, False), (16, True), (32, True))),
    (1400, 682, 10, False), (1400, 682, 32, True),
    (700, 128, 40, False), (700, 128, 72, True), (700, 128, 65, False),
])
def test_b7_walk_gives_the_plain_selection(n, block, k, include_self):
    """The premise of B7's design on the CPU: its near-first walk, with
    thresholds that go stale within a chunk and per-chunk merges into K = 8,
    16 or 32 sorted keys, gives ``morton_select_torch``'s ids and d2 bits,
    with self columns in or out, sentinels of masked rows inside windows and
    the padding block after the last; above k = 32 in slabs of 32, each
    above the last key of the one before."""
    cand = _window_candidates(n, block)
    got = _select_walk_plain(cand, k, block, include_self)
    want = tsp.morton_select_torch(cand, k, block, include_self)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("k,include_self", [(10, False), (40, False), (40, True),
                                            (72, False)])
def test_select_plain_matches_jax_select_kernel(k, include_self):
    """``morton_select_torch`` equals the JAX ``_select_kernel`` (interpret
    mode, through ``_copy_passes_pallas``) id for id on the same sorted
    candidates, also past k = 32, where the kernel selects in slabs of 32;
    the distances agree to the packed keys' truncation, 2^-12 relative (XLA
    may contract the JAX kernel's d2 into FMAs, which the plain version's
    separate operations do not)."""
    pos = np.random.default_rng(k).normal(size=(700, 3)).astype(np.float32)
    block = 128
    _, j_ids, j_d2 = jsp._copy_passes_pallas(jnp.asarray(pos), k, block, 4, include_self,
                                             None, interpret=True)
    order = tsp._curve_order(torch.from_numpy(pos), None, 4)
    cand, _ = tsp._candidates(torch.from_numpy(pos), order, block)
    ids, d2 = tsp.morton_select_torch(cand, k, block, include_self)
    assert torch.equal(ids, torch.from_numpy(np.array(j_ids)))
    np.testing.assert_allclose(d2.numpy(), np.array(j_d2), rtol=2.0 ** -12, atol=0)


# --------------------------------------------------------------- B8's merge

@pytest.mark.parametrize("w,k", [(32, 8), (40, 10), (128, 32), (100, 7), (160, 40)])
def test_merge_plain_matches_jax_on_edge_rows(w, k):
    """``morton_merge_torch`` equals the JAX ``_merge_kernel`` (interpret
    mode) id for id and bit for bit on rows beyond B7's output: duplicates
    across and within copies, unsorted copies, rows with fewer than k
    unique ids (their wrapped id sums) and sentinels in the last column,
    the column mask at w = 32 and 128."""
    cand, d2 = merge_edge_rows(48, w, k, seed=w + k)
    got = tsp.morton_merge_torch(cand, d2, k)
    want = jsp._merge_pallas(jnp.asarray(cand.numpy()), jnp.asarray(d2.numpy()), k,
                             interpret=True, chunk=48)
    assert torch.equal(got[0], torch.from_numpy(np.array(want[0])))
    assert torch.equal(got[1].view(torch.int32),
                       torch.from_numpy(np.array(want[1])).view(torch.int32))
    assert (got[1] >= tsp._BAD_D2).any(1).float().mean() > 0.3  # exhausted rows met


def _merge_shape():
    """B8's launch constants, read from csrc/spatial.cu: lanes a row, rows
    a block, passes buffered before a write, the widest row; and its
    ``merge_stride``."""
    src = (Path(tsp.__file__).parents[1] / "csrc" / "spatial.cu").read_text()
    consts = {a: int(b) for a, b in re.findall(r"^constexpr int MERGE_(\w+) = (\d+);", src,
                                              re.M)}
    assert "return (w + 31) / 32 * 32 + lanes;" in src
    assert "merge_stride(w, MERGE_LANES)" in src
    return consts


def _merge_plan(w, k):
    """B8's launch for rows of ``w`` slots and ``k`` passes: each of the
    row's lanes holds ``slots`` slots (w / lanes rounded up to even, the
    kernel's template argument), the staged row ``stride`` (merge_stride)
    and the block's shared ``bytes``. A row wider than MAX_W takes the wide
    kernel: a warp a row (32 lanes), its w slots in shared memory."""
    c = _merge_shape()
    if w > c["MAX_W"]:
        return {"lanes": 32, "slots": -(-w // 32), "wide": True}
    lanes = c["LANES"]
    stride = -(-w // 32) * 32 + lanes
    return {"lanes": lanes, "slots": max(2, -(-w // (2 * lanes)) * 2), "stride": stride,
            "rows": c["ROWS"], "bytes": 4 * c["ROWS"] * (2 * stride + 2 * min(k, c["OUT"])),
            "wide": False}


def _merge_walk_plain(cand, d2, k):
    """A plain version of B8's walk (``merge_kernel`` in csrc/spatial.cu),
    every row at once: each row's slots padded to ``lanes * slots`` with
    empty ones (key above every packed key, id 0); per pass the row
    minimum, then, in a warp (``32 // lanes`` rows of a block) where any
    row's minimum is INF_BITS, the wrapped sum of the ids of every hit, and
    elsewhere the id staged at the minimum's column bits; then every slot
    holding the id, empty ones included, set to INF_BITS. A wide row (the
    wide kernel: a warp a row) has no empty slots. Asserts the premise of
    the read: where the minimum is not INF_BITS one live slot holds it, the
    one at its column. Returns (ids, d2) as ``morton_merge_torch`` does."""
    n, w = cand.shape
    plan = _merge_plan(w, k)
    lanes = plan["lanes"]
    width = w if plan["wide"] else lanes * plan["slots"]
    nbits = tsp._nbits(w)
    cm = (1 << nbits) - 1
    cols = torch.arange(w, dtype=torch.int32)[None, :]
    keys = torch.full((n, width), _EMPTY, dtype=torch.long)
    keys[:, :w] = tsp._pack(torch.clamp(d2, min=0.0), cols, nbits).long()
    ids = torch.zeros((n, width), dtype=torch.long)
    ids[:, :w] = cand.long()
    warp = torch.arange(n) // (32 // lanes)
    out_i, out_v = [], []
    for _ in range(k):
        mn = keys.amin(1)
        at_inf = mn == tsp._INF_BITS
        summed = torch.zeros(int(warp[-1]) + 1, dtype=torch.bool).index_put_(
            (warp,), at_inf, accumulate=True)[warp]
        total = torch.where(keys == mn[:, None], ids, 0).sum(1)
        total = (total + 2 ** 31) % 2 ** 32 - 2 ** 31  # int32 wrap
        col = torch.where(at_inf, 0, mn & cm)
        looked = ids.gather(1, col[:, None])[:, 0]
        single = ~at_inf
        assert (col[single] < w).all() and (keys == mn[:, None]).sum(1)[single].eq(1).all()
        assert torch.equal(total[single], looked[single])
        pid = torch.where(summed, total, looked)
        keys = torch.where(ids == pid[:, None], tsp._INF_BITS, keys)
        out_i.append(pid)
        out_v.append(mn & ~cm)
    vals = torch.stack(out_v, 1).to(torch.int32).view(torch.float32)
    return torch.stack(out_i, 1).to(torch.int32), vals


@pytest.mark.parametrize("n,w,k", [(200, 32, 8), (200, 40, 10), (200, 128, 32),
                                   (211, 100, 7), (90, 5, 3), (120, 96, 40),
                                   (150, 160, 40), (70, 300, 70), (40, 2048, 9)])
def test_b8_walk_gives_the_plain_merge(n, w, k):
    """The premise of B8's design on the CPU: its walk (the id read at the
    minimum's column, a sum only where a minimum is INF_BITS, empty pad
    slots) gives ``morton_merge_torch``'s ids and bits on the edge rows,
    infinite distances included, at w a power of two and not, and k past
    w; rows wider than 128 (k past 32 with 4 copies) on the wide kernel's
    walk, a warp a row, up to the 2048 columns of the packed keys."""
    cand, d2 = merge_edge_rows(n, w, k, seed=n + w, inf=True)
    got = _merge_walk_plain(cand, d2, k)
    want = tsp.morton_merge_torch(cand, d2, k)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("w", [1, 2, 5, 8, 31, 32, 33, 40, 64, 100, 127, 128])
def test_b8_plan_covers_each_slot_once(w):
    """B8's launch shape: every column of a row in exactly one (lane, slot),
    slots even and no more than the row needs, a staged row stride of at
    least w, a multiple of 4 (16-byte stores), at which a warp's lanes read
    distinct banks, and shared memory within the default 48 KiB for any
    k."""
    for k in (1, 8, 32, 40):
        plan = _merge_plan(w, k)
        lanes, slots, stride = plan["lanes"], plan["slots"], plan["stride"]
        assert slots % 2 == 0 and lanes * slots >= w and (slots == 2 or lanes * (slots - 2) < w)
        assert sorted(s * lanes + ln for s in range(slots) for ln in range(lanes)
                      if s * lanes + ln < w) == list(range(w))
        assert stride >= w and stride % 32 == lanes and stride % 4 == 0
        for s in range(slots):
            banks = {(g * stride + s * lanes + ln) % 32
                     for g in range(32 // lanes) for ln in range(lanes)}
            assert len(banks) == 32
        assert plan["bytes"] <= 48 * 1024


def test_b8_takes_the_widths_its_wrapper_takes():
    """The register kernel's widest row (128) is reached by its slots a lane
    (4 lanes of up to 32); wider rows take the wide kernel up to the
    wrapper's bound, 2048, the columns that the packed keys' 11 bits hold
    (JAX's ``_pack_d2_cols`` asserts the same)."""
    c = _merge_shape()
    assert c["MAX_W"] == 128 and _merge_plan(128, 32)["slots"] * c["LANES"] == 128
    assert c["MAX_WIDE"] == 2048 and tsp._nbits(2048) == 11 and tsp._nbits(2049) == 12
    assert _merge_plan(129, 40)["wide"] and not _merge_plan(128, 40)["wide"]
    src = Path(tsp.__file__).read_text()
    assert "0 < w <= 2048" in src
