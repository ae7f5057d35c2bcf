"""Block-multipole treecodes ("Barnes-Hut-lite") — the port of
``nbody_tpu/ops/treeforce.py``, the classical engines past ~10^5 bodies.

Particles are sorted along a Morton curve and cut into ``nb`` blocks of
``B`` rows (the nodes of a one-level adaptive tree). Every block keeps an
exact softened interaction with its ``M = n_near`` worst-separated blocks;
every other block pulls through its monopole + traceless quadrupole about
its centre of mass:

    a = G [ -M r / s^3  +  Q r / s^5  -  (5/2) (r^T Q r) r / s^7 ],
    s^2 = r^2 + eps^2,  r = particle - COM,

evaluated over all blocks in one pass, with the near set's multipole pull
subtracted again (no double counting). ``bh2`` adds a coarse far level of
superblocks of ``coarse`` blocks, refined per receiver group (``rc`` of
them); ``bh3`` splits the near pass into sub-blocks of ``sub_block`` rows,
``n_sub`` of them exact per receiver block and the rest through their own
quadrupoles. The partition (sort + selections) may be stale: forces always
use fresh positions under the stored assignment.

Two near-pass implementations, named as the port names them elsewhere:

- ``near_impl="dense"`` (JAX ``"xla"``): the norm-expansion near pass with
  the 1e-10 floor, and every multipole term in plain torch
  (:func:`multipole_acc_torch`, :func:`grouped_multipole_acc_torch`), in
  chunks of ``i_chunk`` receiver blocks. Differentiable by autograd.
- ``near_impl="kernel"`` (JAX ``"pallas"``): three hand-written CUDA
  kernels, each launched once per force evaluation over all receivers: B9
  :func:`multipole_acc` (far field, replaces the Pallas
  ``_multipole_kernel``), B10 :func:`grouped_multipole_acc` (per-group block
  lists: the bh2/bh3 refinement, the near-set subtraction and bh3's
  sub-block multipoles; replaces ``_grouped_multipole_kernel``; its block
  shape follows the group size, :func:`grouped_plan`), both in
  ``nbody_tpu_torch/csrc/treeforce.cu``, and B1's near-list form
  :func:`nbody_tpu_torch.ops.pairwise.near_accelerations` (exact
  differences, B1's 1e-18 floor). ``i_chunk`` does not apply. For CPU
  tensors the wrappers run their plain versions.
- ``near_impl="auto"``: ``kernel`` for CUDA tensors, ``dense`` otherwise.

The JAX package carries payloads through ``lax.sort`` because a row gather
is slow on a TPU; here sorts are ``torch.sort(stable=True)`` and payloads
are gathers. ``inv_rank`` stays in the partitions, so that they compare
field by field with the JAX package's.

A group of S scenes of equal shape, stacked on a leading axis (``(S, N, 3)``
positions, ``(S, N)`` masses), is what ``jax.vmap`` of a treecode computes:
the partitions get a leading S on every field, the engines give ``(S, N,
3)``, and on the card each kernel launches once for the whole group, the
scene on a grid dimension. Scene s gets the bits of a call on scene s alone.
The Morton sorts and the selections run over the group (stable sorts, so
their results are unique), as do the gathers and the elementwise work. The
block moments, centres and radii and the two small matrix products (the
quadrupoles' and the opening criterion's) run scene by scene: a torch
reduction's launch shape, and so its order of additions, depends on how
many sums it makes (on the card, for fewer than 16-32 blocks a scene), and
a batched product may take another cuBLAS kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from nbody_tpu_torch.ops import build
from nbody_tpu_torch.ops.pairwise import (_scenes, _with_scene_axis, near_accelerations,
                                          scene_chunks)
from nbody_tpu_torch.ops.spatial import _INF, _select_k, morton_keys

_ADJ = 4  # structural near-window half-width (see build_bh_partition)
# Floor under the softened squared distance of the dense near pass and of
# the multipole terms: at softening 0 a self-pair (or a receiver on a
# block's COM) has d2 == 0, and inv^7 must stay finite in float32 (1e-10
# gives inv^7 ~ 1e35). The zero displacement then cancels the coefficient.
_D2_FLOOR = 1e-10
NEAR_IMPLS = ("dense", "kernel", "auto")
# (receiver, block) pairs per step of the multipole twins
_TWIN_PAIRS = 1 << 22
# B9's and B10's launch shape, MP_THREADS and MP_RPT of csrc/treeforce.cu (a CPU test
# holds them equal): threads a block, receivers a thread
_MP_THREADS, _MP_RPT = 256, 4
# B9's and B10's lanes a receiver group, widest block first: 256 receivers a block,
# or 128 for the 128-receiver groups of bh3's near pass
_MP_LANES = (4, 8)
# elements of one slab of rows that a partition's selection sorts at once
# (a (nb, nb) sort at 10M bodies, B = 512, would hold 4.6 GB of results)
_SORT_ELEMS = 1 << 26
# bytes of (nb, nb) float32 matrices, one a scene, that a group's partition
# build holds at once; a larger group is built in chunks of scenes (bh3 at
# 1M bodies, B = 128: 245 MB a scene, so 4 scenes a chunk)
_GROUP_PAIR_BYTES = 1 << 30

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load_library("treeforce")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.multipole_far.argtypes = [ptr, ptr, i32, i32, i32, i32, f32, f32, ptr, ptr]
        lib.multipole_far.restype = i32
        lib.multipole_grouped.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, f32, ptr, ptr]
        lib.multipole_grouped.restype = i32
        _LIB = lib
    return _LIB


def load_kernels() -> None:
    """Build (or load) the treecodes' kernels now (B9, B10 and B1's two
    forms), e.g. before a timed region."""
    build.load_all(["pairwise", "treeforce"])
    _lib()


# ------------------------------------------------------------- partitions

class BHPartition(NamedTuple):
    """Morton partition of the particle set (of a group: every field with a
    leading scene axis).

    :param sorted_gid: (nb*B,) int32 — original row of each sorted slot; pad
        slots carry ``n`` and sit at the end.
    :param near: (nb, M) int32 — block ids of each block's exact set.
    :param inv_rank: (n,) int32 — sorted slot of each original row.
    """

    sorted_gid: torch.Tensor
    near: torch.Tensor
    inv_rank: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.near.shape[-2]


class BH2Partition(NamedTuple):
    """:class:`BHPartition` (near sets restricted to refined regions) plus
    ``refined`` (nbc, rc) int32: the superblocks each receiver group
    evaluates at fine level."""

    sorted_gid: torch.Tensor
    near: torch.Tensor
    inv_rank: torch.Tensor
    refined: torch.Tensor

    @property
    def base(self) -> BHPartition:
        return BHPartition(self.sorted_gid, self.near, self.inv_rank)

    @property
    def n_blocks(self) -> int:
        return self.near.shape[-2]


class BH3Partition(NamedTuple):
    """:class:`BH2Partition` plus the sub-block split of the near pass:
    ``sub_near`` (nb, K) int32 global sub-block ids (fine block * S + s)
    evaluated exactly, ``sub_far`` (nb, M*S - K) the rest, through their
    multipoles. S = (K + U) / M; Bs = B / S."""

    sorted_gid: torch.Tensor
    near: torch.Tensor
    inv_rank: torch.Tensor
    refined: torch.Tensor
    sub_near: torch.Tensor
    sub_far: torch.Tensor

    @property
    def base(self) -> BHPartition:
        return BHPartition(self.sorted_gid, self.near, self.inv_rank)

    @property
    def n_blocks(self) -> int:
        return self.near.shape[-2]


def partition_from_numpy(fields: dict, device=None):
    """A partition given as numpy arrays by field name (for instance a JAX
    package partition's ``_asdict()``, also of one made under ``jax.vmap``,
    whose fields have a leading scene axis) as the port's NamedTuple of
    int32 tensors on ``device``; the kind follows from the fields."""
    kind = (BH3Partition if "sub_near" in fields else
            BH2Partition if "refined" in fields else BHPartition)
    return kind(**{f: torch.tensor(fields[f], dtype=torch.int32, device=device)
                   for f in kind._fields})


def _rows_of(x, idx, lead):
    """``x[idx]`` over the row axis of one scene (``lead == ()``), or of each
    scene of a group (``lead == (S,)``, a leading scene axis on both)."""
    if not lead:
        return x[idx]
    scene = torch.arange(lead[0], device=x.device).view(-1, *([1] * (idx.dim() - 1)))
    return x[scene, idx]


def _sorted_payload(pos, mass, nb, block):
    """The Morton sort of the JAX partitions: (sorted_gid padded with n,
    inv_rank, sorted positions and masses zero-padded to nb * block rows),
    each scene of a group on its own curve."""
    lead, n = pos.shape[:-2], pos.shape[-2]
    order = torch.sort(morton_keys(pos), stable=True).indices
    pad = nb * block - n
    sg = order.to(torch.int32)
    sg_p = torch.cat([sg, torch.full(lead + (pad,), n, dtype=torch.int32,
                                     device=pos.device)], dim=-1)
    inv_rank = torch.empty_like(sg).scatter_(
        -1, order, torch.arange(n, dtype=torch.int32, device=pos.device).expand_as(sg))
    spos = torch.cat([_rows_of(pos, order, lead), pos.new_zeros(lead + (pad, 3))], dim=-2)
    sm = torch.cat([_rows_of(mass, order, lead), mass.new_zeros(lead + (pad,))], dim=-1)
    return sg_p, inv_rank, spos, sm


def _gather_sorted(pos, mass, partition):
    """Fresh positions and masses in sorted-slot order; pad slots (end of
    slot space) get zero mass."""
    lead, n = pos.shape[:-2], pos.shape[-2]
    pad = partition.sorted_gid.shape[-1] - n
    sg = partition.sorted_gid[..., :n].long()
    return (torch.cat([_rows_of(pos, sg, lead), pos.new_zeros(lead + (pad, 3))], dim=-2),
            torch.cat([_rows_of(mass, sg, lead), mass.new_zeros(lead + (pad,))], dim=-1))


def _unsort_acc(acc, partition):
    """Sorted-slot accelerations back to original row order."""
    return _rows_of(acc, partition.inv_rank.long(), acc.shape[:-2])


def _scene_by_scene(fn, group: bool, *xs):
    """``fn`` on one scene's tensors ``xs``, or on each scene of a group (a
    leading scene axis on every one of ``xs``) with its outputs stacked:
    the reductions and small products that a batch could round otherwise
    (see the module notes)."""
    if not group:
        return fn(*xs)
    outs = [fn(*one) for one in zip(*xs)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(f) for f in zip(*outs))
    return torch.stack(outs)


def _block_moments(spos, smass, nb, block):
    """Per-block rows, masses, mass, COM and traceless quadrupole (pads are
    inert); a group's fields have a leading scene axis."""
    lead = spos.shape[:-2]
    bp = spos.reshape(*lead, nb, block, 3)
    bm = smass.reshape(*lead, nb, block)
    return (bp, bm, *_scene_by_scene(_moments, bool(lead), bp, bm))


def _moments(bp, bm):
    """One scene's block masses, COMs and traceless quadrupoles."""
    msum = bm.sum(1)
    com = (bm[..., None] * bp).sum(1) / torch.clamp(msum, min=1e-30)[:, None]
    d = bp - com[:, None, :]
    outer = torch.einsum("nba,nbc->nac", bm[..., None] * d, d)  # sum m d d^T
    tr = outer.diagonal(dim1=1, dim2=2).sum(-1)
    quad = 3.0 * outer - tr[:, None, None] * torch.eye(3, dtype=bp.dtype, device=bp.device)
    return msum, com, quad


def _blk_rows(com, msum, quad):
    """(K, 10) block rows [com_xyz, msum, Qxx, Qyy, Qzz, Qxy, Qxz, Qyz], the
    table B9 and B10 read: JAX ``_blkT`` as rows ((S, K, 10) for a group)."""
    return torch.stack([
        com[..., 0], com[..., 1], com[..., 2], msum,
        quad[..., 0, 0], quad[..., 1, 1], quad[..., 2, 2],
        quad[..., 0, 1], quad[..., 0, 2], quad[..., 1, 2],
    ], dim=-1).contiguous()


def _com_radius(bpos, bm):
    """Per-block mass, COM and bounding radius about the COM (a group's
    scene by scene)."""
    return _scene_by_scene(_com_radius_one, bpos.dim() == 4, bpos, bm)


def _com_radius_one(bpos, bm):
    msum = bm.sum(1)
    com = (bm[..., None] * bpos).sum(1) / torch.clamp(msum, min=1e-30)[:, None]
    d = bpos - com[:, None, :]
    rad = torch.sqrt(torch.where(bm > 0, (d * d).sum(-1), 0.0).amax(1))
    return msum, com, rad


def _sep2(com, rad):
    """(K, K) squared inverse opening angle d^2 / (rad_i + rad_j)^2, d^2 from
    the norm expansion with a full-float32 matmul, as in the JAX package;
    (S, K, K) for a group, scene by scene."""
    return _scene_by_scene(_sep2_one, com.dim() == 3, com, rad)


def _sep2_one(com, rad):
    """One scene's (K, K) matrix, in place: two (K, K) floats alive at once
    (1.53 GB each at 10M bodies, B = 512), the arithmetic of
    ``clamp(|a|^2 + |b|^2 - 2 a.b, 0) / clamp((r_a + r_b)^2, 1e-30)``."""
    sq = (com * com).sum(1)
    d2 = sq[:, None] + sq[None, :]
    d2.sub_((com @ com.T).mul_(2.0))
    den = (rad[:, None] + rad[None, :]).pow_(2).clamp_(min=1e-30)
    return d2.clamp_(min=0.0).div_(den)


def _sub_sep2(cand, com_b, rad_b, msum_s, com_s, rad_s):
    """One scene's opening criterion of each receiver block against its
    candidate sub-blocks ``cand`` (nb, M * S); empty sub-blocks at ``_INF``."""
    diff = com_b[:, None, :] - com_s[cand]
    sep2 = torch.clamp((diff * diff).sum(-1), min=0.0) / torch.clamp(
        (rad_b[:, None] + rad_s[cand]) ** 2, min=1e-30)
    return torch.where(msum_s[cand] > 0, sep2, _INF)


def _force_band(sep2, half: int):
    """``sep2`` (..., K, K) with -1 written in place on its band |i - j| <=
    ``half`` (the forced curve window): its diagonals, no (K, K) index
    matrix."""
    for off in range(-min(half, sep2.shape[-1] - 1), min(half, sep2.shape[-1] - 1) + 1):
        sep2.diagonal(off, dim1=-2, dim2=-1).fill_(-1.0)
    return sep2


def _select_rows(sep2, k: int):
    """The indices of :func:`_select_k` (a stable sort a row) in slabs of
    rows of at most ``_SORT_ELEMS`` elements: a (K, K) sort's float values,
    int64 indices and scratch never exist whole. A row's result does not
    depend on the slab."""
    rows = max(1, _SORT_ELEMS // max(sep2.shape[-1], 1))
    if sep2.shape[-2] <= rows:
        return _select_k(sep2, k)[0]
    # each slab's k columns copied out, so that its whole sort is freed
    return torch.cat([_select_k(sep2[..., r0:r0 + rows, :], k)[0].contiguous()
                      for r0 in range(0, sep2.shape[-2], rows)], dim=-2)


def _in_scene_chunks(build_one, pos, mass, nb: int, **knobs):
    """``build_one(pos, mass, **knobs)`` on one scene, or on a group in chunks
    of scenes whose (nb, nb) float32 matrices together stay within
    ``_GROUP_PAIR_BYTES``, the fields concatenated over the chunks."""
    if pos.dim() == 2:
        return build_one(pos, mass, **knobs)
    step = max(1, _GROUP_PAIR_BYTES // (4 * nb * nb))
    parts = [build_one(pos[s0:s0 + step], mass[s0:s0 + step], **knobs)
             for s0 in range(0, pos.shape[0], step)]
    return type(parts[0])(*(torch.cat(f) for f in zip(*parts)))


@torch.no_grad()
def build_bh_partition(pos, mass, n_near: int = 16, block: int = 256) -> BHPartition:
    """Sort into Morton order and pick every block's ``n_near`` worst
    separated blocks (self included: separation 0) by the opening criterion
    d^2 / (rad_i + rad_j)^2; the +-``_ADJ`` curve window is always near
    (straggler guard). O(N log N) sort + O(nb^2) block pass. A group
    ``(S, N, 3)``, ``(S, N)`` gives every field a leading S, each scene's
    the fields of its own partition."""
    return _in_scene_chunks(_bh_partition, pos, mass, -(-pos.shape[-2] // block),
                            n_near=n_near, block=block)


def _bh_partition(pos, mass, n_near, block):
    lead, n = pos.shape[:-2], pos.shape[-2]
    nb = -(-n // block)
    n_near = min(n_near, nb)
    sg_p, inv_rank, spos, sm = _sorted_payload(pos, mass, nb, block)
    _, com, rad = _com_radius(spos.reshape(*lead, nb, block, 3),
                              sm.reshape(*lead, nb, block))
    sep2 = _force_band(_sep2(com, rad), min(_ADJ, (n_near - 1) // 2))
    sel = _select_rows(sep2, n_near)
    return BHPartition(sorted_gid=sg_p, near=sel.to(torch.int32), inv_rank=inv_rank)


def _bh2_partition_arrays(pos, mass, n_near, block, coarse, rc, w):
    """Shared core of the bh2 and bh3 partitions: the Morton sort, the refined
    superblock selection and the fine near selection restricted to refined
    parents. Returns ``(sg_p, near, inv_rank, refined, spos, sm)``."""
    assert coarse >= _ADJ and w >= 1, \
        "structural fine window must stay inside the forced coarse window"
    lead, n = pos.shape[:-2], pos.shape[-2]
    dev = pos.device
    nb = _bh2_blocks(n, block, coarse)
    nbc = nb // coarse
    n_near = min(n_near, nb)
    rc = min(rc, nbc)
    if nbc > 2 and rc < 3:
        # the forced +-_ADJ fine window can cross a superblock boundary;
        # exact telescoping needs that parent refined, i.e. (rc-1)//2 >= 1
        raise ValueError(
            f"build_bh2_partition needs rc >= 3 (got rc={rc} with {nbc} "
            f"superblocks) — the forced +-{_ADJ}-block fine near window must "
            "stay inside refined parents")
    # only rc*coarse fine blocks are allowed per receiver
    n_near = min(n_near, rc * coarse)
    sg_p, inv_rank, spos, sm = _sorted_payload(pos, mass, nb, block)

    def sep_matrix(k_blocks, blk_rows):  # empty blocks at _INF, in place
        msum, com, rad = _com_radius(spos.reshape(*lead, k_blocks, blk_rows, 3),
                                     sm.reshape(*lead, k_blocks, blk_rows))
        return _sep2(com, rad).masked_fill_(~(msum > 0)[..., None, :], _INF)

    sep2c = _force_band(sep_matrix(nbc, coarse * block), min(w, (rc - 1) // 2))
    refined = _select_rows(sep2c, rc)
    del sep2c

    # fine blocks outside the refined parents at _INF, through a (nbc, nbc)
    # mask broadcast over the superblocks' (coarse, coarse) tiles
    outside = torch.ones(lead + (nbc, nbc), dtype=torch.bool, device=dev)
    outside.scatter_(-1, refined, False)
    sep2f = sep_matrix(nb, block)
    sep2f.view(*lead, nbc, coarse, nbc, coarse).masked_fill_(
        outside[..., :, None, :, None], _INF)
    del outside
    near = _select_rows(_force_band(sep2f, min(_ADJ, (n_near - 1) // 2)), n_near)
    return (sg_p, near.to(torch.int32), inv_rank, refined.to(torch.int32), spos, sm)


def _bh2_blocks(n: int, block: int, coarse: int) -> int:
    """Fine blocks of the bh2 and bh3 partitions: whole superblocks."""
    nb = -(-n // block)
    return -(-nb // coarse) * coarse


@torch.no_grad()
def build_bh2_partition(pos, mass, n_near: int = 16, block: int = 256,
                        coarse: int = 16, rc: int = 32, w: int = 1) -> BH2Partition:
    """Two-level partition: fine blocks (padded to whole superblocks),
    per-group refined superblocks by the coarse opening criterion (+- ``w``
    curve window forced), fine near sets restricted to refined parents so
    the two-level far field telescopes exactly. Empty (all-pad) blocks and
    superblocks are masked out of both selections. A group gives every
    field a leading scene axis, as :func:`build_bh_partition`."""
    return _in_scene_chunks(_bh2_partition, pos, mass, _bh2_blocks(pos.shape[-2], block, coarse),
                            n_near=n_near, block=block, coarse=coarse, rc=rc, w=w)


def _bh2_partition(pos, mass, n_near, block, coarse, rc, w):
    sg_p, near, inv_rank, refined, _, _ = _bh2_partition_arrays(
        pos, mass, n_near, block, coarse, rc, w)
    return BH2Partition(sorted_gid=sg_p, near=near, inv_rank=inv_rank, refined=refined)


@torch.no_grad()
def build_bh3_partition(pos, mass, n_near: int = 16, block: int = 256,
                        coarse: int = 16, rc: int = 32, sub_block: int = 32,
                        n_sub: int = 24, w: int = 1) -> BH3Partition:
    """:func:`build_bh2_partition` plus the exact/multipole split of each
    receiver block's near sub-blocks. ``n_sub`` is clamped to [3*S, M*S]:
    the receiver's own +-1 curve-block window (3*S subs) is always exact. A
    group gives every field a leading scene axis."""
    if block % sub_block:
        raise ValueError(f"sub_block={sub_block} must divide block={block}")
    return _in_scene_chunks(_bh3_partition, pos, mass, _bh2_blocks(pos.shape[-2], block, coarse),
                            n_near=n_near, block=block, coarse=coarse, rc=rc,
                            sub_block=sub_block, n_sub=n_sub, w=w)


def _bh3_partition(pos, mass, n_near, block, coarse, rc, sub_block, n_sub, w):
    lead, s = pos.shape[:-2], block // sub_block
    sg_p, near, inv_rank, refined, spos, sm = _bh2_partition_arrays(
        pos, mass, n_near, block, coarse, rc, w)
    nb, m = near.shape[-2:]
    n_sub = max(min(3 * s, m * s), min(n_sub, m * s))
    msum_s, com_s, rad_s = _com_radius(spos.reshape(*lead, nb * s, sub_block, 3),
                                       sm.reshape(*lead, nb * s, sub_block))
    _, com_b, rad_b = _com_radius(spos.reshape(*lead, nb, block, 3),
                                  sm.reshape(*lead, nb, block))

    # candidates: every sub-block of every near block, in near-set order
    cand = (near.long()[..., None] * s
            + torch.arange(s, device=pos.device)).reshape(*lead, nb, m * s)
    sep2 = _scene_by_scene(_sub_sep2, bool(lead), cand, com_b, rad_b, msum_s, com_s, rad_s)
    forced = (cand // s - torch.arange(nb, device=pos.device)[:, None]).abs() <= 1
    sep2 = torch.where(forced, -1.0, sep2)
    order = cand.gather(-1, torch.sort(sep2, dim=-1, stable=True).indices).to(torch.int32)
    return BH3Partition(sorted_gid=sg_p, near=near, inv_rank=inv_rank, refined=refined,
                        sub_near=order[..., :n_sub].contiguous(),
                        sub_far=order[..., n_sub:].contiguous())


# ----------------------------------------------------------- B9 and B10

def _pull(q, blk, g_const, eps2):
    """The multipole pull of block rows ``blk`` (..., K, 10) on receivers
    ``q`` (..., P, 3) -> (..., P, 3): JAX ``_multipole_tile``'s arithmetic,
    summed over K."""
    b = blk[..., None, :, :]
    r = q[..., :, None, :] - b[..., 0:3]  # (..., P, K, 3)
    rx, ry, rz = r.unbind(-1)
    m = b[..., 3]
    qxx, qyy, qzz, qxy, qxz, qyz = b[..., 4:10].unbind(-1)
    s2 = rx * rx + ry * ry + rz * rz + eps2
    inv = torch.rsqrt(torch.clamp(s2, min=_D2_FLOOR))
    inv2 = inv * inv
    inv3 = inv * inv2
    inv5 = inv3 * inv2
    inv7 = inv5 * inv2
    qr_x = qxx * rx + qxy * ry + qxz * rz
    qr_y = qxy * rx + qyy * ry + qyz * rz
    qr_z = qxz * rx + qyz * ry + qzz * rz
    rqr = qr_x * rx + qr_y * ry + qr_z * rz
    cr = -m * inv3 - 2.5 * rqr * inv7
    return g_const * torch.stack([(cr * rx + inv5 * qr_x).sum(-1),
                                  (cr * ry + inv5 * qr_y).sum(-1),
                                  (cr * rz + inv5 * qr_z).sum(-1)], dim=-1)


def multipole_acc_torch(q, table, g_const, eps2):
    """Plain-torch version of B9 (see :func:`multipole_acc`), in row chunks:
    no (P, K, 3) intermediate. A group runs scene by scene."""
    if table.dim() == 3:
        return _scene_by_scene(lambda qs, ts: multipole_acc_torch(qs, ts, g_const, eps2), True,
                               q, table)
    rows = max(1, _TWIN_PAIRS // max(table.shape[0], 1))
    outs = [_pull(q[r0:r0 + rows], table, g_const, eps2)
            for r0 in range(0, q.shape[0], rows)]
    return torch.cat(outs) if outs else torch.zeros_like(q)


def multipole_acc(q, table, g_const, eps2):
    """B9: the monopole + quadrupole pull (P, 3) of every row of the block
    table ``table`` (K, 10) (see :func:`_blk_rows`) on receivers ``q``
    (P, 3); the port of ``pallas_multipole_acc``. Zero rows are inert. The
    kernel is B10's receiver loop over one group of all P receivers and
    every row in order (:func:`grouped_plan` ``(1, P)``), so it equals
    :func:`grouped_multipole_acc` given the list ``0 .. K - 1``.

    A group of S scenes, ``q`` (S, P, 3) and ``table`` (S, K, 10), gives
    (S, P, 3) in one launch (one a ``pairwise.scene_chunks`` chunk), the
    scene on the grid's y and each scene with the blocks, and the bits, of a
    call on it alone."""
    if build.on_cpu(q, table):
        return multipole_acc_torch(q, table, g_const, eps2)
    lead = _scenes(table)
    p, k = q.shape[-2], table.shape[-2]
    build.check("q", q, lead + (p, 3))
    build.check("table", table, lead + (k, 10))
    acc = torch.empty_like(q)
    scenes = lead[0] if lead else 1
    if p * scenes == 0:
        return acc
    qs, rows, out = _with_scene_axis(lead, q, table, acc)
    with torch.cuda.device(q.device):
        for s0, s1 in scene_chunks(scenes):
            rc = _lib().multipole_far(qs[s0].data_ptr(), rows[s0].data_ptr(), s1 - s0, p, k,
                                      grouped_plan(1, p)["lanes"], float(g_const),
                                      float(eps2), out[s0].data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
            build.raise_on(rc, "multipole_far launch")
            multipole_acc.launches += 1
    return acc


multipole_acc.launches = 0


def _listed_rows(table, ids):
    """``table[ids]`` with an id outside [0, K) read as a zero row, as the
    kernels read it."""
    k = table.shape[0]
    if k == 0:
        return table.new_zeros((*ids.shape, table.shape[1]))
    valid = (ids >= 0) & (ids < k)
    return table[ids.clamp(0, k - 1).long()] * valid[..., None]


def grouped_multipole_acc_torch(q, table, ids, g_const, eps2):
    """Plain-torch version of B10 (see :func:`grouped_multipole_acc`), in
    chunks of groups and rows. A group of scenes runs scene by scene, each
    id read against its own scene's table."""
    if table.dim() == 3:
        return _scene_by_scene(lambda qs, ts, js: grouped_multipole_acc_torch(
            qs, ts, js, g_const, eps2), True, q, table, ids)
    groups, p, _ = q.shape
    s = ids.shape[1]
    rows = max(1, min(p, _TWIN_PAIRS // max(s, 1)))
    step = max(1, _TWIN_PAIRS // max(rows * s, 1))
    outs = []
    for g0 in range(0, groups, step):
        blk = _listed_rows(table, ids[g0:g0 + step])  # (gc, S, 10)
        outs.append(torch.cat([_pull(q[g0:g0 + step, r0:r0 + rows], blk, g_const, eps2)
                               for r0 in range(0, p, rows)], dim=1))
    return torch.cat(outs) if outs else torch.zeros_like(q)


def grouped_plan(groups: int, p: int) -> dict:
    """B10's launch for ``groups`` groups of ``p`` receivers (and B9's, as
    one group of all receivers): ``lanes`` lanes
    a receiver group (the first of ``_MP_LANES`` whose block, ``_MP_THREADS
    // lanes * _MP_RPT`` receivers of one group, is no larger than ``p``;
    else the narrowest), ``tiles`` blocks a group and ``blocks`` in all.
    Block ``b`` holds receivers ``(b % tiles) * receivers ..`` of group ``b
    // tiles`` (``pull_receivers`` in csrc/treeforce.cu)."""
    lanes = next((n for n in _MP_LANES if _MP_THREADS // n * _MP_RPT <= p), _MP_LANES[-1])
    recv = _MP_THREADS // lanes * _MP_RPT
    tiles = -(-p // recv)
    return {"lanes": lanes, "receivers": recv, "tiles": tiles, "blocks": groups * tiles}


def grouped_multipole_acc(q, table, ids, g_const, eps2):
    """B10: per group g, the pull (G, P, 3) of the table rows ``ids[g, :]``
    (G, S) int32 on that group's receivers ``q[g]`` (G, P, 3); one launch
    for all groups (:func:`grouped_plan`). The kernel gathers the rows by
    id: no (G, S, 10) copy (the JAX entry ``pallas_grouped_multipole_acc``
    takes one). An id outside [0, K) reads as a zero row.

    A group of S scenes, ``q`` (S, G, P, 3), ``table`` (S, K, 10) and ``ids``
    (S, G, L), gives (S, G, P, 3) in one launch (one a
    ``pairwise.scene_chunks`` chunk), the scene on the grid's y:
    scene s's ids read scene s's table, an id outside [0, K) as a zero row
    (never a row of another scene), and each scene has the blocks, and the
    bits, of a call on it alone."""
    if build.on_cpu(q, table, ids):
        return grouped_multipole_acc_torch(q, table, ids, g_const, eps2)
    lead = _scenes(table)
    groups, p = q.shape[-3], q.shape[-2]
    k, s = table.shape[-2], ids.shape[-1]
    build.check("q", q, lead + (groups, p, 3))
    build.check("table", table, lead + (k, 10))
    build.check("ids", ids, lead + (groups, s), torch.int32)
    acc = torch.empty_like(q)
    scenes = lead[0] if lead else 1
    if groups * p * scenes == 0:
        return acc
    qs, rows, lists, out = _with_scene_axis(lead, q, table, ids, acc)
    with torch.cuda.device(q.device):
        for s0, s1 in scene_chunks(scenes):
            rc = _lib().multipole_grouped(
                qs[s0].data_ptr(), rows[s0].data_ptr(), lists[s0].data_ptr(), s1 - s0,
                groups, p, s, k, grouped_plan(groups, p)["lanes"], float(g_const),
                float(eps2), out[s0].data_ptr(), torch.cuda.current_stream().cuda_stream)
            build.raise_on(rc, "multipole_grouped launch")
            grouped_multipole_acc.launches += 1
    return acc


grouped_multipole_acc.launches = 0


# ---------------------------------------------------------------- engines

def _resolve(near_impl, t):
    if near_impl not in NEAR_IMPLS:
        raise ValueError(f"unknown near_impl {near_impl!r}: one of {NEAR_IMPLS}")
    if near_impl == "auto":
        return "kernel" if t.device.type == "cuda" else "dense"
    return near_impl


def _mult_fns(kernel: bool):
    """(B9, B10) entries of the near impl: the kernel wrappers, or their
    plain versions called directly (the dense path, on any device)."""
    if kernel:
        return multipole_acc, grouped_multipole_acc
    return multipole_acc_torch, grouped_multipole_acc_torch


def _dense_exact(q_blocks, ids, cand_pos, cand_m, g, eps2, i_chunk):
    """Exact near pass of the dense impl: each receiver block (nbl, R, 3)
    against the rows of its listed candidate blocks ``cand_pos[ids]``, from
    the norm expansion with the 1e-10 floor, ``i_chunk`` blocks at a time
    (the (i_chunk * R, L * Bs) tile is the peak intermediate). A group runs
    scene by scene."""
    if q_blocks.dim() == 4:
        return _scene_by_scene(lambda *one: _dense_exact(*one, g, eps2, i_chunk), True,
                               q_blocks, ids, cand_pos, cand_m)
    outs = []
    for i0 in range(0, q_blocks.shape[0], i_chunk):
        idc = ids[i0:i0 + i_chunk].long()
        q = q_blocks[i0:i0 + i_chunk]
        c = cand_pos[idc].flatten(1, 2)  # (ic, L * Bs, 3)
        w_m = cand_m[idc].flatten(1, 2)
        d2 = ((q * q).sum(-1)[..., None] + (c * c).sum(-1)[:, None, :]
              - 2.0 * torch.bmm(q, c.transpose(1, 2)))
        inv = torch.rsqrt(torch.clamp(torch.clamp(d2, min=0.0) + eps2, min=_D2_FLOOR))
        w = w_m[:, None, :] * (inv * inv * inv)
        outs.append(g * (torch.bmm(w, c) - q * w.sum(-1, keepdim=True)))
    return torch.cat(outs)


def bh_sorted_range_acc(spos, sm, near, g_const, softening, blk0: int, nbl: int,
                        i_chunk: int = 8, near_impl: str = "dense"):
    """Accelerations (nbl*B, 3), in sorted order, of the ``nbl`` receiver
    blocks from block ``blk0`` — the shardable core of
    :func:`bh_accelerations`.

    :param spos/sm: (nb*B, 3)/(nb*B,) sorted positions and masses
        (zero-mass pads ok). :param near: (nb, M) near sets of ALL blocks.
        A group of scenes has a leading scene axis on all three, and on the
        result.
    """
    kernel = _resolve(near_impl, spos) == "kernel"
    lead, (nb, m) = spos.shape[:-2], near.shape[-2:]
    b = spos.shape[-2] // nb
    g, eps2 = float(g_const), float(softening) ** 2
    blk_pos, blk_m, msum, com, quad = _block_moments(spos, sm, nb, b)
    table = _blk_rows(com, msum, quad)
    q_blocks = blk_pos[..., blk0:blk0 + nbl, :, :].contiguous()
    near_r = near[..., blk0:blk0 + nbl, :].contiguous()
    rows = q_blocks.reshape(*lead, nbl * b, 3)
    mult, grouped = _mult_fns(kernel)

    far = mult(rows, table, g, eps2)
    if kernel:
        a_exact = near_accelerations(q_blocks, spos, sm, near_r, b, g, softening)
    else:
        a_exact = _dense_exact(q_blocks, near_r, blk_pos, blk_m, g, eps2, i_chunk)
    a_nm = grouped(q_blocks, table, near_r, g, eps2)
    return far + (a_exact - a_nm).reshape(*lead, nbl * b, 3)


def bh_accelerations(pos, mass, g_const, softening,
                     partition: Optional[BHPartition] = None, n_near: int = 16,
                     block: int = 256, i_chunk: int = 8, near_impl: str = "auto"):
    """Approximate softened accelerations (N, 3), O(N (M B + N / B)). A
    group of scenes, ``(S, N, 3)`` and ``(S, N)`` with a group partition,
    gives ``(S, N, 3)``: on the card each kernel launches once for the group.

    :param partition: reusable (possibly stale) :class:`BHPartition`; built
        from ``pos`` when None. Moments and distances use fresh positions.
    :param i_chunk: receiver blocks per step of the dense near pass.
    :param near_impl: "kernel", "dense" or "auto" (see the module notes).
    """
    if partition is None:
        partition = build_bh_partition(pos, mass, n_near=n_near, block=block)
    spos, sm = _gather_sorted(pos, mass, partition)
    acc = bh_sorted_range_acc(spos, sm, partition.near, g_const, softening, 0,
                              partition.n_blocks, i_chunk=i_chunk, near_impl=near_impl)
    return _unsort_acc(acc, partition)


def _two_level_far(rows, spos, sm, table_f, refined, nb, b, blk0, nbl, g, eps2,
                   kernel):
    """bh2/bh3 far field of the receiver range: every superblock's pull,
    then each group's refined superblocks swapped for their fine blocks
    (telescoped refinement)."""
    lead, (nbc, rc) = spos.shape[:-2], refined.shape[-2:]
    coarse = nb // nbc
    assert nb % nbc == 0 and nbl % coarse == 0 and blk0 % coarse == 0
    gr = nbl // coarse
    mult, grouped = _mult_fns(kernel)
    _, _, msum_c, com_c, quad_c = _block_moments(spos, sm, nbc, coarse * b)
    table_c = _blk_rows(com_c, msum_c, quad_c)
    refined_r = refined[..., blk0 // coarse:blk0 // coarse + gr, :].contiguous()
    fine_ids = (refined_r[..., None] * coarse
                + torch.arange(coarse, dtype=refined.dtype, device=refined.device)
                ).reshape(*lead, gr, rc * coarse).contiguous()
    qg = rows.reshape(*lead, gr, coarse * b, 3)
    far = mult(rows, table_c, g, eps2)
    far_g = (grouped(qg, table_f, fine_ids, g, eps2)
             - grouped(qg, table_c, refined_r, g, eps2))
    return far + far_g.reshape(*lead, nbl * b, 3)


def bh2_sorted_range_acc(spos, sm, near, refined, g_const, softening, blk0: int,
                         nbl: int, i_chunk: int = 8, near_impl: str = "dense"):
    """Two-level accelerations (nbl*B, 3), sorted order, for ``nbl`` receiver
    blocks from block ``blk0`` (both multiples of the coarse factor nb/nbc,
    so receiver groups align with superblocks)."""
    kernel = _resolve(near_impl, spos) == "kernel"
    lead, (nb, m) = spos.shape[:-2], near.shape[-2:]
    b = spos.shape[-2] // nb
    g, eps2 = float(g_const), float(softening) ** 2
    blk_pos, blk_m, msum, com, quad = _block_moments(spos, sm, nb, b)
    table_f = _blk_rows(com, msum, quad)
    q_blocks = blk_pos[..., blk0:blk0 + nbl, :, :].contiguous()
    near_r = near[..., blk0:blk0 + nbl, :].contiguous()
    rows = q_blocks.reshape(*lead, nbl * b, 3)
    far = _two_level_far(rows, spos, sm, table_f, refined, nb, b, blk0, nbl, g, eps2,
                         kernel)
    if kernel:
        a_exact = near_accelerations(q_blocks, spos, sm, near_r, b, g, softening)
    else:
        a_exact = _dense_exact(q_blocks, near_r, blk_pos, blk_m, g, eps2, i_chunk)
    a_nm = _mult_fns(kernel)[1](q_blocks, table_f, near_r, g, eps2)
    return far + (a_exact - a_nm).reshape(*lead, nbl * b, 3)


def bh2_accelerations(pos, mass, g_const, softening,
                      partition: Optional[BH2Partition] = None, n_near: int = 16,
                      block: int = 256, coarse: int = 16, rc: int = 32,
                      i_chunk: int = 8, near_impl: str = "auto"):
    """Two-level block-multipole accelerations, O(N (M B + N/(C B) + rc C)):
    the one-level engine with the far field over superblocks, refined per
    receiver group. :param partition: reusable :class:`BH2Partition`."""
    if partition is None:
        partition = build_bh2_partition(pos, mass, n_near=n_near, block=block,
                                        coarse=coarse, rc=rc)
    spos, sm = _gather_sorted(pos, mass, partition)
    acc = bh2_sorted_range_acc(spos, sm, partition.near, partition.refined, g_const,
                               softening, 0, partition.n_blocks, i_chunk=i_chunk,
                               near_impl=near_impl)
    return _unsort_acc(acc, partition)


def bh3_sorted_range_acc(spos, sm, near, refined, sub_near, sub_far, g_const,
                         softening, blk0: int, nbl: int, i_chunk: int = 8,
                         near_impl: str = "dense"):
    """Sub-refined two-level accelerations (nbl*B, 3), sorted order: bh2's
    far field, and the near pass as exact(sub_near) + sub_mult(sub_far) -
    fine_mult(near)."""
    kernel = _resolve(near_impl, spos) == "kernel"
    lead, (nb, m) = spos.shape[:-2], near.shape[-2:]
    b = spos.shape[-2] // nb
    k_sel, u = sub_near.shape[-1], sub_far.shape[-1]
    s = (k_sel + u) // m
    assert s * m == k_sel + u and b % s == 0
    bs = b // s
    g, eps2 = float(g_const), float(softening) ** 2
    blk_pos, _, msum, com, quad = _block_moments(spos, sm, nb, b)
    sub_pos, sub_m, msum_s, com_s, quad_s = _block_moments(spos, sm, nb * s, bs)
    table_f = _blk_rows(com, msum, quad)
    q_blocks = blk_pos[..., blk0:blk0 + nbl, :, :].contiguous()
    near_r = near[..., blk0:blk0 + nbl, :].contiguous()
    sel_r = sub_near[..., blk0:blk0 + nbl, :].contiguous()
    far_r = sub_far[..., blk0:blk0 + nbl, :].contiguous()
    rows = q_blocks.reshape(*lead, nbl * b, 3)
    far = _two_level_far(rows, spos, sm, table_f, refined, nb, b, blk0, nbl, g, eps2,
                         kernel)
    grouped = _mult_fns(kernel)[1]
    if kernel:
        a_exact = near_accelerations(q_blocks, spos, sm, sel_r, bs, g, softening)
    else:
        a_exact = _dense_exact(q_blocks, sel_r, sub_pos, sub_m, g, eps2, i_chunk)
    acc = a_exact - grouped(q_blocks, table_f, near_r, g, eps2)
    if u:
        acc = acc + grouped(q_blocks, _blk_rows(com_s, msum_s, quad_s), far_r, g, eps2)
    return far + acc.reshape(*lead, nbl * b, 3)


def bh3_accelerations(pos, mass, g_const, softening,
                      partition: Optional[BH3Partition] = None, n_near: int = 16,
                      block: int = 256, coarse: int = 16, rc: int = 32,
                      sub_block: int = 32, n_sub: int = 24, i_chunk: int = 8,
                      near_impl: str = "auto"):
    """Sub-refined two-level accelerations, O(N (K Bs + M S + N/(C B) +
    rc C)): :func:`bh2_accelerations` with the near pass's M B exact pairs
    cut to K Bs plus (M S - K) sub-quadrupoles. ``sub_block``/``n_sub`` are
    implied by a given partition's shapes."""
    if partition is None:
        partition = build_bh3_partition(pos, mass, n_near=n_near, block=block,
                                        coarse=coarse, rc=rc, sub_block=sub_block,
                                        n_sub=n_sub)
    spos, sm = _gather_sorted(pos, mass, partition)
    acc = bh3_sorted_range_acc(spos, sm, partition.near, partition.refined,
                               partition.sub_near, partition.sub_far, g_const, softening,
                               0, partition.n_blocks, i_chunk=i_chunk,
                               near_impl=near_impl)
    return _unsort_acc(acc, partition)
