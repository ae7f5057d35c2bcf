"""All-pairs softened gravity and pairwise potential energy — the port of
``nbody_tpu/ops/pairwise.py``.

Two kernels, both hand-written CUDA C++ for Hopper in
``nbody_tpu_torch/csrc/pairwise.cu``:

- B1, :func:`partial_accelerations`: the rectangular force of sources J on
  targets I (replaces the Pallas ``_force_kernel``), and its near-list form
  :func:`near_accelerations`, the treecodes' exact near pass: each receiver
  block against the source blocks of its list, read by id;
- B2, :func:`pair_potential`: the pairwise potential of one set (strict upper
  triangle) or of two disjoint sets (replaces the Pallas ``_energy_kernel``).

B1, its near-list form and B2 also take a group of scenes of equal shape,
stacked on a leading axis (``(S, N, 3)`` positions, ``(S, N)`` masses), in
one launch (one a chunk of :data:`MAX_SCENES` scenes past that many): what
``jax.vmap`` of the Pallas calls computes, scene by scene with the bits of
a single-scene call.

Each wrapper has a plain-torch twin of the same semantics in this module
(``*_torch``). A wrapper takes its twin only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. Each wrapper counts its kernel
launches in a plain integer attribute, ``<wrapper>.launches``, so a run can
show which kernels its path went through.

The public entry points keep the JAX package's names without the ``pallas_``
prefix: :func:`accelerations`, :func:`potential_energy`,
:func:`cross_potential` and :func:`chunked_potential_energy`. They fold a
validity mask into the masses (a zero-mass source exerts no force and has no
potential) and zero masked output rows, as the JAX entry points do.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from nbody_tpu_torch.ops import build

# rsqrt floor: keeps inv^3 finite for a coincident pair at softening 0, so
# the zero displacement cancels the self-pair exactly (as in the JAX kernel).
_D2_FLOOR = 1e-18
# distance floor of the potential: no 0/0 for coincident zero-mass slots.
_DIST_FLOOR = 1e-30
# target rows per block of the twins: O(rows * nj) memory, never (ni, nj, 3).
_TWIN_ROWS = 2048
# (target, source) pairs per step of the near-list twin
_TWIN_PAIRS = 1 << 22
# B1's launch shape, FORCE_ROWS and TILE of csrc/pairwise.cu (a CPU test holds
# them equal): targets a block, sources staged a step; its near-list form
# launches blocks of the same FORCE_ROWS targets
_B1_ROWS, _B1_TILE = 128, 256
# B1 cuts its sources into chunks only where the target tiles are fewer than
# this many blocks an SM, aims at _B1_SPLIT_BLOCKS blocks an SM when it does,
# and gives a chunk at least _B1_MIN_CHUNK sources
_B1_FULL_BLOCKS, _B1_SPLIT_BLOCKS, _B1_MIN_CHUNK = 4, 8, 16 * _B1_TILE
# B2's tiles and blocks an SM, E_ROWS (= E_TILE) and E_BLOCKS_PER_SM of
# csrc/pairwise.cu (a CPU test holds them equal): square tiles, so that
# masked only the diagonal tiles straddle i < j; at most as many blocks as
# fit on the SMs at once
_B2_TILE, _B2_BLOCKS_PER_SM = 128, 8

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load_library("pairwise")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nbody_force.argtypes = [ptr, ptr, i32, i32, i32, i32, f32, f32, ptr, ptr, ptr]
        lib.nbody_force.restype = i32
        lib.nbody_near_force.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, f32, ptr, ptr]
        lib.nbody_near_force.restype = i32
        lib.nbody_energy.argtypes = [
            ptr, ptr, i32, ptr, ptr, i32, ctypes.c_double, f32, i32, i32, i32, ptr, ptr,
            ptr, ptr]
        lib.nbody_energy.restype = i32
        _LIB = lib
    return _LIB


def load_kernels() -> None:
    """Build (or load) the kernels now, e.g. before a timed region."""
    _lib()


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).contiguous()


def _pack_sources(pos_j: torch.Tensor, mass_j: torch.Tensor) -> torch.Tensor:
    """(..., nj, 4) [x, y, z, m] scratch: one 16-byte float4 load per source.
    The wrappers may drop their scratch while a kernel still reads it: the
    caching allocator reuses that memory only for later work on the same
    stream, which runs after the kernel."""
    return torch.cat([pos_j, mass_j[..., None]], dim=-1)


# the most scenes one launch takes: the grid's y and z dimensions; a larger
# group launches in chunks of this many scenes (:func:`scene_chunks`)
MAX_SCENES = 65535


def _scenes(rows: torch.Tensor) -> tuple:
    """The leading scene axis of a kernel call, ``(S,)`` for a group's
    ``(S, N, c)`` rows (positions, a treecode's block table) or ``()`` for
    one scene's ``(N, c)``."""
    lead = tuple(rows.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"rows {tuple(rows.shape)}: one scene (N, c) or a group (S, N, c)")
    return lead


def scene_chunks(scenes: int) -> list:
    """The launches of a call on ``scenes`` scenes: ``(s0, s1)`` runs of at
    most :data:`MAX_SCENES` scenes, in order (the cap is read at the call).
    A kernel's blocks of one scene never read another scene, so every scene
    keeps the bits of a call on it alone in whichever chunk it falls."""
    return build.chunks(scenes, MAX_SCENES)


def _with_scene_axis(lead: tuple, *ts: torch.Tensor) -> list:
    """``ts`` with a leading scene axis: a group's as they are, one scene's
    as a group of one (the same memory), so a chunk of scenes is a slice."""
    return [t if lead else t[None] for t in ts]


def _per_scene(fn, *args):
    """``fn`` on each scene of a group (leading axis) stacked, or on one scene."""
    if args[0].dim() == 2:
        return fn(*args)
    return torch.stack([fn(*one) for one in zip(*args)])


# --------------------------------------------------------------------- B1

def partial_accelerations_torch(pos_i, pos_j, mass_j, g_const, softening):
    """Plain-torch twin of B1: exact coordinate differences, rsqrt^3 with the
    1e-18 floor, no self mask (a coincident pair adds an exact zero). A group
    of scenes (leading axis) runs scene by scene."""
    return _per_scene(lambda pi, pj, mj: _force_plain(pi, pj, mj, g_const, softening),
                      pos_i, pos_j, mass_j)


def _force_plain(pos_i, pos_j, mass_j, g_const, softening):
    ni = pos_i.shape[0]
    acc = torch.empty_like(pos_i)
    eps2 = float(softening) ** 2
    for r0 in range(0, ni, _TWIN_ROWS):
        d = pos_j[None, :, :] - pos_i[r0:r0 + _TWIN_ROWS, None, :]
        d2 = (d * d).sum(-1) + eps2
        inv = torch.rsqrt(torch.clamp(d2, min=_D2_FLOOR))
        w = inv * inv * inv * mass_j[None, :]
        acc[r0:r0 + _TWIN_ROWS] = g_const * (w[..., None] * d).sum(1)
    return acc


def force_work(ni: int, nj: int):
    """(FP32 operations, bytes) of B1 on ``ni`` targets and ``nj`` sources:
    ~20 operations a pair (csrc/pairwise.cu), the targets and the sources
    read once and the forces written once."""
    return 20.0 * ni * nj, 12.0 * ni + 16.0 * nj + 12.0 * ni


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, read once a device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def force_chunk(ni: int, nj: int, sms: int) -> int:
    """Sources a chunk of B1 for ``ni`` targets and ``nj`` sources on a card
    of ``sms`` SMs: ``max(nj, 1)`` (one chunk, one launch) unless the target
    tiles leave the card under ``_B1_FULL_BLOCKS`` blocks an SM; then chunks
    of whole tiles, as many as give about ``_B1_SPLIT_BLOCKS`` blocks an SM
    with at least ``_B1_MIN_CHUNK`` sources each. Chunk c holds sources ``c *
    chunk .. min(nj, (c + 1) * chunk) - 1``; their sums are added in chunk
    order."""
    if nj < 2 * _B1_MIN_CHUNK:  # too few sources for two chunks
        return max(nj, 1)
    tiles = -(-ni // _B1_ROWS)
    chunks = min(-(-_B1_SPLIT_BLOCKS * sms // max(tiles, 1)), nj // _B1_MIN_CHUNK)
    if tiles >= _B1_FULL_BLOCKS * sms or chunks <= 1:
        return max(nj, 1)
    return -(-nj // (chunks * _B1_TILE)) * _B1_TILE


def partial_accelerations(pos_i, pos_j, mass_j, g_const, softening):
    """Accelerations (Ni, 3) exerted on targets ``pos_i`` (Ni, 3) by sources
    ``(pos_j (Nj, 3), mass_j (Nj,))``; the port of
    ``pallas_partial_accelerations``. Float32, contiguous, one device.
    Ragged sizes need no padding: the kernel masks the last tile itself.
    Few targets over many sources split the sources over blocks
    (:func:`force_chunk`): a second launch adds the chunks in order.
    A group of S scenes, ``(S, Ni, 3)``, ``(S, Nj, 3)``, ``(S, Nj)``, gives
    ``(S, Ni, 3)`` in the same launches (a set of them for each
    :func:`scene_chunks` chunk), each scene with the chunks, and the bits,
    of a call on that scene alone."""
    if build.on_cpu(pos_i, pos_j, mass_j):
        return partial_accelerations_torch(pos_i, pos_j, mass_j, g_const, softening)
    lead = _scenes(pos_i)
    ni, nj = pos_i.shape[-2], pos_j.shape[-2]
    build.check("pos_i", pos_i, lead + (ni, 3))
    build.check("pos_j", pos_j, lead + (nj, 3))
    build.check("mass_j", mass_j, lead + (nj,))
    acc = torch.empty(lead + (ni, 3), dtype=torch.float32, device=pos_i.device)
    scenes = lead[0] if lead else 1
    if ni == 0 or scenes == 0:
        return acc
    chunk = force_chunk(ni, nj, _sm_count(pos_i.device.index))
    tgt, src, out = _with_scene_axis(lead, pos_i, _pack_sources(pos_j, mass_j), acc)
    with torch.cuda.device(pos_i.device):
        for s0, s1 in scene_chunks(scenes):
            partial = (torch.empty((s1 - s0, -(-nj // chunk), ni, 3), dtype=torch.float32,
                                   device=pos_i.device) if nj > chunk else None)
            rc = _lib().nbody_force(
                tgt[s0].data_ptr(), src[s0].data_ptr(), s1 - s0, ni, nj, chunk,
                float(g_const), float(softening),
                None if partial is None else partial.data_ptr(), out[s0].data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            build.raise_on(rc, "nbody_force launch")
            partial_accelerations.launches += 1
    return acc


partial_accelerations.launches = 0


def near_accelerations_torch(q, pos, mass, near, src_block, g_const, softening):
    """Plain-torch twin of B1's near-list form: per group, B1's twin
    arithmetic over the gathered candidates, in list order. An id outside
    [0, n_blocks) reads as a zero-mass block, as in the kernel. A group of
    scenes runs scene by scene, each scene's ids read against its own
    sources."""
    if pos.dim() == 3:
        return _per_scene(lambda p, m, qs, ns: near_accelerations_torch(
            qs, p, m, ns, src_block, g_const, softening), pos, mass, q, near)
    groups, rows, _ = q.shape
    eps2 = float(softening) ** 2
    bpos, bmass = pos.reshape(-1, src_block, 3), mass.reshape(-1, src_block)
    n_blocks = bpos.shape[0]
    if n_blocks == 0:  # every id out of range: no sources
        return torch.zeros_like(q)
    step = max(1, _TWIN_PAIRS // max(rows * near.shape[1] * src_block, 1))
    outs = []
    for g0 in range(0, groups, step):
        ids = near[g0:g0 + step].long()
        valid = (ids >= 0) & (ids < n_blocks)
        ids = ids.clamp(0, n_blocks - 1)
        d = bpos[ids].flatten(1, 2)[:, None, :, :] - q[g0:g0 + step, :, None, :]
        d2 = (d * d).sum(-1) + eps2
        inv = torch.rsqrt(torch.clamp(d2, min=_D2_FLOOR))
        m = (bmass[ids] * valid[..., None]).flatten(1, 2)
        w = inv * inv * inv * m[:, None, :]
        outs.append(g_const * (w[..., None] * d).sum(2))
    return torch.cat(outs) if outs else torch.zeros_like(q)


def near_accelerations(q, pos, mass, near, src_block: int, g_const, softening):
    """B1's near-list form: accelerations (G, R, 3) of the receiver groups
    ``q`` (G, R, 3), group g pulled by the source blocks ``near[g, :]`` (G, L)
    int32 of ``(pos (n_blocks * src_block, 3), mass (n_blocks * src_block,))``
    (block j is rows j * src_block .. j * src_block + src_block - 1). What
    ``jax.vmap(pallas_partial_accelerations)`` computes on the gathered
    candidates, with B1's exact differences and 1e-18 floor; one launch for
    all groups, reading candidates by id. The kernel runs B1's tile body on
    four targets a thread, so each group gets B1's sums on its gathered
    candidates in one chunk, bit for bit. An id outside [0, n_blocks)
    reads as a block of zero-mass sources.

    A group of S scenes, ``q`` (S, G, R, 3), ``pos`` (S, n_blocks *
    src_block, 3), ``mass`` (S, n_blocks * src_block) and ``near`` (S, G,
    L), gives (S, G, R, 3) in one launch (one a :func:`scene_chunks`
    chunk), the scene on the grid's y: scene
    s's ids are checked against scene s's own blocks (an id outside [0,
    n_blocks) is zero-mass sources, never a block of another scene), and
    each scene has the bits of a call on it alone."""
    if build.on_cpu(q, pos, mass, near):
        return near_accelerations_torch(q, pos, mass, near, src_block, g_const, softening)
    lead = _scenes(pos)
    groups, rows = q.shape[-3], q.shape[-2]
    n_blocks = pos.shape[-2] // max(src_block, 1)
    build.check("q", q, lead + (groups, rows, 3))
    build.check("pos", pos, lead + (n_blocks * src_block, 3))
    build.check("mass", mass, lead + (n_blocks * src_block,))
    build.check("near", near, lead + (groups, near.shape[-1]), torch.int32)
    acc = torch.empty_like(q)
    scenes = lead[0] if lead else 1
    if groups * rows * scenes == 0:
        return acc
    qs, src, ids, out = _with_scene_axis(lead, q, _pack_sources(pos, mass), near, acc)
    with torch.cuda.device(q.device):
        for s0, s1 in scene_chunks(scenes):
            rc = _lib().nbody_near_force(
                qs[s0].data_ptr(), src[s0].data_ptr(), ids[s0].data_ptr(), s1 - s0, groups,
                rows, near.shape[-1], int(src_block), n_blocks, float(g_const),
                float(softening), out[s0].data_ptr(), torch.cuda.current_stream().cuda_stream)
            build.raise_on(rc, "nbody_near_force launch")
            near_accelerations.launches += 1
    return acc


near_accelerations.launches = 0


def accelerations(pos, mass, g_const, softening, mask=None):
    """Softened direct-sum accelerations (N, 3) of one set through B1; the
    port of ``pallas_accelerations``. ``mask`` (N,) is folded into the
    masses, and masked rows of the result are zero. A group of scenes,
    ``(S, N, 3)`` and ``(S, N)``, gives ``(S, N, 3)``; the mask is shared."""
    pos, mass = _f32(pos), _f32(mass)
    if mask is not None:
        m01 = mask.to(pos.device, torch.float32)
        mass = mass * m01
    acc = partial_accelerations(pos, pos, mass, g_const, softening)
    if mask is not None:
        acc = acc * m01[:, None]
    return acc


# --------------------------------------------------------------------- B2

def pair_potential_torch(pos_i, mass_i, pos_j, mass_j, g_const, softening,
                         masked):
    """Plain-torch twin of B2: -G sum m_i m_j / max(d + eps, 1e-30) over the
    strict upper triangle (``masked``, one set) or over all pairs of two
    disjoint sets. Row blocks are summed in float64, like the kernel's
    reduction. A group of scenes (leading axis) gives ``(S,)``, scene by
    scene."""
    return _per_scene(lambda pi, mi, pj, mj: _potential_plain(
        pi, mi, pj, mj, g_const, softening, masked), pos_i, mass_i, pos_j, mass_j)


def _potential_plain(pos_i, mass_i, pos_j, mass_j, g_const, softening, masked):
    ni = pos_i.shape[0]
    total = torch.zeros((), dtype=torch.float64, device=pos_i.device)
    cols = torch.arange(pos_j.shape[0], device=pos_i.device)
    for r0 in range(0, ni, _TWIN_ROWS):
        rows = torch.arange(r0, min(r0 + _TWIN_ROWS, ni), device=pos_i.device)
        d = pos_j[None, :, :] - pos_i[rows][:, None, :]
        dist = torch.clamp(torch.sqrt((d * d).sum(-1)) + softening,
                           min=_DIST_FLOOR)
        pair = -(mass_i[rows][:, None] * mass_j[None, :]) / dist
        if masked:
            pair = torch.where(cols[None, :] > rows[:, None], pair, 0.0)
        total = total + pair.sum(dtype=torch.float64)
    return (g_const * total).to(torch.float32)


def energy_tiles(ni: int, nj: int, masked: bool, sms: int) -> dict:
    """B2's launch plan for ``ni`` targets and ``nj`` sources on a card of
    ``sms`` SMs: square tiles of ``_B2_TILE`` rows and sources, the tile
    items (masked: the tiles on and above the diagonal of one set, row-major;
    else every tile), and one launch of ``blocks`` blocks, block ``b``
    walking items ``b * items // blocks`` to ``(b + 1) * items // blocks - 1``
    (``energy_kernel`` in csrc/pairwise.cu)."""
    rt, ct = -(-ni // _B2_TILE), -(-nj // _B2_TILE)
    items = rt * ct - rt * (rt - 1) // 2 if masked else rt * ct
    return {"row_tiles": rt, "col_tiles": ct, "items": items,
            "blocks": max(1, min(items, _B2_BLOCKS_PER_SM * sms))}


# (device index, stream) -> B2's scratch: (tickets, one a scene and zero
# between calls; partials, room for the most blocks a launch gives a scene,
# a run of them a scene), for as many scenes as a call has asked for
_ENERGY_SCRATCH: dict = {}


def _energy_scratch(device: torch.device, stream: int, sms: int, scenes: int = 1):
    """The scratch of B2 launches on one stream, for ``scenes`` scenes: calls
    on one stream run one after another, so they can share it
    (csrc/pairwise.cu, B2). Its tickets are made zeroed on a stream's first
    call, and again when a call brings more scenes than it holds: those are
    the calls that launch a fill."""
    key = (device.index, stream)
    if key not in _ENERGY_SCRATCH or _ENERGY_SCRATCH[key][0].numel() < scenes:
        _ENERGY_SCRATCH[key] = (
            torch.zeros(scenes, dtype=torch.int32, device=device),
            torch.empty(scenes * _B2_BLOCKS_PER_SM * sms, dtype=torch.float64, device=device))
    return _ENERGY_SCRATCH[key]


def energy_work(ni: int, nj: int, masked: bool):
    """(FP32 operations, bytes) of B2: ~13 operations a pair (the upper
    triangle masked), positions and masses read once, one float written."""
    pairs = ni * (ni - 1) / 2 if masked else ni * nj
    return 13.0 * pairs, (16.0 * ni + (0 if masked else 16.0 * nj)) + 4.0


def pair_potential(pos_i, mass_i, pos_j, mass_j, g_const, softening,
                   masked: bool):
    """Pairwise potential (a 0-d float32 tensor on the inputs' device; no
    host sync). ``masked``: ``pos_i`` and ``pos_j`` are the same set and each
    unordered pair counts once. Otherwise the two sets must be disjoint.
    One kernel launch (:func:`energy_tiles`), which writes the float32
    result itself. A group of S scenes (``(S, N, 3)`` positions, ``(S, N)``
    masses) gives ``(S,)`` in the same one launch (one a
    :func:`scene_chunks` chunk), each scene the bits of a call on that scene
    alone."""
    if build.on_cpu(pos_i, mass_i, pos_j, mass_j):
        return pair_potential_torch(pos_i, mass_i, pos_j, mass_j, g_const,
                                    softening, masked)
    lead = _scenes(pos_i)
    ni, nj = pos_i.shape[-2], pos_j.shape[-2]
    build.check("pos_i", pos_i, lead + (ni, 3))
    build.check("mass_i", mass_i, lead + (ni,))
    build.check("pos_j", pos_j, lead + (nj, 3))
    build.check("mass_j", mass_j, lead + (nj,))
    if masked and ni != nj:
        raise ValueError("the masked potential takes one set (ni == nj)")
    out = torch.empty(lead, dtype=torch.float32, device=pos_i.device)
    scenes = lead[0] if lead else 1
    if ni == 0 or nj == 0 or scenes == 0:
        return out.zero_()
    sms = _sm_count(pos_i.device.index)
    pi, mi, pj, mj, res = _with_scene_axis(lead, pos_i, mass_i, pos_j, mass_j, out)
    with torch.cuda.device(pos_i.device):
        stream = torch.cuda.current_stream().cuda_stream
        for s0, s1 in scene_chunks(scenes):
            tickets, partials = _energy_scratch(pos_i.device, stream, sms, s1 - s0)
            rc = _lib().nbody_energy(
                pi[s0].data_ptr(), mi[s0].data_ptr(), ni, pj[s0].data_ptr(),
                mj[s0].data_ptr(), nj, float(g_const), float(softening), int(masked),
                s1 - s0, energy_tiles(ni, nj, masked, sms)["blocks"], tickets.data_ptr(),
                partials.data_ptr(), res[s0].data_ptr(), stream)
            build.raise_on(rc, "nbody_energy launch")
            pair_potential.launches += 1
    return out


pair_potential.launches = 0


def potential_energy(pos, mass, g_const, softening, mask=None):
    """Total pairwise PE of one set through B2; the port of
    ``pallas_potential_energy``. A group of scenes gives ``(S,)``; the mask
    (N,) is shared."""
    pos, mass = _f32(pos), _f32(mass)
    if mask is not None:
        mass = mass * mask.to(pos.device, torch.float32)
    return pair_potential(pos, mass, pos, mass, g_const, softening, masked=True)


def cross_potential(pos_i, mass_i, pos_j, mass_j, g_const, softening):
    """PE of every pair between two DISJOINT sets through B2; the port of
    ``pallas_cross_potential``. A particle in both sets would pair with
    itself at distance 0 and add -G m^2 / eps."""
    return pair_potential(_f32(pos_i), _f32(mass_i), _f32(pos_j), _f32(mass_j),
                          g_const, softening, masked=False)


def chunked_potential_energy(pos, mass, g_const, softening, chunk: int) -> float:
    """Exact total PE as a float from C diagonal and C(C-1)/2 cross launches
    of ~``chunk`` rows each (block-triangle decomposition), summed on the host
    in float64. Bounds the length of any single launch at very large N."""
    n = pos.shape[0]
    bounds = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
    total = 0.0
    for a, (lo, hi) in enumerate(bounds):
        total += float(potential_energy(pos[lo:hi], mass[lo:hi], g_const, softening))
        for lo2, hi2 in bounds[a + 1:]:
            total += float(cross_potential(
                pos[lo:hi], mass[lo:hi], pos[lo2:hi2], mass[lo2:hi2],
                g_const, softening))
    return total
