"""The device mesh over a ``torch.distributed`` process group, and the three
collectives the sharded bodies use — the port of ``nbody_tpu/parallel/mesh.py``.

The JAX package runs single-controller SPMD: one program, ``shard_map``
bodies, XLA collectives over a ``jax.sharding.Mesh``. Here every device is
one process of a process group (``parallel/launch.py`` starts them), every
rank runs the body on its own shard, and the collectives are
``torch.distributed`` calls on the group of one mesh axis:

- ``all_gather(tiled=True)`` -> :func:`all_gather` (its backward sums the
  ranks' cotangents and keeps this rank's rows, as JAX transposes it);
- ``psum`` -> :func:`psum` (``all_reduce`` SUM; its backward is a psum too);
- ``ppermute`` by ``(d, (d + 1) % n)`` -> :func:`ppermute`.

Two mesh axes are used, as in the JAX package: ``"particles"`` shards the
particle axis (``parallel/ring.py``, ``bh.py``, ``surrogate.py``) and
``"data"`` the training batch (``Trainer(mesh=)``).

The backend is the caller's choice, never a fallback: ``nccl`` for one rank
a card, ``gloo`` for the CPU and for several ranks on one card (NCCL refuses
two ranks on one device). Gloo has no send or receive for CUDA tensors and
copies CUDA tensors through host memory in its collectives anyway, so on
gloo every collective here moves a CUDA tensor through host memory
explicitly (:func:`_staged`) and puts the result back on the tensor's
device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

PARTICLE_AXIS = "particles"
DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a device mesh: per axis its size, this rank's
    index along it, the process group of the ranks that share every other
    coordinate with this one, and their global ranks in index order.

    ``shape`` maps axis names to sizes, as ``jax.sharding.Mesh.shape`` does.
    """

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    ranks: Dict[str, Tuple[int, ...]]
    backend: str

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """``jax.lax.axis_index(axis)`` of this rank."""
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (PARTICLE_AXIS,),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """A mesh over the ranks of the initialised default process group, rank
    r at coordinates ``unravel(r, shape)``. Every rank must call it, in the
    same order as its other group calls (it may create process groups).

    :param n_devices: the mesh size; it must be the world size (the JAX
        package's first-n-devices sub-mesh is a world of n ranks here).
    :param shape: default ``(n_devices, 1, ...)``.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch.run_ranks, or init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} ranks: the "
                         "mesh spans every rank of the process group")
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not fit {n} ranks on axes {axis_names}")
    rank = dist.get_rank()
    coords = _unravel(rank, shape)
    groups, ranks = {}, {}
    for a, name in enumerate(axis_names):
        if shape[a] == world:
            groups[name], ranks[name] = dist.group.WORLD, tuple(range(world))
            continue
        # every line along axis a is a group; all ranks create all of them
        for r in range(world):
            c = _unravel(r, shape)
            if c[a] != 0:
                continue
            line = tuple(_ravel(c[:a] + (i,) + c[a + 1:], shape) for i in range(shape[a]))
            g = dist.new_group(list(line))
            if rank in line:
                groups[name], ranks[name] = g, line
    return Mesh(axis_names, dict(zip(axis_names, shape)),
                dict(zip(axis_names, coords)), groups, ranks, dist.get_backend())


@dataclass(frozen=True)
class ParticleSharding:
    """The leading axis split over one mesh axis in contiguous blocks, rank
    i holding rows ``i * n / size .. (i + 1) * n / size - 1`` (JAX
    ``NamedSharding(mesh, P(axis))``)."""

    mesh: Mesh
    axis: str = PARTICLE_AXIS

    def rows(self, n: int) -> slice:
        size = self.mesh.size(self.axis)
        if n % size:
            raise ValueError(f"N={n} not divisible by mesh axis {self.axis}={size}")
        shard = n // size
        me = self.mesh.index(self.axis)
        return slice(me * shard, (me + 1) * shard)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (every rank's same) array."""
        return x[self.rows(x.shape[0])]


def particle_sharding(mesh: Mesh, axis: str = PARTICLE_AXIS) -> ParticleSharding:
    """Sharding that splits the leading (particle) axis across the mesh."""
    return ParticleSharding(mesh, axis)


# ------------------------------------------------------------ collectives

def _staged(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor a collective of ``mesh``'s backend takes: on gloo a CUDA
    tensor goes through host memory (gloo has no CUDA send/recv, and its
    collectives copy CUDA tensors to the host themselves)."""
    if mesh.backend == "gloo" and x.is_cuda:
        return x.detach().cpu()
    return x.detach().contiguous()


# the gather into one tensor: all_gather_single in newer torch, where the
# older name warns that it is deprecated
_GATHER_INTO = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_gather_raw(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    src = _staged(x, mesh)
    out = src.new_empty((mesh.size(axis) * src.shape[0],) + tuple(src.shape[1:]))
    _GATHER_INTO(out, src, group=mesh.group(axis))
    return out.to(x.device)


def _all_reduce_raw(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    src = _staged(x, mesh).clone()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return src.to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return _all_gather_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # sum every rank's cotangent of the gathered array, keep this rank's
        # rows: JAX's transpose of all_gather (a reduce-scatter; all_reduce
        # and a slice here, which every backend and version takes)
        me = ctx.mesh.index(ctx.axis)
        full = _all_reduce_raw(g.contiguous(), ctx.mesh, ctx.axis)
        return full[me * ctx.rows:(me + 1) * ctx.rows], None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g.contiguous(), ctx.mesh, ctx.axis), None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = PARTICLE_AXIS) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, tiled=True)``: every rank's ``x``
    concatenated along dim 0 in index order. Differentiable."""
    return _AllGather.apply(x, mesh, axis)


def psum(x: torch.Tensor, mesh: Mesh, axis: str = PARTICLE_AXIS) -> torch.Tensor:
    """``jax.lax.psum``: the sum of every rank's ``x``. Differentiable (the
    backward is a psum of the cotangents, as JAX transposes it)."""
    return _Psum.apply(x, mesh, axis)


def psum_all(tensors, mesh: Mesh, axis: str) -> list:
    """:func:`psum` of each tensor in one all-reduce of their concatenation
    (the gradients of a step), as flat views of one buffer; no gradient."""
    flat = _all_reduce_raw(torch.cat([t.reshape(-1) for t in tensors]), mesh, axis)
    return list(torch.split(flat, [t.numel() for t in tensors]))


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str = PARTICLE_AXIS) -> torch.Tensor:
    """``jax.lax.ppermute`` by ``(d, (d + 1) % n)``: this rank's ``x`` goes to
    the next rank along ``axis``, and the previous rank's comes back. No
    gradient."""
    n = mesh.size(axis)
    if n == 1:
        return x
    me, line = mesh.index(axis), mesh.ranks[axis]
    src = _staged(x, mesh)
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, line[(me + 1) % n], group=mesh.group(axis)),
           dist.P2POp(dist.irecv, out, line[(me - 1) % n], group=mesh.group(axis))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


def _unravel(r: int, shape) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r
