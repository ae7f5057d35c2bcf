"""Multi-rank paths over ``torch.distributed`` — the port of
``nbody_tpu/parallel``: the ring all-pairs force, the particle-sharded
treecodes and surrogate, the mesh and its collectives, and the launcher
that starts one process a rank (``launch.run_ranks``)."""

from nbody_tpu_torch.parallel.bh import (bh2_simulate, bh3_simulate, bh_simulate,
                                         sharded_bh2_accelerations,
                                         sharded_bh3_accelerations,
                                         sharded_bh_accelerations)
from nbody_tpu_torch.parallel.launch import run_ranks
from nbody_tpu_torch.parallel.mesh import (DATA_AXIS, PARTICLE_AXIS, Mesh, all_gather,
                                           make_mesh, particle_sharding, ppermute, psum)
from nbody_tpu_torch.parallel.ring import ring_accelerations, ring_energies, ring_simulate
from nbody_tpu_torch.parallel.surrogate import (sharded_contconv_loss_and_grad,
                                                sharded_contconv_predict,
                                                sharded_contconv_rollout,
                                                sharded_loss_and_grad, sharded_predict,
                                                sharded_rollout)

__all__ = [
    "DATA_AXIS",
    "PARTICLE_AXIS",
    "Mesh",
    "all_gather",
    "bh2_simulate",
    "bh3_simulate",
    "bh_simulate",
    "make_mesh",
    "particle_sharding",
    "ppermute",
    "psum",
    "ring_accelerations",
    "ring_energies",
    "ring_simulate",
    "run_ranks",
    "sharded_bh_accelerations",
    "sharded_bh2_accelerations",
    "sharded_bh3_accelerations",
    "sharded_contconv_loss_and_grad",
    "sharded_contconv_predict",
    "sharded_contconv_rollout",
    "sharded_loss_and_grad",
    "sharded_predict",
    "sharded_rollout",
]
