from nbody_tpu_torch.ops.pairwise import (
    accelerations,
    chunked_potential_energy,
    cross_potential,
    near_accelerations,
    pair_potential,
    partial_accelerations,
    potential_energy,
)
from nbody_tpu_torch.ops.treeforce import (
    BHPartition,
    BH2Partition,
    BH3Partition,
    bh_accelerations,
    bh2_accelerations,
    bh3_accelerations,
    build_bh_partition,
    build_bh2_partition,
    build_bh3_partition,
)
from nbody_tpu_torch.ops.knn import knn_neighbors, knn_query, batched_knn_neighbors
from nbody_tpu_torch.ops.segment import masked_aggregate, masked_mean, masked_sum
from nbody_tpu_torch.ops.spatial import batched_knn_morton, knn_morton, morton_keys
from nbody_tpu_torch.ops.radius import batched_radius_neighbors, radius_neighbors
from nbody_tpu_torch.ops.interpolate import trilinear_corners, trilinear_interpolate
from nbody_tpu_torch.ops.contconv_kernel import contconv_collect

__all__ = [
    "accelerations",
    "chunked_potential_energy",
    "cross_potential",
    "near_accelerations",
    "pair_potential",
    "partial_accelerations",
    "potential_energy",
    "BHPartition",
    "BH2Partition",
    "BH3Partition",
    "bh_accelerations",
    "bh2_accelerations",
    "bh3_accelerations",
    "build_bh_partition",
    "build_bh2_partition",
    "build_bh3_partition",
    "knn_neighbors",
    "knn_query",
    "batched_knn_neighbors",
    "masked_aggregate",
    "masked_mean",
    "masked_sum",
    "batched_knn_morton",
    "knn_morton",
    "morton_keys",
    "batched_radius_neighbors",
    "radius_neighbors",
    "trilinear_corners",
    "trilinear_interpolate",
    "contconv_collect",
]
