from nbody_tpu_torch.ops.pairwise import (
    accelerations,
    chunked_potential_energy,
    cross_potential,
    pair_potential,
    partial_accelerations,
    potential_energy,
)
from nbody_tpu_torch.ops.knn import knn_neighbors, batched_knn_neighbors
from nbody_tpu_torch.ops.segment import masked_aggregate, masked_mean, masked_sum

__all__ = [
    "accelerations",
    "chunked_potential_energy",
    "cross_potential",
    "pair_potential",
    "partial_accelerations",
    "potential_energy",
    "knn_neighbors",
    "batched_knn_neighbors",
    "masked_aggregate",
    "masked_mean",
    "masked_sum",
]
