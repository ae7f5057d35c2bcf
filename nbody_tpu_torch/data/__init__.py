from nbody_tpu_torch.data.schema import CSV_FIELDS
from nbody_tpu_torch.data.generate import ScenarioConfig, run_scenario, generate_dataset
from nbody_tpu_torch.data.dataset import SnapshotDataset, BatchIterator

__all__ = [
    "CSV_FIELDS",
    "ScenarioConfig",
    "run_scenario",
    "generate_dataset",
    "SnapshotDataset",
    "BatchIterator",
]
