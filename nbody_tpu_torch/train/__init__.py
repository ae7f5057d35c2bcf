from nbody_tpu_torch.train.checkpoint import CheckpointManager
from nbody_tpu_torch.train.elastic import (ElasticResult, TrainingFault, all_finite,
                                           elastic_train)
from nbody_tpu_torch.train.graphs import build_graph
from nbody_tpu_torch.train.optim import PlateauScheduler, make_optimizer
from nbody_tpu_torch.train.rollout import autoregressive_rollout, predict_accelerations
from nbody_tpu_torch.train.trainer import Trainer

__all__ = ["build_graph", "autoregressive_rollout", "predict_accelerations",
           "Trainer", "ElasticResult", "TrainingFault", "all_finite", "elastic_train",
           "PlateauScheduler", "make_optimizer", "CheckpointManager"]
