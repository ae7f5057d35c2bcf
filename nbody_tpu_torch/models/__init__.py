from nbody_tpu_torch.models.gnn import EdgeConv, GraphModel
from nbody_tpu_torch.models.mlp import MLP, Dense, OutputHead
from nbody_tpu_torch.models.convert import graph_model_state_dict

__all__ = ["EdgeConv", "GraphModel", "MLP", "Dense", "OutputHead",
           "graph_model_state_dict"]
