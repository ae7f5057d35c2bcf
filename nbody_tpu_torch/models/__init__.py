from nbody_tpu_torch.models.gnn import EdgeConv, GraphModel
from nbody_tpu_torch.models.contconv import ContinuousConv, ContinuousConvModel
from nbody_tpu_torch.models.mlp import MLP, Dense, MaskedBatchNorm, OutputHead
from nbody_tpu_torch.models.convert import contconv_model_state_dict, graph_model_state_dict

__all__ = ["EdgeConv", "GraphModel", "ContinuousConv", "ContinuousConvModel",
           "MLP", "Dense", "MaskedBatchNorm", "OutputHead",
           "contconv_model_state_dict", "graph_model_state_dict"]
