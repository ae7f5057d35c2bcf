"""The program under test: a configuration's model built through
``nbody_tpu_torch``'s own classes with the configuration's large-N
switches, loaded with the benchmark's weights."""

from __future__ import annotations

from typing import Dict

import torch


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device, training: bool):
    """The port's model of ``cfg`` on ``device`` holding ``weights`` (copied).
    ``training`` turns on the switches a configuration keeps for its
    training cells (the GNN's remat)."""
    sw = cfg["switches"]
    if cfg["model"] == "gnn":
        from nbody_tpu_torch.models import GraphModel

        model = GraphModel(
            input_dim=cfg["input_dim"], gnn_dim=cfg["gnn_dim"],
            message_passing_steps=cfg["message_passing_steps"], aggr=cfg["aggr"],
            neighbors=cfg["neighbors"], scale_factor=cfg["scale_factor"],
            output_hiddens=cfg.get("output_hiddens"), knn_method=sw["knn_method"],
            knn_window=sw["knn_window"], knn_impl=sw["knn_impl"], knn_block=sw["knn_block"],
            knn_copies=sw["knn_copies"], fused_edgeconv=sw["fused_edgeconv"],
            remat=bool(training and sw["remat_in_training"]))
    else:
        from nbody_tpu_torch.models import ContinuousConvModel

        model = ContinuousConvModel(
            in_channels=cfg["in_channels"], filter_resolution=tuple(cfg["filter_resolution"]),
            radius=cfg["radius"], agg=cfg["agg"], self_loops=cfg["self_loops"],
            continuous_conv_layers=cfg["continuous_conv_layers"],
            continuous_conv_dim=cfg["continuous_conv_dim"],
            encoder_hiddens=tuple(cfg["encoder_hiddens"]),
            decoder_hiddens=tuple(cfg["decoder_hiddens"]), scale_factor=cfg["scale_factor"],
            zero_init_output=cfg["zero_init_output"], radius_method=sw["radius_method"],
            radius_impl=sw["radius_impl"], conv_impl=sw["conv_impl"],
            conv_node_chunks=sw["conv_node_chunks"])
    model.to(device)
    model.load_state_dict(weights, strict=True)
    return model


def conv_layers(model):
    """The model's ContConv layer modules (none for the GNN)."""
    from nbody_tpu_torch.models import ContinuousConv

    return [m for m in model.modules() if isinstance(m, ContinuousConv)]
