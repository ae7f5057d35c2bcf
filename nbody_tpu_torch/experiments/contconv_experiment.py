"""ContConv experiment — the port of
``nbody_tpu/experiments/contconv_experiment.py`` (reference
``contconv_experiment.py``): the GNN experiment's datagen, then
ContinuousConvModel (filter resolutions (6, 4), radius 1.0, 2 layers of
width 128, encoder (32, 64), decoder (64, 32), scale 1e6) -> Adam(0.01) with
the default plateau -> 100 epochs, batch 16 -> ``results/contconv/*.csv``.

    python -m nbody_tpu_torch.experiments.contconv_experiment [--quick]

The JAX script's flags, plus ``--device``. On a CUDA device the layers
train through the B3 collect kernel and its B4/B5 backward, as
``ContinuousConv`` chooses for card tensors.
"""

from __future__ import annotations

from nbody_tpu_torch.experiments.gnn_experiment import parser, run_experiment
from nbody_tpu_torch.models import ContinuousConvModel


def build_parser():
    p = parser("contconv_experiment", batch_size=16)
    p.add_argument("--reference-init", action="store_true",
                   help="torch-style init for the decoder head (the default "
                        "zero-init avoids the saturation collapse)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    model = ContinuousConvModel(
        in_channels=4,
        out_channels=3,
        filter_resolution=(6, 4),
        radius=1.0,
        agg="mean",
        self_loops=True,
        continuous_conv_layers=2,
        continuous_conv_dim=128,
        encoder_hiddens=(32, 64),
        encoder_dropout=0.0,
        decoder_hiddens=(64, 32),
        scale_factor=1e6,
        zero_init_output=not args.reference_init,
    )  # the trainer draws its weights from split(PRNGKey(train_seed))[1]
    return run_experiment("contconv", args, model)  # torch's plateau defaults


if __name__ == "__main__":
    main()
