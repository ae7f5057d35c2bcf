"""Data-parallel training, ``Trainer(mesh=)`` of ``nbody_tpu_torch/train/
trainer.py``, against the port's one-process ``Trainer`` and the JAX
package's ``Trainer(mesh=make_mesh(2, ("data",)))``, on the CPU; then the
launcher's failure path and the dryrun (``parallel/dryrun.py``). The
port's 2 gloo ranks start once for the module
(``tests/_parallel_ranks.train``), from flax initial weights converted with
``graph_model_state_dict`` / ``contconv_model_state_dict``, on one
JAX-written dataset.

Bars: per-epoch losses rtol 2e-4, the JAX package's own bar for a
data-parallel run against a one-device one (``tests/test_trainer.py``,
``test_data_parallel_reference_batch_mode``), in the bucketed, reference
batch modes (the dryrun's check adds the mixed one), for the GNN and for a
ContConv model whose encoder batch norm must see the statistics of the
whole batch, and for a GNN with encoder dropout, whose ranks draw their
rows of each step's mask; the trained weights
and running statistics rtol 2e-4, atol 1e-6, leaving out the biases that
feed a batch norm and the running means after them (their gradient is
rounding noise, ``tests/test_torch_train.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parallel_ranks import fail_on_rank_1, train
from nbody_tpu.data.dataset import BatchIterator as JBatchIterator
from nbody_tpu.data.dataset import SnapshotDataset as JSnapshotDataset
from nbody_tpu.data.generate import ScenarioConfig as JScenario
from nbody_tpu.data.generate import generate_dataset as jgenerate_dataset
from nbody_tpu.models import ContinuousConvModel as JContConv
from nbody_tpu.models import GraphModel as JGraphModel
from nbody_tpu.parallel.mesh import make_mesh
from nbody_tpu.train import Trainer as JTrainer
from nbody_tpu_torch.models import (ContinuousConvModel, GraphModel,
                                    contconv_model_state_dict, graph_model_state_dict)
from nbody_tpu_torch.parallel import dryrun
from nbody_tpu_torch.parallel.launch import run_ranks
from nbody_tpu_torch.parallel.mesh import Mesh
from nbody_tpu_torch.train import Trainer

GNN = dict(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean", neighbors=4,
           scale_factor=1e6)
CONTCONV = dict(in_channels=4, out_channels=3, filter_resolution=(3, 2), radius=1.0,
                agg="mean", self_loops=True, continuous_conv_layers=2,
                continuous_conv_dim=8, encoder_hiddens=(8, 12), decoder_hiddens=(8,),
                scale_factor=1e6)
GNN_DROPOUT = dict(GNN, node_encoder_dims=(16,), encoder_dropout=0.1)
KINDS = {"gnn": (JGraphModel, GNN), "contconv": (JContConv, CONTCONV),
         "gnn_dropout": (JGraphModel, GNN_DROPOUT)}
# "mixed": the dryrun's training check; dropout in bucketed mode, whose
# batches the data axis divides (a reference quota padded to the axis
# draws a mask of another shape than one process's)
CASES = [("gnn", "bucketed"), ("gnn", "reference"), ("contconv", "bucketed"),
         ("contconv", "reference"), ("gnn_dropout", "bucketed")]
EPOCHS, BATCH = 2, 8


def _name(kind, mode):
    return f"{kind}_{mode}"


def _jax_trainer(kind, mesh=None):
    cls, kw = KINDS[kind]
    return JTrainer(cls(**kw), learning_rate=0.01, dt=1e-4, seed=0, mesh=mesh)


def _flax(kind, train_dir):
    """A JAX trainer's initial state, and the port's state dict of it."""
    jt = _jax_trainer(kind)
    ds = JSnapshotDataset.from_file(os.path.join(train_dir, "f1.csv"))
    jt._ensure_state(next(iter(JBatchIterator(ds, BATCH, shuffle=False))))
    tree = jax.tree_util.tree_map(np.asarray, {"params": jt.state.params,
                                               "batch_stats": jt.state.batch_stats})
    sd = (contconv_model_state_dict(tree) if kind == "contconv"
          else graph_model_state_dict(tree["params"]))
    return (jt.state, jt._has_bn), {k: v.numpy() for k, v in sd.items()}


def _port_model(kind, state):
    model = (ContinuousConvModel(**CONTCONV) if kind == "contconv"
             else GraphModel(**KINDS[kind][1]))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    train_dir = root / "train"
    train_dir.mkdir()
    jgenerate_dataset([
        JScenario(n_bodies=8, sim_type="spiral", steps=20, seed=1, force_backend="dense"),
        JScenario(n_bodies=12, sim_type="disk", steps=20, seed=2, force_backend="dense"),
    ], str(train_dir / "f1.csv"), verbose=False)
    dry_dir = root / "dryrun"
    dry_dir.mkdir()
    dryrun.write_train_data(str(dry_dir), torch.device("cpu"))
    states, jax_states, cases = {}, {}, {}
    for kind, mode in CASES:
        if kind not in states:
            jax_states[kind], states[kind] = _flax(kind, str(train_dir))
        cases[_name(kind, mode)] = {"model": {"family": "cc" if kind == "contconv" else "gnn",
                                              "kwargs": KINDS[kind][1],
                                              "state": states[kind]},
                                    "mode": mode, "epochs": EPOCHS, "batch_size": BATCH}
    inp = {"dir": str(train_dir), "cases": cases, "dryrun_dir": str(dry_dir),
           "resume": {"model": cases["gnn_bucketed"]["model"], "dir": str(root / "ckpt")}}
    out = run_ranks(train, 2, "gloo", inp, device="cpu", timeout=300)
    return {"out": out, "dir": str(train_dir), "states": states, "jax_states": jax_states,
            "ckpt": root / "ckpt"}


def _pre_norm(model) -> set:
    """Biases that feed a batch norm and the running means after them: their
    gradient is rounding noise (``tests/test_torch_train.py``)."""
    if not getattr(model, "encoder", None) or model.encoder.norms is None:
        return set()
    n = len(model.encoder.norms)
    return ({f"encoder.layers.{i}.bias" for i in range(n)}
            | {f"encoder.norms.{i}.running_mean" for i in range(n)})


@pytest.mark.parametrize("kind,mode", CASES)
def test_data_parallel_epochs_match_one_process_and_jax(run, kind, mode):
    got = run["out"][_name(kind, mode)]
    single = Trainer(_port_model(kind, run["states"][kind]), learning_rate=0.01, dt=1e-4,
                     seed=0)
    want, _ = single.train_from_dir(run["dir"], epochs=EPOCHS, batch_size=BATCH,
                                    batch_mode=mode, verbose=False)
    np.testing.assert_allclose(got["losses"], want, rtol=2e-4)
    jt = _jax_trainer(kind, mesh=make_mesh(2, axis_names=("data",)))
    state, jt._has_bn = run["jax_states"][kind]  # the initial state, drawn once
    jt.state = jax.tree_util.tree_map(jnp.array, state)  # a copy: training donates buffers
    jt.rng = jax.random.split(jt.rng)[0]  # the key after _ensure_state's init split
    jax_losses, _ = jt.train_from_dir(run["dir"], epochs=EPOCHS, batch_size=BATCH,
                                      batch_mode=mode, verbose=False)
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=2e-4)
    noisy = _pre_norm(single.model)
    for k, t in single.model.state_dict().items():
        if k not in noisy:
            np.testing.assert_allclose(got["state"][k], t.numpy(), rtol=2e-4, atol=1e-6,
                                       err_msg=k)


def test_only_rank_0_writes_checkpoints_and_every_rank_resumes(run):
    res = run["out"]["resume"]
    assert res["writers"] == 1.0 and res["writes"] == [True]
    assert sorted(os.listdir(run["ckpt"])) == ["ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt"]
    assert res["epoch"] == 3 and res["epoch_sum"] == 6.0  # both ranks at epoch 3
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 3


def test_dryrun_paths_match_the_single_rank_results(run):
    out = run["out"]["dryrun"]
    assert out["world"] == 2 and out["backend"] == "gloo"
    assert {"ring", "bh", "gnn", "contconv", "train"} <= set(out)
    for engine in ("bh", "bh2", "bh3", "bh_uneven"):
        assert out["bh"][engine]["bits_equal"], engine
    assert out["train"]["max_abs_err"] <= 2e-4 * max(out["train"]["single_losses"])
    assert out["train"]["grads_max_abs_err"] <= 2e-4 + 1e-5


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="--- rank 1") as err:
        run_ranks(fail_on_rank_1, 2, "gloo", "the body's own error", device="cpu",
                  timeout=120)
    assert "ValueError: the body's own error" in str(err.value)


def test_trainer_mesh_needs_a_data_axis():
    mesh = Mesh(("particles",), {"particles": 2}, {"particles": 0}, {}, {}, "gloo")
    with pytest.raises(ValueError, match="'data' axis"):
        Trainer(GraphModel(**GNN), mesh=mesh)


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--ranks", "2"])
