"""Flax's keyed streams in the port (``utils/prng.py``, ``models/init.py``,
the trainer's key chain) against JAX 0.9 / Flax on the CPU: ``fold_in``,
``bernoulli`` and the keys Flax derives for module paths; each reference
configuration's initial model and its variants from ``build_model(key=)``
against ``jax.jit(model.init)(key, ...)`` through the converters; the
trainer's key after its init and after an epoch; dropout masks; and the
recipe cut trained from the seed alone, with no converted weights, against
the JAX ``Trainer``.

Bars: keys, masks and every initial parameter bit for bit (the uniform
draws are JAX's bits, the normal filters too since ``prng.log`` is XLA's on
every float in [0.25, 1)); per-epoch losses rtol 2e-4, the bar of
``tests/test_torch_train.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.core.scope import LazyRng

from chip_smoke import INIT_KNOWN_ANSWERS, init_known_answers
from nbody_tpu.config import ExperimentConfig as JConfig
from nbody_tpu.data.dataset import BatchIterator as JBatchIterator
from nbody_tpu.data.dataset import SnapshotDataset as JSnapshotDataset
from nbody_tpu.data.generate import ScenarioConfig as JScenario
from nbody_tpu.data.generate import generate_dataset as jgenerate_dataset
from nbody_tpu.models import ContinuousConvModel as JContConv
from nbody_tpu.models import GraphModel as JGraphModel
from nbody_tpu.models.mlp import Dense as JDense
from nbody_tpu.train import PlateauScheduler as JPlateau
from nbody_tpu.train import Trainer as JTrainer
from nbody_tpu.train.graphs import build_graph as jbuild_graph
from nbody_tpu_torch.config import ExperimentConfig
from nbody_tpu_torch.models import (ContinuousConvModel, GraphModel,
                                    contconv_model_state_dict, graph_model_state_dict)
from nbody_tpu_torch.models.init import dense_params, flax_key
from nbody_tpu_torch.models.mlp import Dropout, set_dropout_key
from nbody_tpu_torch.train import CheckpointManager, PlateauScheduler, Trainer
from nbody_tpu_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GNN_CFG = os.path.join(REPO, "configs", "gnn_reference.json")
CC_CFG = os.path.join(REPO, "configs", "contconv_adopted.json")
DT = 1e-4


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


# ------------------------------------------------------------------- keys

@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1, -5])
def test_fold_in_matches_jax(seed):
    for data in [0, 1, 7, 123_456_789, 2 ** 31, 2 ** 32 - 1]:
        want = _words(jax.random.fold_in(_jkey(seed), np.uint32(data)))
        assert prng.fold_in(prng.PRNGKey(seed), data).tolist() == want.tolist(), data
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(seed), 2 ** 32)


@pytest.mark.parametrize("p", [0.9, 0.5, 0.3, 0.999])
def test_bernoulli_matches_jax_and_its_rows(p):
    """Whole draws, and a rank's rows of a draw (``offset``)."""
    for seed in (0, 42, 1042):
        want = np.asarray(jax.random.bernoulli(_jkey(seed), p, (6, 11, 5)))
        got = prng.bernoulli(prng.PRNGKey(seed), p, (6, 11, 5)).numpy()
        assert np.array_equal(got, want)
        rows = prng.bernoulli(prng.PRNGKey(seed), p, (2, 11, 5), offset=3 * 55).numpy()
        assert np.array_equal(rows, want[3:5])


@pytest.mark.parametrize("suffix", [("EdgeConv_0", "Dense_0", 1), ("EdgeConv_0", "Dense_0", 2),
                                    ("MLP_0", "Dropout_1", 1), ("ContinuousConv_1", 1),
                                    ("OutputHead_0", "Dense_2", 300), ()])
def test_flax_key_matches_flax(suffix):
    for seed in (0, 3):
        want = _words(LazyRng.create(_jkey(seed), *suffix).as_jax_rng())
        assert flax_key(prng.PRNGKey(seed), *suffix).tolist() == want.tolist()


def test_dense_draws_match_flax():
    """The JAX package's ``Dense`` at several fans: the kernel constant
    ``sqrt(3 * variance)`` and the bias range rounded as JAX rounds them."""
    key = _jkey(11)
    for fan_in in (1, 3, 33, 68, 128, 300):
        want = jax.jit(JDense(3).init)(key, jnp.zeros((1, fan_in)))["params"]
        got = dense_params(prng.PRNGKey(11), (), fan_in, 3)
        for name in ("kernel", "bias"):
            assert np.array_equal(got[name].numpy(), np.asarray(want[name])), (fan_in, name)


# ------------------------------------------------------- initial parameters

def _inputs():
    x = np.random.default_rng(0).normal(size=(2, 12, 7)).astype(np.float32)
    return jnp.asarray(x), jnp.ones((2, 12), bool)


def _jax_variables(jmodel, key):
    x, mask = _inputs()
    idx, valid = jbuild_graph(jmodel.graph_spec, x[..., :3], mask)
    return jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(key, x, idx, valid))


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for name, t in want.items():
        assert np.array_equal(got[name].numpy(), t.numpy()), name


def _reference_kwargs(path, **extra):
    cfg = ExperimentConfig.load(path)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.model.kwargs.items()}
    return {**kw, **extra}


GNN_VARIANTS = {
    "reference": {},
    "fused": dict(fused_edgeconv=True),
    "remat": dict(remat=True),
    "fused_remat": dict(fused_edgeconv=True, remat=True),
    "encoder_head_sum": dict(node_encoder_dims=(32, 16), output_hiddens=(24, 8), aggr="sum",
                             input_dim=7, encoder_dropout=0.1),
    "zero_init": dict(zero_init_output=True, output_hiddens=(16,)),
}


@pytest.mark.parametrize("variant", sorted(GNN_VARIANTS))
def test_graph_model_init_matches_flax(variant):
    kw = _reference_kwargs(GNN_CFG, **GNN_VARIANTS[variant])
    for seed in ((0, 5) if variant == "reference" else (3,)):
        want = graph_model_state_dict(_jax_variables(JGraphModel(**kw), _jkey(seed))["params"])
        model = GraphModel(**kw, key=prng.PRNGKey(seed))
        assert not model.draw_pending
        _assert_same(model.state_dict(), want)


CC_VARIANTS = {
    "node_chunks_sum": dict(conv_node_chunks=3, agg="sum", continuous_conv_dim=16),
    "one_resolution": dict(filter_resolution=3, continuous_conv_layers=3,
                           continuous_conv_dim=16, encoder_hiddens=(8,), decoder_hiddens=None,
                           zero_init_output=False),
    "no_encoder": dict(encoder_hiddens=None, continuous_conv_dim=16, filter_resolution=(2, 4),
                       in_channels=7),
}


INIT_KEY = jax.random.split(_jkey(0))[1]  # a trainer's of seed 0


@pytest.fixture(scope="module")
def reference_inits():
    """``jax.jit(model.init)(split(PRNGKey(0))[1], ...)`` of both reference
    configurations' models, as numpy trees."""
    return {name: _jax_variables(JConfig.load(path).build_model(), INIT_KEY)
            for name, path in (("gnn", GNN_CFG), ("contconv", CC_CFG))}


def test_reference_contconv_init_matches_flax(reference_inits):
    """The reference at its full width: 4,617,635 values, the
    (6,6,6,128,128) and (4,4,4,128,128) filters normal draws."""
    want = contconv_model_state_dict(reference_inits["contconv"])
    key = prng.split(prng.PRNGKey(0))[1]
    got = ExperimentConfig.load(CC_CFG).build_model(key=key).state_dict()
    assert sum(t.numel() for t in got.values()) == 4_617_635
    _assert_same(got, want)


@pytest.mark.parametrize("variant", sorted(CC_VARIANTS))
def test_contconv_model_init_matches_flax(variant):
    kw = _reference_kwargs(CC_CFG, **CC_VARIANTS[variant])
    want = contconv_model_state_dict(_jax_variables(JContConv(**kw), _jkey(3)))
    _assert_same(ContinuousConvModel(**kw, key=prng.PRNGKey(3)).state_dict(), want)


def test_build_model_takes_a_key_and_waits_without_one():
    cfg = ExperimentConfig.load(GNN_CFG)
    jcfg = JConfig.load(GNN_CFG)
    want = graph_model_state_dict(_jax_variables(jcfg.build_model(), _jkey(9))["params"])
    _assert_same(cfg.build_model(key=prng.PRNGKey(9)).state_dict(), want)
    model = cfg.build_model()
    assert model.draw_pending
    model.load_state_dict(want)
    assert not model.draw_pending


def test_init_known_answers_of_the_chip_smoke_are_jax_s(reference_inits):
    """``chip_smoke.INIT_KNOWN_ANSWERS`` (leaves of both reference models
    from ``PRNGKey(0)``'s init key, ``split(PRNGKey(0))[1]``) are JAX's
    values and the port's CPU draws."""
    trees = {name: v["params"] for name, v in reference_inits.items()}
    got = init_known_answers()
    assert set(got) == set(INIT_KNOWN_ANSWERS)
    for name, want in INIT_KNOWN_ANSWERS.items():
        model, *path = name.split("/")
        leaf = trees[model]
        for p in path:
            leaf = leaf[p]
        jax_vals = np.asarray(leaf).reshape(-1)[:len(want)]
        assert np.array_equal(np.asarray(want, np.float32), jax_vals), name
        assert np.array_equal(np.asarray(got[name], np.float32), jax_vals), name


# ---------------------------------------------------------------- dropout

@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_flax_dropout(rate):
    """The port's ``Dropout`` on a key against flax's own module: the mask
    and the kept values ``x / keep_prob`` bit for bit; eval mode and a
    missing key."""
    x = np.random.default_rng(1).normal(size=(4, 9, 6)).astype(np.float32)
    for seed in (0, 8):
        want = np.asarray(fnn.Dropout(rate).apply({}, jnp.asarray(x), deterministic=False,
                                                  rngs={"dropout": _jkey(seed)}))
        layer = Dropout(rate, ()).train()
        set_dropout_key(layer, prng.PRNGKey(seed))
        got = layer(torch.from_numpy(x)).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        # rows 1-2 of the same draw, as a rank of a data-parallel step draws them
        set_dropout_key(layer, prng.PRNGKey(seed), rows=(1, 4))
        assert np.array_equal(layer(torch.from_numpy(x[1:3])).numpy(), want[1:3])
    assert torch.equal(layer.eval()(torch.from_numpy(x)), torch.from_numpy(x))
    set_dropout_key(layer.train(), None)
    with pytest.raises(RuntimeError, match="without a key"):
        layer(torch.from_numpy(x))


DROPOUT_GNN = dict(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
                   neighbors=4, scale_factor=1e6, node_encoder_dims=(16, 16),
                   encoder_dropout=0.1)


def test_gnn_dropout_forward_matches_flax():
    """A GNN with ``encoder_dropout=0.1`` applied in training mode with one
    step's ``dropout`` key gives flax's output (its masks: a wrong mask
    moves the output by O(1))."""
    x, mask = _inputs()
    jmodel = JGraphModel(**DROPOUT_GNN)
    idx, valid = jbuild_graph(jmodel.graph_spec, x[..., :3], mask)
    variables = jax.jit(jmodel.init)(_jkey(2), x, idx, valid)
    step_key = jax.random.split(_jkey(4), 3)[1]
    want = np.asarray(jmodel.apply(variables, x, idx, valid, train=True,
                                   rngs={"dropout": step_key}))
    model = GraphModel(**DROPOUT_GNN, key=prng.PRNGKey(2)).train()
    set_dropout_key(model, prng.split(prng.PRNGKey(4), 3)[1])
    got = model(torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(idx)).long(),
                torch.from_numpy(np.asarray(valid))).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    model.eval()
    plain = model(torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(idx)).long(),
                  torch.from_numpy(np.asarray(valid))).detach().numpy()
    assert np.abs(plain - want).max() > 1e-3 * np.abs(want).max()


# ------------------------------------------------------------- the trainer

@pytest.fixture(scope="module")
def recipe_cut(tmp_path_factory):
    """Two files of the recipe's spiral scenes, cut to 8 and 25 bodies and 12
    steps, written by the JAX package."""
    train_dir = tmp_path_factory.mktemp("recipe") / "train"
    train_dir.mkdir()
    for i, seed in enumerate((1, 2)):
        jgenerate_dataset([JScenario(n_bodies=n, sim_type="spiral", steps=12, seed=seed,
                                     force_backend="dense") for n in (8, 25)],
                          str(train_dir / f"f{i}.csv"), verbose=False)
    return str(train_dir)


def _trainers(path, **model_extra):
    """JAX's ``Trainer`` and the port's from the config alone, as the
    drivers build them: the model from ``model.kwargs``, no weights handed
    over, the trainer seeded with ``train.seed``."""
    jcfg, cfg = JConfig.load(path), ExperimentConfig.load(path)
    jcfg.model.kwargs.update(model_extra)
    cfg.model.kwargs.update(model_extra)
    t = cfg.train
    jt = JTrainer(jcfg.build_model(), learning_rate=t.learning_rate, dt=t.dt, seed=t.seed,
                  scheduler=JPlateau(lr=t.learning_rate, factor=t.scheduler_factor,
                                     patience=t.scheduler_patience))
    tt = Trainer(cfg.build_model(), learning_rate=t.learning_rate, dt=t.dt, seed=t.seed,
                 scheduler=PlateauScheduler(lr=t.learning_rate, factor=t.scheduler_factor,
                                            patience=t.scheduler_patience))
    call = dict(batch_size=t.batch_size, batch_mode=t.batch_mode,
                merge_files=t.merge_files, verbose=False)
    return jt, tt, call


def test_trainer_keys_and_initial_model_match_jax(recipe_cut):
    """After the init the trainer's key and the model are JAX's; after an
    epoch (its buckets' splits, with no dropout in the model) the key is
    JAX's again."""
    jt, tt, call = _trainers(GNN_CFG)
    ds = JSnapshotDataset.from_file(os.path.join(recipe_cut, "f0.csv"))
    jt._ensure_state(next(iter(JBatchIterator(ds, 64, shuffle=False))))
    assert tt.model.draw_pending
    tt._ensure_state()
    assert not tt.model.draw_pending
    assert tt.rng.tolist() == np.asarray(jt.rng).astype(np.int64).tolist()
    _assert_same(tt.model.state_dict(), graph_model_state_dict(
        jax.tree_util.tree_map(np.asarray, jt.state.params)))
    for mode in ("reference", "bucketed"):
        jt.train_from_dir(recipe_cut, epochs=1, **{**call, "batch_mode": mode})
        tt.train_from_dir(recipe_cut, epochs=1, **{**call, "batch_mode": mode})
        assert tt.rng.tolist() == np.asarray(jt.rng).astype(np.int64).tolist(), mode


@pytest.mark.parametrize("case", ["gnn", "gnn_dropout", "contconv"])
def test_recipe_cut_trained_from_the_seed_alone_matches_jax(recipe_cut, case):
    """Two epochs of each reference recipe (its model, batch mode, batch,
    LR and seed) on the cut, both packages from the config alone, and a GNN
    with encoder dropout: the per-epoch losses and the final key."""
    if case == "contconv":
        jt, tt, call = _trainers(CC_CFG)
    else:
        extra = (dict(node_encoder_dims=[32], encoder_dropout=0.1)
                 if case == "gnn_dropout" else {})
        jt, tt, call = _trainers(GNN_CFG, **extra)
    want, _ = jt.train_from_dir(recipe_cut, epochs=2, **call)
    got, _ = tt.train_from_dir(recipe_cut, epochs=2, **call)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert tt.rng.tolist() == np.asarray(jt.rng).astype(np.int64).tolist()


@pytest.fixture
def one_thread():
    """One torch thread for the test: torch's CPU ``tanh`` can round one
    thread's chunk of a multi-threaded call otherwise (``PERF.md``), which
    would move the two runs of a bit-for-bit comparison apart."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_keeps_the_key_and_refuses_a_generator_checkpoint(recipe_cut, tmp_path,
                                                                  one_thread):
    """A checkpoint holds the trainer's key, and a resumed run continues
    JAX's chain (the same weights bit for bit); a checkpoint holding a torch
    generator state (written before the key chain) is refused."""
    save = str(tmp_path / "ckpt")
    _, first, call = _trainers(GNN_CFG, node_encoder_dims=[16], encoder_dropout=0.1)
    first.train_from_dir(recipe_cut, epochs=1, save_every=1, save_path=save, **call)
    tree = CheckpointManager(save).restore_latest()[1]
    assert tree["rng"].tolist() == first.rng.tolist() and "rng_device" not in tree
    _, again, _ = _trainers(GNN_CFG, node_encoder_dims=[16], encoder_dropout=0.1)
    again.train_from_dir(recipe_cut, epochs=1, save_path=save, **call)
    first.train_from_dir(recipe_cut, epochs=1, **call)
    assert again.epoch == 2 and again.rng.tolist() == first.rng.tolist()
    for (n, a), b in zip(first.model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(a, b), n
    tree["rng"] = torch.Generator().manual_seed(0).get_state()
    tree["rng_device"] = "cpu"
    old = str(tmp_path / "old")
    CheckpointManager(old).save(1, tree)
    _, fresh, _ = _trainers(GNN_CFG)
    with pytest.raises(ValueError, match="torch generator state"):
        fresh.train_from_dir(recipe_cut, epochs=1, save_path=old, **call)
