"""The plain reference against the port's plain paths at a few hundred to a
few thousand bodies on the CPU: the same graphs, forwards and Adam steps.
The reference imports nothing of the port; the tests import both."""

import ast
import math
import pathlib

import numpy as np
import pytest
import torch

from benchmark.harness import inputs, weights
from benchmark.harness.manifest import BENCH
from benchmark.reference import models as ref_models
from benchmark.reference import morton
from benchmark.reference import train as ref_train

GNN = {"model": "gnn", "input_dim": 4, "gnn_dim": 64, "message_passing_steps": 2, "aggr": "mean",
       "neighbors": 10, "scale_factor": 1e6}
CC = {"model": "contconv", "in_channels": 4, "filter_resolution": [6, 4], "radius": 1.0,
      "agg": "mean", "self_loops": True, "continuous_conv_layers": 2, "continuous_conv_dim": 16,
      "encoder_hiddens": [8, 12], "decoder_hiddens": [12, 8], "scale_factor": 1e6,
      "zero_init_output": False}
GAL = {"g": 4.5e-6, "softening": 0.05, "galaxy": {}}


def _pos(n, seed=3):
    p, v, m = inputs.galaxy(seed, 0, n, GAL)
    return torch.from_numpy(p), torch.from_numpy(v), torch.from_numpy(m)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in {"nbody_tpu_torch", "nbody_tpu", "jax", "jaxlib",
                                                  "flax"}, (path, name)
                assert not name.startswith("benchmark.") or name.startswith("benchmark.reference"), \
                    (path, name)


@pytest.mark.parametrize("n,k,include_self", [(300, 10, False), (1500, 10, False), (1500, 32, True)])
def test_morton_knn_is_the_kernel_search(n, k, include_self):
    from nbody_tpu_torch.ops.spatial import knn_morton

    pos, _, _ = _pos(n)
    want = knn_morton(pos, k, include_self=include_self, impl="kernel")
    got = morton.knn(pos, k, include_self=include_self)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_morton_radius_is_the_kernel_radius_search():
    from nbody_tpu_torch.ops.radius import radius_neighbors

    pos, _, _ = _pos(1500)
    want = radius_neighbors(pos, 1.0, k_max=32, include_self=True, method="morton", impl="kernel")
    got = morton.radius(pos, 1.0, k_max=32, include_self=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _port_gnn(w):
    from nbody_tpu_torch.models import GraphModel

    m = GraphModel(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean", neighbors=10,
                   scale_factor=1e6, fused_edgeconv=False)
    m.load_state_dict(w)
    return m.eval()


def _port_contconv(w):
    from nbody_tpu_torch.models import ContinuousConvModel

    m = ContinuousConvModel(in_channels=4, filter_resolution=(6, 4), radius=1.0, agg="mean",
                            self_loops=True, continuous_conv_layers=2, continuous_conv_dim=16,
                            encoder_hiddens=(8, 12), decoder_hiddens=(12, 8), scale_factor=1e6,
                            conv_impl="dense")
    m.load_state_dict(w)
    return m


def test_gnn_forward_is_the_port_dense_edgeconv():
    pos, vel, mass = _pos(400)
    w = weights.draw(GNN, 7, "cpu")
    idx, valid = morton.knn(pos, 10)
    x = torch.cat([pos, vel, mass[:, None]], -1)[None]
    want = _port_gnn(w)(x, idx[None], valid[None])[0]
    got = ref_models.gnn_forward(w, GNN, pos, mass, idx, valid, rows=97)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.detach().abs().max()))


@pytest.mark.parametrize("train", [False, True])
def test_contconv_forward_is_the_port_dense_layer(train):
    pos, vel, mass = _pos(400)
    w = weights.draw(CC, 8, "cpu")
    idx, valid = morton.radius(pos, 1.0)
    x = torch.cat([pos, vel, mass[:, None]], -1)[None]
    model = _port_contconv(w).train(train)
    want = model(x, idx[None], valid[None], node_mask=torch.ones(1, 400, dtype=torch.bool))[0]
    got = ref_models.contconv_forward(w, CC, pos, mass, idx, valid, train=train, rows=61)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.detach().abs().max()))


def test_adam_steps_are_torch_adam_on_the_port():
    pos, vel, mass = _pos(400)
    target = torch.from_numpy(inputs.sampled_accelerations(
        pos.numpy(), mass.numpy(), 4.5e-6, 0.05, 64, [1, 2], "cpu"))
    w = weights.draw(GNN, 9, "cpu")
    idx, valid = morton.knn(pos, 10)
    model = _port_gnn(w).train()
    opt = torch.optim.Adam(model.parameters(), lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    x = torch.cat([pos, vel, mass[:, None]], -1)[None]
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = 1e6 * torch.sqrt(((model(x, idx[None], valid[None])[0] - target) ** 2).mean())
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))

    def loss_of(t, leaves):
        pred = ref_models.gnn_forward(leaves, GNN, pos, mass, idx, valid)
        return ref_models.scaled_rmse(pred, target, 1e6)

    r_loss, _, r_after = ref_train.adam(w, loss_of, 3, 0.01)
    np.testing.assert_allclose(r_loss, losses, rtol=1e-5)
    for name, p in model.named_parameters():
        torch.testing.assert_close(r_after[name], p.detach(), rtol=1e-4, atol=1e-6)


def test_epoch_order_is_the_trainers(tmp_path):
    from nbody_tpu_torch.train.trainer import _group_rng

    path = str(tmp_path / "train.npz")
    rng = _group_rng(0, [path])
    keys = [1500]
    rng.shuffle(keys)
    assert np.array_equal(ref_train.epoch_order(0, path, 1500, 8), rng.permutation(8))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12])
    got = ref_models.round_tf32(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -9, 1.0]


def test_spiral_is_seeded_and_has_its_black_hole():
    a = inputs.spiral([2 ** 31 + 5, 0], 1000)
    b = inputs.spiral([2 ** 31 + 5, 0], 1000)
    c = inputs.spiral([2 ** 31 + 6, 0], 1000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    pos, vel, mass = a
    assert pos.dtype == np.float32 and pos.shape == (1000, 3)
    assert np.all(pos[0] == 0) and np.all(vel[0] == 0)
    assert math.isclose(float(mass.sum()), 1.0, rel_tol=1e-5) and math.isclose(float(mass[0]), 0.01, rel_tol=1e-6)
    r = np.hypot(pos[1:, 0], pos[1:, 1])
    assert 5.0 < r.mean() < 7.0  # Gamma(2, 3) has mean 6


def test_sampled_accelerations_with_every_source_are_the_direct_sum():
    pos, _, mass = (t.numpy() for t in _pos(300))
    got = inputs.sampled_accelerations(pos, mass, 4.5e-6, 0.05, 10 ** 6, [0], "cpu", block=64)
    d = pos[None, :, :].astype(np.float64) - pos[:, None, :]
    inv = (np.sum(d * d, -1) + 0.05 ** 2) ** -1.5
    want = 4.5e-6 * np.einsum("ij,ijk->ik", mass[None, :] * inv, d)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


def test_training_data_file_is_the_trainers_schema(tmp_path):
    from nbody_tpu_torch.data.dataset import SnapshotDataset

    path = tmp_path / "d" / "train.npz"
    inputs.write_snapshots(str(path), 4, 700, 3, GAL, 32, "cpu")
    ds = SnapshotDataset.from_file(str(path))
    assert list(ds.buckets) == [700] and ds.n_snapshots == 3
    assert ds.buckets[700].x.shape == (3, 700, 7)
    assert not np.array_equal(ds.buckets[700].x[0], ds.buckets[700].x[1])
    assert pathlib.Path(path).stat().st_size < 3 * 700 * 40 + 4096
