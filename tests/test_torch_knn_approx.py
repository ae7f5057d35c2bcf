"""The ``approx`` kNN method against the JAX package: ``lax.approx_max_k``
as XLA computes it off the TPU is the exact top-k, so the port's
``knn_neighbors(approx=True)`` must give the JAX function's validity and
each row's ids on galaxies, on the dense path (300 bodies; in the same
order) and the chunked one (5,000; as sets), with and without a mask and
self edges. The chunked path's distances come from the norm expansion
|a|^2 + |b|^2 - 2 a.b in float32, which the two packages round differently:
a row may swap two ids only where both lie within that rounding of the
row's k-th distance in float64 (a tie in float32), and the test checks that
of every row that differs. ``build_graph`` with
``method="approx"`` must give the ``"exact"`` graph; and a converted
``GraphModel(knn_method="approx")`` must give flax's forward at rtol 1e-4
(tests/test_models.py:69)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import GraphModel as JGraphModel
from nbody_tpu.ops import knn as jknn
from nbody_tpu.train import graphs as jgraphs
from nbody_tpu_torch.models import GraphModel, graph_model_state_dict
from nbody_tpu_torch.ops import knn as tknn
from nbody_tpu_torch.train import graphs as tgraphs

K = 10


def _galaxy(n, seed, batch=None):
    """An exponential disk drawn with numpy: gamma(2) radii, uniform angles,
    a thin normal height; (n, 3) float32, or (batch, n, 3)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    r = rng.gamma(2.0, 1.0, size=shape)
    phi = rng.uniform(0, 2 * np.pi, size=shape)
    z = rng.normal(0, 0.1, size=shape)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1).astype(np.float32)


def _mask(n, seed):
    return np.random.default_rng(seed).uniform(size=n) > 0.1


def _sets(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [sorted(r[v].tolist()) for r, v in zip(idx.reshape(-1, idx.shape[-1]),
                                                  valid.reshape(-1, valid.shape[-1]))]


def _assert_same_up_to_ties(pos, got, want):
    """Equal validity and id sets, but for rows whose swapped ids are float32
    ties of the norm expansion at the row's k-th distance."""
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    p64, eps = pos.astype(np.float64), float(np.finfo(np.float32).eps)
    differ = 0
    for i, (a, b) in enumerate(zip(_sets(*got), _sets(*want))):
        if a == b:
            continue
        differ += 1
        d2 = lambda j: float(((p64[i] - p64[j]) ** 2).sum())
        kth = max(d2(j) for j in b)
        for j in set(a) ^ set(b):
            bound = 8 * eps * (float(p64[i] @ p64[i]) + float(p64[j] @ p64[j]))
            assert abs(d2(j) - kth) <= bound, (i, j, d2(j), kth, bound)
    assert differ <= len(pos) // 1000, differ


@pytest.mark.parametrize("include_self", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [300, 5000])
def test_approx_knn_matches_jax(n, masked, include_self):
    pos = _galaxy(n, seed=n)
    mask = _mask(n, seed=n + 1) if masked else None
    got = tknn.knn_neighbors(torch.from_numpy(pos), K, include_self=include_self,
                             mask=None if mask is None else torch.from_numpy(mask),
                             approx=True)
    want = jknn.knn_neighbors(jnp.asarray(pos), K, include_self=include_self,
                              mask=None if mask is None else jnp.asarray(mask), approx=True)
    if n <= jknn._CHUNKED_THRESHOLD:  # the dense path: the same ids in the same order
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    else:
        _assert_same_up_to_ties(pos, got, want)
    assert got[0].dtype == torch.int32
    exact = tknn.knn_neighbors(torch.from_numpy(pos), K, include_self=include_self,
                               mask=None if mask is None else torch.from_numpy(mask))
    assert torch.equal(got[0], exact[0]) and torch.equal(got[1], exact[1])


def test_build_graph_approx_is_exact():
    pos = torch.from_numpy(_galaxy(400, seed=7, batch=2))
    mask = torch.from_numpy(np.stack([_mask(400, 8), np.ones(400, bool)]))
    spec = {"k": K, "include_self": False}
    approx = tgraphs.build_graph(("knn", {**spec, "method": "approx"}), pos, mask)
    exact = tgraphs.build_graph(("knn", {**spec, "method": "exact"}), pos, mask)
    assert torch.equal(approx[0], exact[0]) and torch.equal(approx[1], exact[1])
    want = jgraphs.build_graph(("knn", {**spec, "method": "approx"}), jnp.asarray(pos.numpy()),
                               jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(approx[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(approx[1].numpy(), np.asarray(want[1]))


def test_converted_approx_graph_model_matches_flax():
    """At 5,000 bodies, so that the graph comes from the chunked path."""
    n = 5000
    rng = np.random.default_rng(11)
    x = np.concatenate([_galaxy(n, seed=10, batch=1),
                        rng.normal(size=(1, n, 3)).astype(np.float32) * 0.1,
                        rng.uniform(0.1, 1, size=(1, n, 1)).astype(np.float32)], -1)
    cfg = dict(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
               neighbors=K, scale_factor=1e6, knn_method="approx")
    jmodel = JGraphModel(**cfg)
    idx, valid = jgraphs.build_graph(jmodel.graph_spec, jnp.asarray(x[..., :3]))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.asarray(x), idx, valid)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x), idx, valid))

    model = GraphModel(**cfg).eval()
    model.load_state_dict(graph_model_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)))
    assert model.graph_spec == ("knn", {"k": K, "include_self": False, "method": "approx"})
    t_idx, t_valid = tgraphs.build_graph(model.graph_spec, torch.from_numpy(x[..., :3]))
    _assert_same_up_to_ties(x[0, :, :3], (t_idx[0], t_valid[0]), (idx[0], valid[0]))
    with torch.no_grad():
        got = model(torch.from_numpy(x), t_idx, t_valid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
