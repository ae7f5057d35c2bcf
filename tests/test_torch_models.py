"""Port kNN, masked reductions and the EdgeConv ``GraphModel`` against the
JAX package: exact kNN index sets equal on tie-free inputs (dense and
chunked paths), and a flax ``GraphModel`` converted with
``graph_model_state_dict`` gives the same forward at rtol 1e-4, atol 1e-5
(tests/test_models.py:69)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import GraphModel as JGraphModel
from nbody_tpu.ops import knn as jknn
from nbody_tpu.ops import segment as jseg
from nbody_tpu_torch.models import GraphModel, graph_model_state_dict
from nbody_tpu_torch.models.common import (gather_neighbors, masked_mse,
                                           scaled_rmse_and_mse, select_input_features)
from nbody_tpu_torch.ops import knn as tknn
from nbody_tpu_torch.ops import segment as tseg


def _sets(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [sorted(r[v].tolist()) for r, v in zip(idx.reshape(-1, idx.shape[-1]),
                                                  valid.reshape(-1, valid.shape[-1]))]


def _assert_same_graph(t_out, j_out):
    np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
    assert _sets(*t_out) == _sets(*j_out)
    assert t_out[0].dtype == torch.int32


@pytest.mark.parametrize("include_self", [False, True])
@pytest.mark.parametrize("chunk", [None, 16])
def test_knn_matches_jax(include_self, chunk):
    pos = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    got = tknn.knn_neighbors(torch.from_numpy(pos), 6, include_self=include_self,
                             chunk_size=chunk)
    want = jknn.knn_neighbors(jnp.asarray(pos), 6, include_self=include_self,
                              chunk_size=chunk)
    _assert_same_graph(got, want)


@pytest.mark.parametrize("chunk", [None, 8])
def test_knn_mask_and_short_rows_match_jax(chunk):
    pos = np.random.default_rng(1).normal(size=(30, 3)).astype(np.float32)
    mask = np.arange(30) < 22
    got = tknn.knn_neighbors(torch.from_numpy(pos), 5, mask=torch.from_numpy(mask),
                             chunk_size=chunk)
    want = jknn.knn_neighbors(jnp.asarray(pos), 5, mask=jnp.asarray(mask),
                              chunk_size=chunk)
    _assert_same_graph(got, want)
    assert not got[1][22:].any()
    # fewer than k other particles: surplus slots invalid and pointing at 0
    idx, valid = tknn.knn_neighbors(torch.from_numpy(pos[:3]), 10)
    assert idx.shape == (3, 3) and valid.sum() == 6
    assert torch.all(idx[~valid] == 0)


def test_chunked_knn_equals_dense():
    pos = torch.from_numpy(np.random.default_rng(2).normal(size=(200, 3)).astype(np.float32))
    dense = tknn.knn_neighbors(pos, 10)
    chunked = tknn.knn_neighbors(pos, 10, chunk_size=64)
    assert _sets(*dense) == _sets(*chunked)


def test_batched_knn_matches_jax_and_approx_raises():
    pos = np.random.default_rng(3).normal(size=(3, 25, 3)).astype(np.float32)
    mask = np.ones((3, 25), bool)
    mask[1, 20:] = False
    got = tknn.batched_knn_neighbors(torch.from_numpy(pos), 4, mask=torch.from_numpy(mask))
    want = jknn.batched_knn_neighbors(jnp.asarray(pos), 4, mask=jnp.asarray(mask))
    assert got[0].shape == (3, 25, 4)
    _assert_same_graph(got, want)
    with pytest.raises(NotImplementedError):
        tknn.knn_neighbors(torch.from_numpy(pos[0]), 4, approx=True)


@pytest.mark.parametrize("how", ["sum", "mean"])
def test_masked_aggregate_matches_jax(how):
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(2, 6, 4, 3)).astype(np.float32)
    valid = rng.uniform(size=(2, 6, 4)) > 0.4
    valid[0, 0] = False  # a node without neighbours
    got = tseg.masked_aggregate(torch.from_numpy(vals), torch.from_numpy(valid), how, axis=2)
    want = jseg.masked_aggregate(jnp.asarray(vals), jnp.asarray(valid), how, axis=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tseg.masked_aggregate(torch.from_numpy(vals), torch.from_numpy(valid), "max")


def test_common_helpers():
    x = torch.arange(2 * 3 * 7, dtype=torch.float32).reshape(2, 3, 7)
    sel = select_input_features(x, 4)
    assert torch.equal(sel, torch.cat([x[..., :3], x[..., 6:]], -1))
    assert select_input_features(x, 7) is x
    idx = torch.tensor([[[1, 2], [0, 0], [2, 1]]] * 2)
    g = gather_neighbors(x, idx)
    assert g.shape == (2, 3, 2, 7) and torch.equal(g[1, 0, 1], x[1, 2])
    pred, y = torch.ones(1, 2, 3), torch.zeros(1, 2, 3)
    mask = torch.tensor([[True, False]])
    assert float(masked_mse(pred, y, mask)) == 1.0
    loss, mse = scaled_rmse_and_mse(pred * 2, y, 10.0)
    assert float(mse) == 4.0 and float(loss) == 20.0


CONFIGS = [
    # the reference recipe's architecture at a narrow width
    dict(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
         neighbors=5, scale_factor=1e6),
    # encoder, hidden decoder, sum aggregation, all 7 features, output scale
    dict(input_dim=7, node_encoder_dims=(12,), output_hiddens=(8,), gnn_dim=16,
         message_passing_steps=1, aggr="sum", neighbors=4, output_scale=1e3),
    dict(input_dim=4, gnn_dim=8, message_passing_steps=3, aggr="mean",
         neighbors=3, zero_init_output=True),
]


def _inputs(b=2, n=20, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(b, n, 3)).astype(np.float32)
    vel = rng.normal(size=(b, n, 3)).astype(np.float32) * 0.1
    mass = rng.uniform(0.1, 1, size=(b, n, 1)).astype(np.float32)
    return np.concatenate([pos, vel, mass], axis=-1)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_converted_graph_model_matches_flax(cfg):
    x = _inputs(seed=len(cfg))
    jmodel = JGraphModel(**cfg)
    idx, valid = jknn.batched_knn_neighbors(jnp.asarray(x[..., :3]), cfg["neighbors"])
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), idx, valid)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), idx, valid))

    model = GraphModel(**cfg).eval()
    model.load_state_dict(graph_model_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)))
    t_idx, t_valid = tknn.batched_knn_neighbors(torch.from_numpy(x[..., :3]),
                                                cfg["neighbors"])
    _assert_same_graph((t_idx, t_valid), (idx, valid))
    with torch.no_grad():
        got = model(torch.from_numpy(x), t_idx, t_valid).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 / cfg.get("output_scale", 1.0))


def test_graph_model_padding_invariance():
    x = torch.from_numpy(_inputs(b=1, n=16, seed=2))
    model = GraphModel(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
                       neighbors=4, generator=torch.Generator().manual_seed(2)).eval()
    idx, valid = tknn.batched_knn_neighbors(x[..., :3], 4)
    x_pad = torch.cat([x, torch.ones(1, 6, 7)], dim=1)
    mask = torch.arange(22)[None, :] < 16
    idx_p, valid_p = tknn.batched_knn_neighbors(x_pad[..., :3], 4, mask=mask)
    with torch.no_grad():
        out, out_p = model(x, idx, valid), model(x_pad, idx_p, valid_p, node_mask=mask)
    torch.testing.assert_close(out_p[:, :16], out, rtol=1e-5, atol=1e-6)


def test_seeded_init_and_config():
    kw = dict(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
              neighbors=10, scale_factor=1e6)
    a = GraphModel(**kw, generator=torch.Generator().manual_seed(0))
    b = GraphModel(**kw, generator=torch.Generator().manual_seed(0))
    c = GraphModel(**kw, generator=torch.Generator().manual_seed(1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["convs.0.dense0.weight"], sc["convs.0.dense0.weight"])
    w = sa["convs.0.dense0.weight"]  # torch nn.Linear init: U(+-1/sqrt(fan_in))
    assert w.shape == (64, 8) and float(w.abs().max()) <= 8 ** -0.5
    assert a.graph_spec == ("knn", {"k": 10, "include_self": False, "method": "exact"})
    assert a.get_config() == JGraphModel(**kw).get_config()


@pytest.mark.parametrize("bad", [dict(knn_method="approx")])
def test_unported_options_raise(bad):
    with pytest.raises(NotImplementedError):
        GraphModel(**bad)


def _fused_case(aggr, **extra):
    """A flax GraphModel's variables, a graph with one node that has no
    valid neighbour, and the inputs as numpy."""
    x = _inputs(seed=7)
    idx, valid = jknn.batched_knn_neighbors(jnp.asarray(x[..., :3]), 5)
    valid = valid.at[0, 0, :].set(False)
    kwargs = dict(input_dim=4, gnn_dim=32, message_passing_steps=2, aggr=aggr, neighbors=5,
                  scale_factor=1e6, **extra)
    variables = JGraphModel(**kwargs).init(jax.random.PRNGKey(0), jnp.asarray(x), idx, valid)
    return x, idx, valid, kwargs, variables


@pytest.mark.parametrize("aggr", ["mean", "sum"])
@pytest.mark.parametrize("against", ["unfused", "flax_fused", "flax_unfused"])
def test_fused_edgeconv_matches_unfused_and_flax(aggr, against):
    """``fused_edgeconv=True`` is the same function of the same parameters
    (``tests/test_models.py:269-290``: rtol 2e-4, atol 2e-5), the node
    without valid neighbours included: against the port's unfused layer and
    against the flax model, fused and not, on converted weights."""
    x, idx, valid, kwargs, variables = _fused_case(aggr)
    sd = graph_model_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    fused = GraphModel(**kwargs, fused_edgeconv=True).eval()
    assert list(fused.state_dict()) == list(GraphModel(**kwargs).state_dict())
    fused.load_state_dict(sd)
    t_idx, t_valid = torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))
    with torch.no_grad():
        got = fused(torch.from_numpy(x), t_idx, t_valid).numpy()
        if against == "unfused":
            ref = GraphModel(**kwargs).eval()
            ref.load_state_dict(sd)
            want = ref(torch.from_numpy(x), t_idx, t_valid).numpy()
        else:
            jm = JGraphModel(**kwargs, fused_edgeconv=against == "flax_fused")
            want = np.asarray(jm.apply(variables, jnp.asarray(x), idx, valid))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_remat_same_params_loss_and_grads(fused):
    """``remat=True`` changes only what the backward pass keeps: the same
    ``state_dict`` keys, the same loss and gradients bit for bit
    (``tests/test_models.py:293-318``), and the flax model's gradients on
    converted weights at rtol 2e-4."""
    x, idx, valid, kwargs, variables = _fused_case("mean", fused_edgeconv=fused,
                                                   output_scale=1e6)
    sd = graph_model_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    t_idx, t_valid = torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))
    results = []
    for remat in (False, True):
        m = GraphModel(**kwargs, remat=remat).train()
        assert list(m.state_dict()) == list(sd)
        m.load_state_dict(sd)
        loss = (m(torch.from_numpy(x), t_idx, t_valid) ** 2).sum() * 1e12
        loss.backward()
        results.append((float(loss.detach()), {n: p.grad.clone() for n, p in m.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    jm = JGraphModel(**kwargs, remat=True)
    jl, jg = jax.value_and_grad(
        lambda p: jnp.sum(jm.apply(p, jnp.asarray(x), idx, valid) ** 2) * 1e12)(variables)
    np.testing.assert_allclose(l1, float(jl), rtol=2e-4)
    want = graph_model_state_dict(jax.tree_util.tree_map(np.asarray, jg))
    for name, ref in want.items():
        np.testing.assert_allclose(g1[name].numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-5 * float(ref.abs().max()), err_msg=name)


def test_remat_leaves_inference_unchanged():
    """Under ``torch.no_grad`` (the rollout) a remat model gives the same
    output as one without the flag."""
    x, idx, valid, kwargs, variables = _fused_case("sum", fused_edgeconv=True)
    sd = graph_model_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    t_idx, t_valid = torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(valid))
    outs = []
    for remat in (False, True):
        m = GraphModel(**kwargs, remat=remat).eval()
        m.load_state_dict(sd)
        with torch.no_grad():
            outs.append(m(torch.from_numpy(x), t_idx, t_valid))
    assert torch.equal(outs[0], outs[1])
