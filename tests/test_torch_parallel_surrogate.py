"""The port's particle-sharded surrogate (``nbody_tpu_torch/parallel/
surrogate.py``), ``ops.knn.knn_query`` and the layers' gather sources
(``EdgeConv(h_src=)``, ``ContinuousConv(feat_src=)``,
``conv_geometry(pos_src=)``) against the JAX package, on the CPU. The
sharded functions run on 2 gloo ranks, started once for the module
(``tests/_parallel_ranks.surrogate``), on flax weights converted with
``graph_model_state_dict`` / ``contconv_model_state_dict``; the JAX side
runs in this process on ``make_mesh(2)``. The cases are
``tests/test_sharded_surrogate.py``'s, with its sizes and seeds.

Bars. Against the port's single-rank functions, the JAX sharded tests'
own: forwards rtol 2e-5 (GNN) or 5e-5 (ContConv), atol 1e-7; rollouts rtol
5e-5, atol 1e-7 (ContConv rtol 5e-4, atol 1e-6). Against the JAX sharded
functions, the port's bars for a converted flax model: GNN rtol 1e-4, atol
1e-5 / output_scale (``tests/test_models.py:69``), ContConv rtol 2e-4,
atol 1e-5 of max |a| (``tests/test_torch_contconv.py``), on forwards and
rollouts alike. Against both: losses rtol 1e-5; gradients rtol 2e-4, atol
1e-7 (GNN) or 1e-5 (ContConv), where a Linear bias that feeds a batch norm
is left out (its gradient is zero up to rounding noise, which the JAX
test's atol 1e-5 covers between two JAX runs and the port's tests leave out
between two implementations); batch-norm statistics rtol 1e-5, atol 1e-8.
``knn_query`` returns JAX's neighbour sets; the gather-source layers match
flax at the layers' bars (EdgeConv rtol 2e-4, atol 2e-5,
``tests/test_torch_models.py``; ContConv rtol 2e-4, atol 1e-5), and a layer
given its own input as the gather source, or none, gives today's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _parallel_ranks import surrogate
from nbody_tpu.models import ContinuousConvModel as JContConv
from nbody_tpu.models import GraphModel as JGraphModel
from nbody_tpu.models.contconv import ContinuousConv as JConv
from nbody_tpu.models.contconv import conv_geometry as jconv_geometry
from nbody_tpu.models.gnn import EdgeConv as JEdgeConv
from nbody_tpu.ops.knn import knn_query as jknn_query
from nbody_tpu.parallel import surrogate as jps
from nbody_tpu.parallel.mesh import make_mesh
from nbody_tpu.train.graphs import build_graph as jbuild_graph
from nbody_tpu_torch.models import contconv_model_state_dict, graph_model_state_dict
from nbody_tpu_torch.models.contconv import ContinuousConv, conv_geometry
from nbody_tpu_torch.models.gnn import EdgeConv
from nbody_tpu_torch.ops.knn import knn_query
from nbody_tpu_torch.parallel.launch import run_ranks

GNN = dict(input_dim=4, gnn_dim=16, message_passing_steps=2, neighbors=5, scale_factor=1e6)
GNN_ENC = dict(GNN, node_encoder_dims=(16,), output_scale=1e3)
CC = dict(in_channels=4, filter_resolution=(4, 3), radius=1.5, continuous_conv_layers=2,
          continuous_conv_dim=8, encoder_hiddens=(8,), decoder_hiddens=(8,),
          scale_factor=1e6, radius_kmax=6, self_loops=True)
CC_ONE = dict(in_channels=4, filter_resolution=(4,), radius=1.0, continuous_conv_layers=1,
              continuous_conv_dim=8, scale_factor=1e6, radius_kmax=6, self_loops=True)
# name: (family, flax kwargs, N, seed, kind, extra): the cases, sizes and
# seeds of tests/test_sharded_surrogate.py, on six parameter layouts (cases
# of one layout share the weights of its first case; weights are drawn by
# flax's init, which takes seconds a layout on the CPU)
CASES = {
    "predict_gnn_mean": ("gnn", dict(GNN, aggr="mean", output_scale=1e3), 64, 0, "predict", {}),
    "predict_gnn_encoder_sum": ("gnn", dict(GNN_ENC, aggr="sum"), 64, 0, "predict", {}),
    "predict_gnn_hiddens": ("gnn", dict(input_dim=7, gnn_dim=8, message_passing_steps=1,
                                        aggr="mean", output_hiddens=(12,), neighbors=3,
                                        scale_factor=1e6), 32, 2, "predict", {}),
    "predict_gnn_morton": ("gnn", dict(GNN, aggr="mean", knn_method="morton",
                                       knn_impl="pallas_interpret"), 640, 5, "predict", {}),
    "rollout_gnn": ("gnn", dict(GNN, aggr="mean", neighbors=4), 40, 1, "rollout",
                    dict(steps=5, dt=1e-3)),
    "predict_cc": ("cc", dict(CC, output_scale=1e3), 48, 3, "predict", {}),
    "predict_cc_no_encoder": ("cc", dict(in_channels=7, filter_resolution=4, radius=2.0,
                                         continuous_conv_layers=1, continuous_conv_dim=8,
                                         scale_factor=1e6, radius_kmax=5, self_loops=False,
                                         agg="sum"), 32, 4, "predict", {}),
    "predict_cc_morton": ("cc", dict(CC_ONE, radius_method="morton",
                                     radius_impl="pallas_interpret"), 640, 6, "predict", {}),
    "rollout_cc": ("cc", CC, 48, 9, "rollout", dict(steps=4, dt=1e-3)),
    "grad_gnn": ("gnn", dict(GNN_ENC, aggr="mean"), 64, 5, "grad", dict(y_seed=6)),
    "grad_cc": ("cc", dict(CC, output_scale=1e3), 64, 10, "grad", dict(y_seed=11)),
    "grad_cc_kernel": ("cc", dict(CC, output_scale=1e3, conv_impl="pallas_interpret"), 64,
                       10, "grad", dict(y_seed=11)),
    "descend_gnn": ("gnn", dict(GNN, aggr="mean", neighbors=4), 48, 7, "descend",
                    dict(y_seed=8)),
    "descend_cc": ("cc", dict(CC, radius_kmax=5), 48, 12, "descend", dict(y_seed=13)),
    "chunks": ("cc", CC, 48, 3, "chunks", {}),
}
# the constructor fields that shape the parameters
LAYOUT = ("input_dim", "gnn_dim", "message_passing_steps", "node_encoder_dims",
          "output_hiddens", "in_channels", "filter_resolution", "continuous_conv_layers",
          "continuous_conv_dim", "encoder_hiddens", "decoder_hiddens")
PORT_NAMES = {"pallas_interpret": "kernel", "xla": "dense"}


def _setup(model, n, seed, inits):
    """tests/test_sharded_surrogate.py's ``_setup``: JAX-drawn bodies and
    the model's initial variables, drawn once a parameter layout (on 16
    bodies: the parameters do not depend on N) and kept in ``inits``."""
    kp, kv, km, ki = jax.random.split(jax.random.PRNGKey(seed), 4)
    pos = jax.random.normal(kp, (n, 3))
    vel = jax.random.normal(kv, (n, 3)) * 0.1
    mass = jax.random.uniform(km, (n,), minval=0.5, maxval=1.5)
    layout = (type(model).__name__,) + tuple(getattr(model, f, None) for f in LAYOUT)
    if layout not in inits:
        x = jnp.concatenate([pos, vel, mass[:, None]], -1)[None, :16]
        idx, valid = jbuild_graph(model.graph_spec, x[..., :3])
        inits[layout] = jax.jit(model.init)(ki, x, idx, valid)  # jit: one compile
    return pos, vel, mass, inits[layout]


def _pre_norm_biases(kwargs) -> set:
    """The biases of the ContConv encoder's Linear layers that feed a batch
    norm. Their gradient is zero up to rounding noise (the batch mean
    cancels them), which two implementations draw differently: they are
    left out of the comparisons, as in ``tests/test_torch_train.py``."""
    return {f"encoder.layers.{i}.bias" for i in range(len(kwargs.get("encoder_hiddens") or ()))}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_state(family, variables):
    if family == "gnn":
        sd = graph_model_state_dict(_np_tree(variables["params"]))
    else:
        sd = contconv_model_state_dict(_np_tree(variables))
    return {k: v.numpy() for k, v in sd.items()}


def _jax_model(family, kw):
    return (JGraphModel if family == "gnn" else JContConv)(**kw)


@pytest.fixture(scope="module")
def port():
    jax_side, inp, inits = {}, {}, {}
    for name, (family, kw, n, seed, kind, extra) in CASES.items():
        jm = _jax_model(family, kw)
        pos, vel, mass, variables = _setup(jm, n, seed, inits)
        port_kw = {k: PORT_NAMES.get(v, v) if isinstance(v, str) else v for k, v in kw.items()}
        c = {"model": {"family": family, "kwargs": port_kw,
                       "state": _port_state(family, variables)},
             "pos": np.asarray(pos), "vel": np.asarray(vel), "mass": np.asarray(mass),
             "kind": kind, **{k: v for k, v in extra.items() if k != "y_seed"}}
        if "y_seed" in extra:
            c["y"] = np.asarray(jax.random.normal(jax.random.PRNGKey(extra["y_seed"]),
                                                  (n, 3)) * 1e-6)
        inp[name] = c
        jax_side[name] = (jm, variables)
    out = run_ranks(surrogate, 2, "gloo", inp, device="cpu", timeout=300)
    return {"out": out, "in": inp, "jax": jax_side}


def _close_to_jax(got, want, name):
    """The port's bar for a converted flax model (see the module notes)."""
    want = np.asarray(want)
    kw = CASES[name][1]
    if CASES[name][0] == "gnn":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 / kw.get("output_scale", 1.0))
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * np.abs(want).max())


def _args(port, name):
    c = port["in"][name]
    jm, variables = port["jax"][name]
    return c, jm, variables, (c["pos"], c["vel"], c["mass"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[4] == "predict"])
def test_sharded_predict_matches_jax_and_single_rank(port, name):
    c, jm, variables, (p, v, m) = _args(port, name)
    fn = jps.sharded_predict if CASES[name][0] == "gnn" else jps.sharded_contconv_predict
    want = np.asarray(fn(jm, variables, p, v, m, make_mesh(2)))
    rtol = 2e-5 if CASES[name][0] == "gnn" else 5e-5
    got = port["out"][name]
    _close_to_jax(got["sharded"], want, name)
    np.testing.assert_allclose(got["sharded"], got["single"], rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("name", ["rollout_gnn", "rollout_cc"])
def test_sharded_rollout_matches_jax_and_single_rank(port, name):
    c, jm, variables, (p, v, m) = _args(port, name)
    gnn = CASES[name][0] == "gnn"
    fn = jps.sharded_rollout if gnn else jps.sharded_contconv_rollout
    want = fn(jm, variables, p, v, m, c["steps"], c["dt"], make_mesh(2))
    rtol, atol = (5e-5, 1e-7) if gnn else (5e-4, 1e-6)
    got = port["out"][name]
    assert got["sharded"][0].shape == (c["steps"], p.shape[0], 3)
    for g, w, s in zip(got["sharded"], want, got["single"]):
        _close_to_jax(g, w, name)
        np.testing.assert_allclose(g, s, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["grad_gnn", "grad_cc", "grad_cc_kernel"])
def test_sharded_loss_and_grad_match_jax_and_single_rank(port, name):
    c, jm, variables, (p, v, m) = _args(port, name)
    family = CASES[name][0]
    got = port["out"][name]
    if family == "gnn":
        loss, grads = jps.sharded_loss_and_grad(jm, variables, p, v, m, c["y"], make_mesh(2))
        want = graph_model_state_dict(_np_tree(grads))
        atol = 1e-7
    else:
        loss, grads, stats = jps.sharded_contconv_loss_and_grad(jm, variables, p, v, m,
                                                                c["y"], make_mesh(2))
        want = contconv_model_state_dict(_np_tree({"params": grads, "batch_stats": stats}))
        atol = 1e-5
        for k, s in got["stats"].items():
            np.testing.assert_allclose(s, want[k].numpy(), rtol=1e-5, atol=1e-8, err_msg=k)
            np.testing.assert_allclose(s, got["single_stats"][k], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(got["loss"], got["single_loss"], rtol=1e-5)
    assert set(got["grads"]) <= set(want)
    for k, g in got["grads"].items():
        if k in _pre_norm_biases(port["in"][name]["model"]["kwargs"]):
            continue
        np.testing.assert_allclose(g, want[k].numpy(), rtol=2e-4, atol=atol, err_msg=k)
        np.testing.assert_allclose(g, got["single_grads"][k], rtol=2e-4, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ["descend_gnn", "descend_cc"])
def test_sharded_gradients_descend(port, name):
    """A few Adam steps on the sharded gradients reduce the sharded loss:
    the minimal particle-sharded training loop of the JAX tests."""
    losses = port["out"][name]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_sharded_contconv_refuses_node_chunks(port):
    assert "node_chunks=2" in port["out"]["chunks"]["raised"]


# ------------------------------------------------- knn_query, gather sources

@pytest.mark.parametrize("q_offset,include_self,masked", [
    (0, False, False), (24, False, False), (24, True, False), (8, False, True)])
def test_knn_query_matches_jax(q_offset, include_self, masked):
    rng = np.random.default_rng(q_offset + include_self)
    pos_c = rng.normal(size=(64, 3)).astype(np.float32)
    pos_q = pos_c[q_offset:q_offset + 16]
    mask = (np.arange(64) % 5 != 0) if masked else None
    got = knn_query(torch.from_numpy(pos_q), torch.from_numpy(pos_c), 6, q_offset=q_offset,
                    include_self=include_self,
                    mask_c=None if mask is None else torch.from_numpy(mask))
    want = jknn_query(pos_q, pos_c, 6, q_offset=q_offset, include_self=include_self,
                      mask_c=mask)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.int32
    for g, w, ok in zip(got[0].numpy(), np.asarray(want[0]), got[1].numpy()):
        assert sorted(g[ok]) == sorted(w[ok])
    # the own slot is excluded unless asked for; invalid slots point at 0
    rows = q_offset + np.arange(16)
    assert include_self or not (got[0].numpy() == rows[:, None]).any()
    assert (got[0].numpy()[~got[1].numpy()] == 0).all()


def _gather_case(n_src=40, n_rcv=16, k=5, d=6, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(1, n_src, d)).astype(np.float32)
    idx = rng.integers(0, n_src, size=(1, n_rcv, k)).astype(np.int32)
    valid = rng.uniform(size=(1, n_rcv, k)) > 0.2
    return src, src[:, 8:8 + n_rcv], idx, valid


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_edgeconv_gather_source_matches_jax(fused, aggr):
    src, h, idx, valid = _gather_case()
    jl = JEdgeConv(12, aggr, fused)
    params = jl.init(jax.random.PRNGKey(1), h, idx, valid, h_src=src)
    want = np.asarray(jl.apply(params, h, idx, valid, h_src=src))
    sd = graph_model_state_dict({"EdgeConv_0": _np_tree(params["params"])})
    layer = EdgeConv(6, 12, aggr, fused=fused)
    layer.load_state_dict({k[len("convs.0."):]: v for k, v in sd.items()})
    t = [torch.from_numpy(a) for a in (h, idx, valid, src)]
    got = layer(*t[:3], h_src=t[3]).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # no gather source, or the receivers themselves: the bits of the plain call
    own = [torch.from_numpy(a) for a in (src, *_gather_case(n_rcv=40, seed=1)[2:])]
    plain = layer(*own)
    assert torch.equal(layer(*own, h_src=None), plain)
    assert torch.equal(layer(*own, h_src=own[0]), plain)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_contconv_gather_sources_match_jax(impl):
    rng = np.random.default_rng(3)
    pos_src = rng.uniform(-1, 1, size=(1, 40, 3)).astype(np.float32)
    feat_src = rng.normal(size=(1, 40, 5)).astype(np.float32)
    pos, feat = pos_src[:, 8:24], feat_src[:, 8:24]
    idx = rng.integers(0, 40, size=(1, 16, 6)).astype(np.int32)
    valid = rng.uniform(size=(1, 16, 6)) > 0.2
    jgeom = jconv_geometry(pos, idx, valid, 1.2, pos_src=pos_src)
    jl = JConv(in_channels=5, out_channels=4, filter_resolution=4, radius=1.2)
    params = jl.init(jax.random.PRNGKey(2), pos, feat, idx, valid, geom=jgeom,
                     feat_src=feat_src)
    want = np.asarray(jl.apply(params, pos, feat, idx, valid, geom=jgeom, feat_src=feat_src))
    t = {k: torch.from_numpy(a) for k, a in dict(pos=pos, feat=feat, idx=idx, valid=valid,
                                                 pos_src=pos_src, feat_src=feat_src).items()}
    geom = conv_geometry(t["pos"], t["idx"], t["valid"], 1.2, pos_src=t["pos_src"])
    for key in ("mapped", "window"):
        np.testing.assert_allclose(geom[key].numpy(), np.asarray(jgeom[key]), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(geom["in_radius"].numpy(), np.asarray(jgeom["in_radius"]))
    layer = ContinuousConv(5, 4, filter_resolution=4, radius=1.2, impl=impl)
    layer.load_state_dict({"filters": torch.from_numpy(np.array(params["params"]["filters"]))})
    got = layer(t["pos"], t["feat"], t["idx"], t["valid"], geom=geom, feat_src=t["feat_src"])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=1e-5)
    # no gather source, or the receivers themselves: the bits of the plain call
    own = (t["pos_src"], t["feat_src"],
           torch.from_numpy(rng.integers(0, 40, size=(1, 40, 6)).astype(np.int32)),
           torch.from_numpy(rng.uniform(size=(1, 40, 6)) > 0.2))
    plain = layer(*own)
    assert torch.equal(layer(*own, feat_src=None), plain)
    assert torch.equal(layer(*own, geom=conv_geometry(*own[:1], *own[2:], 1.2,
                                                      pos_src=own[0]),
                             feat_src=own[1]), plain)
