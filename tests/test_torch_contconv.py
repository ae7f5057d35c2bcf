"""The port's ContConv slice against the JAX package on the same numpy inputs
and converted weights: trilinear corners, the B3 collect twin, the
``ContinuousConv`` layer (dense and kernel impls), ``MaskedBatchNorm``, the
full-width ``ContinuousConvModel`` and a short rollout; then the backward of
the collect (the plain twin of B4-B6 against ``jax.vjp`` of the Pallas
kernel and against torch autograd), the kernel layer's parameter and
position gradients, and which backward kernels a gradient asks for.

Bars and their sources: the collect and the layer at rtol 2e-4, atol 1e-5,
the JAX package's own bar for its fused kernel against its XLA layer
(``tests/test_models.py:161``); its gradients at rtol 2e-4 with atol 1e-5,
or 1e-5 * max|ref| for geometry (``tests/test_models.py:387-391,429-430``);
batch norm at rtol 1e-5 (float32 reductions
in another order); the model at rtol 2e-4, atol 1e-5 * max|a| (two
collect-then-matmul layers at the same bar); rollout positions rtol 1e-5 as
in ``tests/test_torch_slice.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import ContinuousConvModel as JModel
from nbody_tpu.models.contconv import ContinuousConv as JConv
from nbody_tpu.models.contconv import ball_to_cube as jball_to_cube
from nbody_tpu.models.mlp import MaskedBatchNorm as JBatchNorm
from nbody_tpu.ops import interpolate as jinterp
from nbody_tpu.ops.contconv_kernel import contconv_collect as jcollect
from nbody_tpu.ops.radius import batched_radius_neighbors as jradius
from nbody_tpu.train import autoregressive_rollout as jrollout
from nbody_tpu_torch.models import (ContinuousConv, ContinuousConvModel, MaskedBatchNorm,
                                    contconv_model_state_dict)
from nbody_tpu_torch.models.contconv import ball_to_cube
from nbody_tpu_torch.ops import contconv_kernel as cck
from nbody_tpu_torch.ops import interpolate as tinterp
from nbody_tpu_torch.train import autoregressive_rollout
from nbody_tpu_torch.train.graphs import build_graph
from nbody_tpu_torch.utils import prng

FULL = dict(in_channels=4, out_channels=3, filter_resolution=(6, 4), radius=1.0,
            agg="mean", self_loops=True, continuous_conv_layers=2,
            continuous_conv_dim=128, encoder_hiddens=(32, 64),
            decoder_hiddens=(64, 32), scale_factor=1e6)


def test_trilinear_corners_and_interpolate_match_jax():
    rng = np.random.default_rng(0)
    coords = rng.uniform(-0.5, 5.5, (300, 3)).astype(np.float32)
    coords[:5] = [[0, 0, 0], [5, 5, 5], [4, 4, 4], [2.5, 0, 5], [1, 2, 3]]
    for d in (1, 2, 4, 6):
        w_idx, w_w = jinterp.trilinear_corners(jnp.asarray(coords), d)
        t_idx, t_w = tinterp.trilinear_corners(torch.from_numpy(coords), d)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(w_idx))
        np.testing.assert_array_equal(t_w.numpy(), np.asarray(w_w))
    filters = rng.normal(size=(4, 4, 4, 3, 5)).astype(np.float32)
    c = np.clip(coords, 0, 3)
    want = jinterp.trilinear_interpolate(jnp.asarray(filters), jnp.asarray(c))
    got = tinterp.trilinear_interpolate(torch.from_numpy(filters), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ball_to_cube_matches_jax():
    r = np.random.default_rng(1).normal(size=(50, 6, 3)).astype(np.float32)
    r[0, 0] = 0.0  # a self edge
    np.testing.assert_allclose(ball_to_cube(torch.from_numpy(r)).numpy(),
                               np.asarray(jball_to_cube(jnp.asarray(r))), rtol=1e-6, atol=1e-7)


def _collect_inputs(m, k, ci, co, d, seed):
    rng = np.random.default_rng(seed)
    g = [rng.uniform(-0.3, d - 0.7, (m, k)).astype(np.float32) for _ in range(3)]
    window = (rng.uniform(size=(m, k)) * (rng.uniform(size=(m, k)) > 0.2)).astype(np.float32)
    feat = rng.normal(size=(m, k, ci)).astype(np.float32)
    filters = rng.normal(size=(d ** 3, ci, co)).astype(np.float32)
    return [*g, window, feat, filters]


@pytest.mark.parametrize("m,k,d,ci,co", [(70, 6, 4, 3, 5), (70, 6, 6, 8, 7),
                                         (70, 6, 3, 16, 16), (20, 32, 6, 128, 128)])
def test_collect_twin_matches_jax_kernel(m, k, d, ci, co):
    args = _collect_inputs(m, k, ci, co, d, m + d + ci)
    want = np.asarray(jcollect(*map(jnp.asarray, args), d=d, interpret=True))
    got = cck.contconv_collect(*map(torch.from_numpy, args), d=d)  # CPU: the twin
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def _layer_inputs(ci, seed=11):
    b, n, k, radius = 2, 70, 6, 1.2
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    feat = rng.normal(size=(b, n, ci)).astype(np.float32)
    idx, valid = jradius(jnp.asarray(pos), radius, k_max=k, include_self=True)
    return pos, feat, np.asarray(idx), np.asarray(valid), radius


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("d,ci,co", [(4, 3, 5), (6, 8, 7), (3, 16, 16)])
def test_contconv_layer_matches_jax(impl, agg, d, ci, co):
    pos, feat, idx, valid, radius = _layer_inputs(ci)
    jl = JConv(in_channels=ci, out_channels=co, filter_resolution=d, radius=radius, agg=agg)
    params = jl.init(jax.random.PRNGKey(7), pos, feat, idx, valid)
    want = np.asarray(jl.apply(params, pos, feat, idx, valid))
    layer = ContinuousConv(ci, co, filter_resolution=d, radius=radius, agg=agg, impl=impl)
    layer.load_state_dict({"filters": torch.from_numpy(np.array(params["params"]["filters"]))})
    t_idx, t_valid = build_graph(("radius", {"radius": radius, "k_max": 6}),
                                 torch.from_numpy(pos))
    np.testing.assert_array_equal(t_valid.numpy(), valid)
    got = layer(*map(torch.from_numpy, (pos, feat)), t_idx, t_valid)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("d", [1, 4])
def test_kernel_layer_never_takes_the_twin_off_cpu(d, monkeypatch):
    """A kernel layer hands every tensor that is not on the CPU to the B3
    launch, at any filter resolution; the launch, not the layer, refuses
    the shapes it does not take. Here the tensors pose as card tensors."""
    launched = []

    def fake_launch(gx, gy, gz, window, feat_j, filters, d_):
        launched.append(d_)
        return torch.zeros(window.shape[0], filters.shape[-1])

    def no_twin(*args, **kwargs):
        raise AssertionError("the kernel layer ran the plain-torch twin")

    monkeypatch.setattr(cck.build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(cck._Collect, "apply", fake_launch)
    monkeypatch.setattr(cck, "contconv_collect_torch", no_twin)
    monkeypatch.setattr("nbody_tpu_torch.models.contconv.contconv_collect_torch", no_twin)
    pos, feat, idx, valid, radius = _layer_inputs(3)
    layer = ContinuousConv(3, 5, filter_resolution=d, radius=radius, impl="kernel")
    out = layer(*(torch.from_numpy(np.array(a)) for a in (pos, feat, idx, valid)))
    assert launched == [d] and out.shape == (2, 70, 5)


@pytest.mark.parametrize("impl,cuda,want", [
    (None, False, "dense"), (None, True, "kernel"), ("dense", True, "dense"),
    ("kernel", False, "kernel")])
def test_unset_impl_takes_the_kernel_for_card_tensors(impl, cuda, want, monkeypatch):
    """``impl=None`` runs B3 when the layer's tensors lie on a CUDA device
    and the plain layer otherwise; an impl that is set holds on any device.
    Here the CPU tensors pose as card tensors where ``cuda`` says so."""
    ran = []

    def fake_launch(gx, gy, gz, window, feat_j, filters, d_):
        ran.append("kernel")
        return torch.zeros(window.shape[0], filters.shape[-1])

    def fake_dense(gx, gy, gz, window, feat_j, filters, *, d):
        ran.append("dense")
        return torch.zeros(window.shape[0], filters.shape[-1])

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: cuda))
    monkeypatch.setattr(cck.build, "on_cpu", lambda *ts: not cuda)
    monkeypatch.setattr(cck._Collect, "apply", fake_launch)
    monkeypatch.setattr("nbody_tpu_torch.models.contconv.contconv_collect_torch", fake_dense)
    pos, feat, idx, valid, radius = _layer_inputs(3)
    layer = ContinuousConv(3, 5, filter_resolution=4, radius=radius, impl=impl)
    layer(*(torch.from_numpy(np.array(a)) for a in (pos, feat, idx, valid)))
    assert ran == [want]


def test_masked_batch_norm_train_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, size=(2, 40, 8)).astype(np.float32)
    mask = np.ones((2, 40), bool)
    mask[1, 30:] = False
    x[1, 30:] = 1e3  # padding must not move the statistics
    jbn = JBatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = rng.normal(size=8).astype(np.float32)
    bias = rng.normal(size=8).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    want, upd = jbn.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask), train=True,
                          mutable=["batch_stats"])
    bn = MaskedBatchNorm(8).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    got = bn(torch.from_numpy(x), mask=torch.from_numpy(mask))
    valid = mask[..., None].repeat(8, -1)
    np.testing.assert_allclose(got.detach().numpy()[valid], np.asarray(want)[valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-5)
    bn.eval()
    j_eval = jbn.apply({"params": variables["params"], **upd}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), np.asarray(j_eval),
                               rtol=1e-5, atol=1e-5)


def _converted(cfg, x, idx, valid, seed=0):
    """A flax model with every leaf perturbed (non-trivial batch norm and
    head) and its port twin with the converted weights, in eval mode."""
    jmodel = JModel(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(seed), x, idx, valid)
    _, upd = jmodel.apply(variables, x, idx, valid, train=True, mutable=["batch_stats"])
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        variables["params"])
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])}
    t_cfg = {k: v for k, v in cfg.items() if k not in ("radius_impl", "conv_impl")}
    model = ContinuousConvModel(**t_cfg).eval()
    model.load_state_dict(contconv_model_state_dict(variables))
    return jmodel, variables, model


@pytest.mark.parametrize("conv_impl", ["dense", "kernel"])
def test_full_width_model_matches_flax(conv_impl):
    rng = np.random.default_rng(5)
    n = 160
    x = np.concatenate([rng.uniform(-1.5, 1.5, (1, n, 3)), rng.normal(size=(1, n, 3)),
                        rng.uniform(0.5, 1.5, (1, n, 1))], -1).astype(np.float32)
    idx, valid = jradius(jnp.asarray(x[..., :3]), 1.0, k_max=32, include_self=True)
    jmodel, variables, model = _converted(FULL, jnp.asarray(x), idx, valid)
    model.convs[0].impl = model.convs[1].impl = conv_impl
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), idx, valid))
    t_idx, t_valid = build_graph(model.graph_spec, torch.from_numpy(x[..., :3]))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(valid))
    with torch.no_grad():
        got = model(torch.from_numpy(x), t_idx, t_valid).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * np.abs(want).max())
    assert model.graph_spec == jmodel.graph_spec
    assert model.get_config() == jmodel.get_config()


def test_contconv_rollout_matches_jax():
    from nbody_tpu.ics import generate_spiral as jgenerate_spiral

    cfg = dict(FULL, continuous_conv_dim=16, encoder_hiddens=(8, 12),
               decoder_hiddens=(12,), output_scale=1e6)
    n, steps, dt = 300, 5, 1e-4
    pos, vel, mass = (np.array(a) for a in jgenerate_spiral(jax.random.PRNGKey(2), n))
    x = np.concatenate([pos, vel, mass[:, None]], -1)[None]
    idx, valid = jradius(jnp.asarray(pos[None]), 1.0, k_max=32, include_self=True)
    jmodel, variables, model = _converted(cfg, jnp.asarray(x), idx, valid, seed=3)
    want = jrollout(jmodel, variables, jnp.asarray(pos), jnp.asarray(vel),
                    jnp.asarray(mass), steps, dt, graph_refresh=2)
    got = autoregressive_rollout(model, *map(torch.from_numpy, (pos, vel, mass)), steps, dt,
                                 graph_refresh=2)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def _close_grads(got, want, geometry):
    """The JAX package's bars for the kernel's VJP (tests/test_models.py
    387-391, 429-430): rtol 2e-4 with atol 1e-5, or 1e-5 * max|want| for a
    geometry cotangent."""
    want = np.asarray(want)
    atol = 1e-5 * float(np.abs(want).max()) if geometry else 1e-5
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=atol)


@pytest.mark.parametrize("m,k,d,ci,co", [(70, 6, 3, 5, 4), (70, 6, 4, 3, 5),
                                         (40, 8, 6, 8, 7),
                                         # one past each cap the card kernels had:
                                         # k > 64, co > 128, D > 10, ci > 128
                                         (20, 72, 3, 3, 4), (20, 6, 3, 4, 136),
                                         (20, 6, 11, 3, 4), (20, 6, 3, 136, 4)])
def test_plain_backward_matches_jax_vjp(m, k, d, ci, co):
    """All six cotangents of the plain backward against ``jax.vjp`` of the
    Pallas kernel (interpret mode) on coordinates off the integer grid,
    some of them clamped; also at one shape past each cap that the card
    kernels once had (k = 72, co = 136, D = 11, ci = 136 with the geometry
    cotangents), the other dimensions small."""
    args = _collect_inputs(m, k, ci, co, d, 3 * m + d)
    dout = np.random.default_rng(d).normal(size=(m, co)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jcollect(*a, d=d, interpret=True), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dout))
    got = cck.contconv_collect_bwd_torch(*map(torch.from_numpy, (*args, dout)), d=d)
    for i, (g, w) in enumerate(zip(got, want)):
        _close_grads(g.numpy(), w, geometry=i < 4)


@pytest.mark.parametrize("d", [3, 4, 6])
def test_plain_backward_matches_torch_autograd(d):
    """The plain backward against autograd of the plain forward; both agree
    wherever the trilinear weights are differentiable (random coordinates
    are never on the grid)."""
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in _collect_inputs(50, 7, 6, 5, d, 40 + d)]
    dout = torch.from_numpy(np.random.default_rng(d).normal(size=(50, 5)).astype(np.float32))
    cck.contconv_collect_torch(*args, d=d).backward(dout)
    got = cck.contconv_collect_bwd_torch(*(a.detach() for a in args), dout, d=d)
    for i, (g, a) in enumerate(zip(got, args)):
        _close_grads(g.numpy(), a.grad.numpy(), geometry=i < 4)


def test_plain_backward_need_returns_only_what_is_asked():
    args = [torch.from_numpy(a) for a in _collect_inputs(30, 5, 4, 3, 4, 9)]
    dout = torch.ones(30, 3)
    full = cck.contconv_collect_bwd_torch(*args, dout, d=4)
    for need in [(False,) * 5 + (True,), (False,) * 4 + (True, False),
                 (False, False, True, False, False, False)]:
        got = cck.contconv_collect_bwd_torch(*args, dout, d=4, need=need)
        for i, (g, f) in enumerate(zip(got, full)):
            if need[i]:
                assert torch.equal(g, f)
            elif i >= 4 or not any(need[:4]):
                assert g is None


def _layer_grads_jax(d, ci, co, agg, seed):
    """Parameter (filters, feat) and position gradients of the JAX layer
    with the Pallas kernel (interpret mode) for a fixed cotangent."""
    pos, feat, idx, valid, radius = _layer_inputs(ci, seed)
    cot = np.random.default_rng(seed + 1).normal(size=(*pos.shape[:2], co)).astype(np.float32)
    kw = dict(in_channels=ci, out_channels=co, filter_resolution=d, radius=radius, agg=agg)
    fused = JConv(**kw, impl="pallas_interpret")
    params = JConv(**kw).init(jax.random.PRNGKey(seed), pos, feat, idx, valid)

    def loss(p, q, f):
        return jnp.sum(fused.apply(p, q, f, idx, valid) * cot)

    g_p, g_q, g_f = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(pos),
                                                      jnp.asarray(feat))
    return (pos, feat, radius, cot, np.array(params["params"]["filters"]),
            (np.asarray(g_p["params"]["filters"]), np.asarray(g_q), np.asarray(g_f)))


@pytest.mark.parametrize("d,ci,co,agg", [(4, 3, 5, "mean"), (6, 8, 7, "sum"),
                                         (3, 5, 4, "sum")])
def test_kernel_layer_grads_match_jax(d, ci, co, agg):
    """The ``impl="kernel"`` layer's filter, feature and position gradients
    (neighbour lists held fixed, self loops on) against the JAX layer on
    its Pallas kernel with the same filters."""
    pos, feat, radius, cot, filters, want = _layer_grads_jax(d, ci, co, agg, 20 + d)
    layer = ContinuousConv(ci, co, filter_resolution=d, radius=radius, agg=agg, impl="kernel")
    layer.load_state_dict({"filters": torch.from_numpy(filters)})
    t_idx, t_valid = build_graph(("radius", {"radius": radius, "k_max": 6}),
                                 torch.from_numpy(pos))
    q = torch.from_numpy(pos).requires_grad_(True)
    f = torch.from_numpy(feat).requires_grad_(True)
    (layer(q, f, t_idx, t_valid) * torch.from_numpy(cot)).sum().backward()
    assert np.isfinite(q.grad.numpy()).all()
    _close_grads(layer.filters.grad.numpy(), want[0], geometry=False)
    _close_grads(q.grad.numpy(), want[1], geometry=True)
    _close_grads(f.grad.numpy(), want[2], geometry=False)


def test_backward_launches_geometry_only_for_position_grads(monkeypatch):
    """``_Collect.backward`` asks B4 for the filters, B5 for the features and
    B6 only when a geometry input needs a gradient; parameter-only training
    never reaches B6. On the CPU each wrapper runs its plain part and its
    launch counter stays at 0."""
    calls = []
    wrappers = [cck.contconv_collect, cck.contconv_bwd_filters, cck.contconv_bwd_feat,
                cck.contconv_bwd_geom]
    before = [w.launches for w in wrappers]
    for real in wrappers[1:]:
        def spy(*a, _real=real, **kw):
            calls.append(_real.__name__)
            return _real(*a, **kw)

        monkeypatch.setattr(cck, real.__name__, spy)
    pos, feat, _, _, radius = _layer_inputs(3)
    layer = ContinuousConv(3, 5, filter_resolution=4, radius=radius, impl="kernel")
    t_idx, t_valid = build_graph(("radius", {"radius": radius, "k_max": 6}),
                                 torch.from_numpy(pos))
    f = torch.from_numpy(feat).requires_grad_(True)
    layer(torch.from_numpy(pos), f, t_idx, t_valid).sum().backward()
    assert sorted(calls) == ["contconv_bwd_feat", "contconv_bwd_filters"]
    calls.clear()
    layer.filters.requires_grad_(False)
    q = torch.from_numpy(pos).requires_grad_(True)
    layer(q, torch.from_numpy(feat), t_idx, t_valid).sum().backward()
    assert calls == ["contconv_bwd_geom"]
    assert [w.launches for w in wrappers] == before


def _chunk_grads(layer, pos, feat, cot, t_idx, t_valid):
    layer.zero_grad(set_to_none=True)
    q = torch.from_numpy(pos).requires_grad_(True)
    f = torch.from_numpy(feat).requires_grad_(True)
    out = layer(q, f, t_idx, t_valid)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), layer.filters.grad.numpy(), q.grad.numpy(), f.grad.numpy()


@pytest.mark.parametrize("chunks", [2, 3, 4, 100])
def test_node_chunked_layer_equals_unchunked(chunks, monkeypatch):
    """``node_chunks`` changes where the collect is cut and nothing else:
    output and the filter, feature and position gradients equal the
    unchunked kernel layer's (the same per-receiver sums; the filter
    gradient adds its chunks in another order). 70 receivers in 3 or 4
    chunks split unevenly (24 + 24 + 22, 18 + 18 + 18 + 16); 100 chunks
    leave one receiver each. Every chunk goes through the collect once in
    the forward and, rematerialised, once more in the backward."""
    pos, feat, _, _, radius = _layer_inputs(5, seed=31)
    cot = np.random.default_rng(32).normal(size=(2, 70, 4)).astype(np.float32)
    t_idx, t_valid = build_graph(("radius", {"radius": radius, "k_max": 6}),
                                 torch.from_numpy(pos))
    kw = dict(filter_resolution=4, radius=radius, agg="mean", impl="kernel")
    plain = ContinuousConv(5, 4, **kw, key=prng.PRNGKey(3))
    chunked = ContinuousConv(5, 4, **kw, node_chunks=chunks)
    chunked.load_state_dict(plain.state_dict())
    want = _chunk_grads(plain, pos, feat, cot, t_idx, t_valid)
    sizes = []
    real = cck._Collect.apply
    monkeypatch.setattr(cck._Collect, "apply",
                        lambda *a: (sizes.append(a[3].shape[0]), real(*a))[1])
    got = _chunk_grads(chunked, pos, feat, cot, t_idx, t_valid)
    step = -(-70 // chunks)
    per_pass = [2 * min(step, 70 - lo) for lo in range(0, 70, step)]
    assert sizes[:len(per_pass)] == per_pass and sorted(sizes) == sorted(per_pass * 2)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
    with torch.no_grad():  # inference: nothing to rematerialise
        out = chunked(torch.from_numpy(pos), torch.from_numpy(feat), t_idx, t_valid)
    np.testing.assert_array_equal(out.numpy(), want[0])


@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_node_chunked_layer_matches_jax(agg):
    """Forward and the filter, feature and position gradients against the
    JAX layer with ``node_chunks=2`` on its Pallas kernel in interpret mode
    (``tests/test_models.py:164-190``: rtol 2e-4)."""
    d, ci, co = 4, 3, 5
    pos, feat, idx, valid, radius = _layer_inputs(ci, seed=41)
    cot = np.random.default_rng(42).normal(size=(2, 70, co)).astype(np.float32)
    kw = dict(in_channels=ci, out_channels=co, filter_resolution=d, radius=radius, agg=agg)
    jl = JConv(**kw, impl="pallas_interpret", node_chunks=2)
    params = JConv(**kw).init(jax.random.PRNGKey(5), pos, feat, idx, valid)
    want_out = np.asarray(jl.apply(params, pos, feat, idx, valid))
    g_p, g_q, g_f = jax.grad(
        lambda p, q, f: jnp.sum(jl.apply(p, q, f, idx, valid) * cot), argnums=(0, 1, 2))(
            params, jnp.asarray(pos), jnp.asarray(feat))
    layer = ContinuousConv(ci, co, filter_resolution=d, radius=radius, agg=agg,
                           impl="kernel", node_chunks=2)
    layer.load_state_dict({"filters": torch.from_numpy(np.array(params["params"]["filters"]))})
    t_idx, t_valid = build_graph(("radius", {"radius": radius, "k_max": 6}),
                                 torch.from_numpy(pos))
    out, g_filters, g_pos, g_feat = _chunk_grads(layer, pos, feat, cot, t_idx, t_valid)
    np.testing.assert_allclose(out, want_out, rtol=2e-4, atol=1e-5)
    _close_grads(g_filters, np.asarray(g_p["params"]["filters"]), geometry=False)
    _close_grads(g_pos, np.asarray(g_q), geometry=True)
    _close_grads(g_feat, np.asarray(g_f), geometry=False)


def test_node_chunked_model_trains_like_unchunked():
    """``conv_node_chunks`` reaches every layer of the model, leaves the
    ``state_dict`` keys alone, and with ``conv_impl`` unset takes the kernel
    path on the CPU too (its plain twin): same loss and gradients."""
    kw = dict(in_channels=4, filter_resolution=(3, 2), radius=1.2, continuous_conv_layers=2,
              continuous_conv_dim=8, encoder_hiddens=(6,), decoder_hiddens=(6,))
    plain = ContinuousConvModel(**kw, conv_impl="kernel", key=prng.PRNGKey(8))
    chunked = ContinuousConvModel(**kw, conv_node_chunks=3)
    assert [c.node_chunks for c in chunked.convs] == [3, 3]
    assert list(chunked.state_dict()) == list(plain.state_dict())
    chunked.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 40, 7)).astype(np.float32))
    idx, valid = build_graph(plain.graph_spec, x[..., :3])
    grads = []
    for m in (plain, chunked):
        m.train()
        m(x, idx, valid).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name, ref in grads[0].items():
        if name == "encoder.layers.0.bias":
            continue  # feeds a batch norm in train mode: zero up to rounding noise
        torch.testing.assert_close(grads[1][name], ref, rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()) + 1e-12)


def test_unported_contconv_options_raise():
    """``node_chunks`` belongs to the kernel path: the dense layer refuses
    it by name instead of ignoring it; unknown impls raise."""
    with pytest.raises(ValueError, match="kernel"):
        ContinuousConvModel(conv_node_chunks=2, conv_impl="dense")
    with pytest.raises(ValueError, match="kernel"):
        ContinuousConv(4, 4, impl="dense", node_chunks=2)
    with pytest.raises(ValueError):
        ContinuousConv(4, 4, impl="pallas")


# ---- the (receiver, cell) pair plan of B3 and B4 -----------------------------

def _plan_inputs(m, k, ci, co, d, seed):
    """Collect inputs with every odd case of the plan's rule: coordinates
    clamped on both sides, on the integer grid (interior, 0 and d - 1),
    zero windows, a receiver with no live edge."""
    args = _collect_inputs(m, k, ci, co, d, seed)
    rng = np.random.default_rng(seed + 1)
    for g in args[:3]:
        g[rng.uniform(size=g.shape) < 0.15] = float(rng.integers(0, d))
        g[rng.uniform(size=g.shape) < 0.05] = d - 1.0
        g[rng.uniform(size=g.shape) < 0.05] = 0.0
    args[3][m // 2] = 0.0
    return args


def _pairs_by_hand(gx, gy, gz, window, d, all_edges=False):
    """The (receiver, cell) pairs straight from the rule, edge by edge
    (``all_edges``: the edges of zero window too, B6's plan)."""
    pairs = set()
    for m, e in zip(*np.nonzero(np.ones_like(window) if all_edges else window)):
        c = np.clip(np.array([gx[m, e], gy[m, e], gz[m, e]], np.float32), 0, d - 1)
        lo = np.minimum(np.floor(c), d - 2)
        f = c - lo
        for o in range(8):
            off = np.array([o >> 2, (o >> 1) & 1, o & 1])
            if np.all(np.where(off == 1, f, np.float32(1) - f) != 0):
                x, y, z = (lo + off).astype(int)
                pairs.add((int(m), (x * d + y) * d + z))
    return pairs


@pytest.mark.parametrize("all_edges", [False, True])
@pytest.mark.parametrize("m,k,d", [(37, 5, 2), (41, 7, 3), (33, 6, 4), (1, 3, 3),
                                   (20, 32, 6), (9, 72, 3), (11, 5, 11)])
def test_pair_plan_lists_every_pair_once_cell_major(m, k, d, all_edges):
    """The plan's pairs, in both orders, against the rule edge by edge;
    with ``all_edges`` (B6's plan) the edges of zero window count too."""
    gx, gy, gz, window = _plan_inputs(m, k, 2, 2, d, 7 * m + d)[:4]
    plan = cck.pair_plan(*map(torch.from_numpy, (gx, gy, gz, window)), d=d,
                         all_edges=all_edges)  # CPU: plain
    want = _pairs_by_hand(gx, gy, gz, window, d, all_edges)
    if all_edges:  # the zero windows add pairs
        assert len(want) > len(_pairs_by_hand(gx, gy, gz, window, d))
    rstart, cell_r, slot_of, recv_of, coff = (t.numpy().astype(np.int64) for t in plan)
    p = len(want)
    assert cell_r.shape == slot_of.shape == recv_of.shape == (p,)
    # receiver-major: a receiver's rows, cells ascending
    recv_r = np.repeat(np.arange(m), np.diff(rstart))
    assert rstart[0] == 0 and rstart[-1] == p and len(rstart) == m + 1
    assert set(zip(recv_r.tolist(), cell_r.tolist())) == want  # p distinct pairs
    assert np.all(np.diff(recv_r * d ** 3 + cell_r) > 0)
    # cell-major: a cell's rows contiguous, receivers ascending inside
    cell_c = np.repeat(np.arange(d ** 3), np.diff(coff))
    assert coff[0] == 0 and coff[-1] == p and len(coff) == d ** 3 + 1
    assert np.all(np.diff(cell_c * m + recv_of) > 0)
    # slot_of carries each receiver-major row to its cell-major row
    assert sorted(slot_of.tolist()) == list(range(p))
    np.testing.assert_array_equal(recv_of[slot_of], recv_r)
    np.testing.assert_array_equal(cell_c[slot_of], cell_r)


def test_pair_plan_of_dead_geometry_is_empty():
    gx, gy, gz, window, feat, filters = map(torch.from_numpy, _plan_inputs(9, 4, 3, 5, 3, 1))
    window = torch.zeros_like(window)
    plan = cck.pair_plan(gx, gy, gz, window, d=3)
    assert plan.cell_r.numel() == 0 and int(plan.rstart[-1]) == 0 and int(plan.coff[-1]) == 0
    g = cck.pair_bins_torch(plan, gx, gy, gz, window, feat, d=3)
    assert g.shape == (0, 3)
    assert not cck.pair_collect_torch(plan, g, filters, 9).any()
    assert not cck.pair_filter_grad_torch(plan, g, torch.ones(9, 5), 27).any()
    dg = cck.pair_dg_torch(plan, torch.ones(9, 5), filters)
    assert dg.shape == (0, 3)
    assert not cck.pair_unbins_torch(plan, dg, gx, gy, gz, window, d=3).any()
    with pytest.raises(ValueError):
        cck.pair_plan(gx, gy, gz, window, d=1)


@pytest.mark.parametrize("m,k,d,ci,co", [(37, 5, 2, 3, 5), (41, 7, 3, 6, 4), (33, 6, 4, 3, 5),
                                         (20, 32, 6, 128, 128)])
def test_bins_then_product_over_the_plan_match_collect(m, k, d, ci, co):
    """B3's route on the card (plan, bins, a product a cell, the receivers'
    sums) in its plain version, against the plain collect and against the
    Pallas kernel in interpret mode at the bar of
    ``test_collect_twin_matches_jax_kernel``."""
    args = _plan_inputs(m, k, ci, co, d, m + d + ci)
    t = [torch.from_numpy(a) for a in args]
    plan = cck.pair_plan(*t[:4], d=d)
    g = cck.pair_bins_torch(plan, *t[:5], d=d)
    got = cck.pair_collect_torch(plan, g, t[5], m).numpy()
    np.testing.assert_allclose(got, cck.contconv_collect_torch(*t, d=d).numpy(),
                               rtol=2e-4, atol=1e-5)
    want = np.asarray(jcollect(*map(jnp.asarray, args), d=d, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("m,k,d,ci,co", [(70, 6, 3, 5, 4), (37, 5, 2, 3, 5), (40, 8, 6, 8, 7)])
def test_filter_grad_over_the_plan_matches_jax_vjp(m, k, d, ci, co):
    """B4's route on the card (plan, bins, the transposed product a cell) in
    its plain version against ``jax.vjp`` of the Pallas kernel (interpret
    mode) and the plain backward, at the bar of
    ``test_plain_backward_matches_jax_vjp``."""
    args = _plan_inputs(m, k, ci, co, d, 3 * m + d)
    dout = np.random.default_rng(d).normal(size=(m, co)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (*args, dout)]
    plan = cck.pair_plan(*t[:4], d=d)
    got = cck.pair_filter_grad_torch(plan, cck.pair_bins_torch(plan, *t[:5], d=d), t[6],
                                     d ** 3)
    _, vjp = jax.vjp(lambda *a: jcollect(*a, d=d, interpret=True), *map(jnp.asarray, args))
    _close_grads(got.numpy(), vjp(jnp.asarray(dout))[5], geometry=False)
    _close_grads(got.numpy(), cck.contconv_bwd_filters(*t, d=d).numpy(), geometry=False)


@pytest.mark.parametrize("m,k,d,ci,co", [(37, 5, 2, 3, 5), (41, 7, 3, 6, 4), (33, 6, 4, 3, 5),
                                         (20, 32, 6, 130, 12)])
def test_feature_grad_over_the_plan_matches_jax_vjp(m, k, d, ci, co):
    """B5's route on the card (plan, dG over the cell-major rows, the unbin
    pass) in its plain version against ``jax.vjp`` of the Pallas kernel
    (interpret mode) and the plain backward, on the plan's odd shapes (ci %
    4 != 0, zero windows, clamped and on-grid coordinates, M < 64, ci above
    128), at the bar of ``test_plain_backward_matches_jax_vjp``."""
    args = _plan_inputs(m, k, ci, co, d, 3 * m + d)
    dout = np.random.default_rng(d).normal(size=(m, co)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (*args, dout)]
    plan = cck.pair_plan(*t[:4], d=d)
    dg = cck.pair_dg_torch(plan, t[6], t[5])
    got = cck.pair_unbins_torch(plan, dg, *t[:4], d=d)
    _, vjp = jax.vjp(lambda *a: jcollect(*a, d=d, interpret=True), *map(jnp.asarray, args))
    _close_grads(got.numpy(), vjp(jnp.asarray(dout))[4], geometry=False)
    _close_grads(got.numpy(), cck.contconv_bwd_feat(*t, d=d).numpy(), geometry=False)
    assert not got[m // 2].any()  # a receiver without a live edge


def test_geometry_plan_of_dead_geometry_keeps_every_edge():
    """B6's plan keeps the edges of zero window: on a geometry whose windows
    are all zero it equals the plan of the same geometry with every window
    live, and the window's cotangent over it is not zero (the positions'
    ones are: each carries a window factor)."""
    gx, gy, gz, window, feat, filters = map(torch.from_numpy, _plan_inputs(9, 4, 3, 5, 3, 1))
    dead = torch.zeros_like(window)
    plan = cck.pair_plan(gx, gy, gz, dead, d=3, all_edges=True)
    for a, b in zip(plan, cck.pair_plan(gx, gy, gz, torch.ones_like(window), d=3)):
        assert torch.equal(a, b)
    dout = torch.from_numpy(np.random.default_rng(2).normal(size=(9, 5)).astype(np.float32))
    dgx, dgy, dgz, dwin = cck.pair_geom_torch(plan, cck.pair_dg_torch(plan, dout, filters),
                                              gx, gy, gz, dead, feat, d=3)
    assert dwin.abs().min() > 0 and not (dgx.any() or dgy.any() or dgz.any())
    want = cck.contconv_collect_bwd_torch(gx, gy, gz, dead, feat, filters, dout, d=3)
    _close_grads(dwin.numpy(), want[3].numpy(), geometry=True)


@pytest.mark.parametrize("m,k,d,ci,co", [(37, 5, 2, 3, 5), (41, 7, 3, 6, 4), (33, 6, 4, 3, 5),
                                         (20, 72, 4, 3, 5), (30, 6, 11, 3, 4),
                                         (20, 6, 3, 136, 4)])
def test_geometry_grad_over_the_plan_matches_jax_vjp(m, k, d, ci, co):
    """B6's route on the card (a plan that keeps the edges of zero window,
    dG over its cell-major rows, the geometry pass) in its plain version
    against ``jax.vjp`` of the Pallas kernel (interpret mode) and the plain
    backward: zero windows, clamped coordinates and coordinates on the
    integer grid, k past 64, D past 10 and ci past 128, at the bar of
    ``test_plain_backward_matches_jax_vjp`` (1e-5 of max |ref|)."""
    args = _plan_inputs(m, k, ci, co, d, 3 * m + d)
    dout = np.random.default_rng(d).normal(size=(m, co)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (*args, dout)]
    plan = cck.pair_plan(*t[:4], d=d, all_edges=True)
    got = cck.pair_geom_torch(plan, cck.pair_dg_torch(plan, t[6], t[5]), *t[:5], d=d)
    _, vjp = jax.vjp(lambda *a: jcollect(*a, d=d, interpret=True), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dout))[:4]
    plain = cck.contconv_bwd_geom(*t, d=d)  # CPU: the plain backward
    for g, w, p in zip(got, want, plain):
        _close_grads(g.numpy(), w, geometry=True)
        _close_grads(g.numpy(), p.numpy(), geometry=True)
    dead = args[3] == 0
    assert dead.any() and (got[3].numpy()[dead] != 0).any()  # dead edges' dwindow


def _sum8_over_warp(v):
    """B6's ``sum8_over_warp`` on (..., 32 lanes, 8 values) float32 partials:
    halves of the values traded with lanes 16, 8 and 4 away, then two
    butterfly steps; (..., 32), lane l the sum of value l // 4."""
    lane = torch.arange(32)
    lanes = [lane ^ off for off in (16, 8, 4, 2, 1)]

    def step(x, bit, partner):  # keep the half this lane's bit selects
        h = ((lane & bit) != 0)[:, None]
        n = x.shape[-1] // 2
        keep = torch.where(h, x[..., n:], x[..., :n])
        send = torch.where(h, x[..., :n], x[..., n:])
        return keep + send[..., partner, :]

    c = step(step(step(v, 16, lanes[0]), 8, lanes[1]), 4, lanes[2])[..., 0]
    c = c + c[..., lanes[3]]
    return c + c[..., lanes[4]]


def _geom_walk_plain(plan, dg, gx, gy, gz, window, feat_j, d, nrows):
    """A plain version of B6's geometry pass (``bwd_geom_kernel`` in
    csrc/contconv.cu), every receiver at once: passes of ``nrows`` of a
    receiver's rows; per edge and pass, lane l's partial dot of each live
    corner in the pass over channels 4 l .. 4 l + 3 of every 128 (chunk by
    chunk), the 8 partials reduced by ``sum8_over_warp`` (lane l: corner l
    // 4), lane 4 c + j's term of cotangent j (dwindow, dgx, dgy, dgz) for
    corner c, the corners added by the butterfly over lanes 4, 8 and 16
    apart, the pass added to the edge's sums. Returns (dgx, dgy, dgz,
    dwindow)."""
    m, k, ci = feat_j.shape
    z = d ** 3
    cell, _, _, live = cck._edge_corners(gx, gy, gz, d)
    c_ax = torch.stack([gx, gy, gz], -1).clamp(0.0, d - 1)
    f = c_ax - torch.clamp(torch.floor(c_ax), max=d - 2)  # fractions (m, k, 3)
    counts = (plan.rstart[1:] - plan.rstart[:-1]).long()
    recv = torch.arange(m)[:, None, None].expand_as(cell)
    rr = torch.searchsorted(torch.repeat_interleave(torch.arange(m), counts) * z
                            + plan.cell_r.long(), recv * z + cell)
    rr = rr.clamp(max=plan.cell_r.numel() - 1)
    j = torch.where(live, rr - plan.rstart[:-1].long()[:, None, None], -1)  # row in receiver
    nch = -(-ci // 128)
    fp = torch.zeros(m, k, nch * 128)
    fp[..., :ci] = feat_j
    gp = torch.zeros(dg.shape[0], nch * 128)
    gp[:, :ci] = dg[:, :ci]
    prod = (fp[:, :, None, :] * gp[plan.slot_of.long()[rr]]).reshape(m, k, 8, nch, 32, 4)
    part_all = torch.zeros(m, k, 8, 32)
    for c in range(nch):  # a lane's chain: chunk by chunk, its 4 channels each
        for q in range(4):
            part_all = part_all + prod[:, :, :, c, :, q]
    lane = torch.arange(32)
    oc, cj = lane // 4, lane % 4
    bit = [((torch.arange(8) >> (2 - a)) & 1) == 1 for a in range(3)]
    inside = [((f[..., a] > 0) & (f[..., a] < 1)).float()[..., None] for a in range(3)]
    w3 = [torch.where(bit[a], f[..., a, None], 1 - f[..., a, None])[..., oc] for a in range(3)]
    d3 = [torch.where(bit[a], inside[a], -inside[a])[..., oc] for a in range(3)]
    res = torch.zeros(4, m, k)
    for b0 in range(0, max(int(counts.max()), 1), nrows):
        here = live & (j >= b0) & (j < b0 + nrows)  # (m, k, 8)
        part = torch.where(here[..., None], part_all, 0.0)
        sc = _sum8_over_warp(part.transpose(2, 3))  # (m, k, 32)
        vs = window[..., None] * sc
        t = torch.stack([w3[0] * w3[1] * w3[2] * sc, d3[0] * w3[1] * w3[2] * vs,
                         w3[0] * d3[1] * w3[2] * vs, w3[0] * w3[1] * d3[2] * vs], -1)
        t = t.gather(-1, cj.expand(m, k, 32)[..., None])[..., 0]
        t = torch.where(here[..., oc], t, 0.0)
        for off in (4, 8, 16):
            t = t + t[..., lane ^ off]
        res = res + t[..., :4].permute(2, 0, 1)
    return res[1], res[2], res[3], res[0]


@pytest.mark.parametrize("m,k,d,ci,nrows", [(41, 7, 3, 6, 64), (33, 6, 4, 3, 2),
                                            (20, 72, 4, 3, 5), (20, 6, 3, 136, 3)])
def test_b6_walk_gives_the_plain_geometry_grad(m, k, d, ci, nrows):
    """The premise of B6's geometry pass on the CPU: its walk (a lane's
    partial dots of the 8 corners reduced together so that lane l holds
    corner l // 4's, the four cotangents' terms a lane each, the corners'
    butterfly, receivers split into passes of ``nrows`` rows) gives
    :func:`pair_geom_torch` within float32 rounding, dead edges, zero-weight
    corners and ci past 128 included; and a corner with a zero axis weight,
    which the pass skips, adds nothing to any cotangent in the plain
    backward's definition."""
    args = _plan_inputs(m, k, ci, 4, d, 5 * m + d)
    dout = np.random.default_rng(m).normal(size=(m, 4)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (*args, dout)]
    plan = cck.pair_plan(*t[:4], d=d, all_edges=True)
    dg = cck.pair_dg_torch(plan, t[6], t[5])
    got = _geom_walk_plain(plan, dg, *t[:5], d, nrows)
    want = cck.pair_geom_torch(plan, dg, *t[:5], d=d)
    for g, w in zip(got, want):
        _close_grads(g.numpy(), w.numpy(), geometry=True)
    _, w, dws, live = cck._edge_corners(*t[:3], d)
    dead = ~live
    assert dead.any() and not (w[dead].any() or any(x[dead].any() for x in dws))


@pytest.mark.parametrize("m,k,d,floor", [(41, 7, 3, 4), (20, 32, 6, 16), (300, 32, 2, 64)])
def test_work_items_cover_each_cell_once(m, k, d, floor, monkeypatch):
    """The grouped products' work items: every cell's rows in pieces of at
    most ``rows`` rows, in order, none for an empty cell; the grid's bound
    holds the true count."""
    monkeypatch.setattr(cck, "_ITEM_ROWS", floor)
    monkeypatch.setattr(cck, "_PRODUCT_ITEMS", 8)
    plan = cck.pair_plan(*map(torch.from_numpy, _plan_inputs(m, k, 2, 2, d, m)[:4]), d=d)
    istart, rows, bound = cck._work_items(plan, d ** 3)
    coff, istart = plan.coff.numpy(), istart.numpy()
    assert rows % floor == 0 and istart[0] == 0 and istart[-1] <= bound
    covered = []
    for item in range(istart[-1]):
        cell = int(np.searchsorted(istart, item, side="right")) - 1
        lo = coff[cell] + (item - istart[cell]) * rows
        hi = min(coff[cell + 1], lo + rows)
        assert lo < hi
        covered.extend(range(lo, hi))
    assert covered == list(range(plan.cell_r.numel()))


def test_plan_rows_follow_the_shape(monkeypatch):
    """The plan is sized by the most pairs its shape can have while bins and
    products of that many rows stay under the byte bound; above it the
    device's count is read (None)."""
    assert cck._plan_rows(500, 32, 6, 128, 128) == 500 * 216
    assert cck._plan_rows(500, 4, 6, 128, 128) == 500 * 32
    assert cck._plan_rows(100_000, 32, 6, 128, 128) is None
    monkeypatch.setattr(cck, "_NO_READ_BYTES", 4 * 10 * 27 * (8 + 4))
    assert cck._plan_rows(10, 7, 3, 5, 3) == 270
    assert cck._plan_rows(11, 7, 3, 5, 3) is None
