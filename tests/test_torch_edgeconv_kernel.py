"""B11 of the port (``nbody_tpu_torch/ops/edgeconv_kernel.py``) against the
JAX package's retired windowed EdgeConv kernel (``attic/edgeconv_kernel.py``,
loaded by path and run in Pallas interpret mode, as its own tests run it):
the plain version of the kernel, the window plan field by field, and
``edge_message_sum`` with its fallback list, on the same numpy inputs.

Bar: rtol = atol = 2e-6, the JAX tests' own (``attic/test_edgeconv_kernel.py:44``);
the bfloat16 gather mode is held to the rounded-``v`` reference at the same
bar. On the CPU the wrapper runs the plain version; the kernel itself is
held to it on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Torch runs on one CPU thread here (``one_thread``): its CPU ``tanh`` could
give one OpenMP thread's chunk of its first parallel call in a process
~5e-5 relative error after other parallel work, which failed a JAX-compared
case under ``-n 4`` now and then; on one thread it did not."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.models.common import select_input_features
from nbody_tpu_torch.ops import edgeconv_kernel as ek
from nbody_tpu_torch.ops.spatial import morton_keys
from nbody_tpu_torch.train.graphs import build_graph

TILE, HALF = 256, 128
TOL = dict(rtol=2e-6, atol=2e-6)
PLAN_FIELDS = ("in_mask", "fb_src", "fb_dst", "fb_valid", "overflow")


def _attic():
    path = Path(__file__).resolve().parents[1] / "attic" / "edgeconv_kernel.py"
    spec = importlib.util.spec_from_file_location("attic_edgeconv_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jk = _attic()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one CPU thread for this module's cases, the old count
    restored after them."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _graph(seed, n=512, k=8, d=64, spread=HALF - 1, far=0.0):
    """u, v, near-diagonal idx (a share ``far`` of it rewired to arbitrary
    rows) and 90% valid slots, as numpy."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, d)).astype(np.float32)
    v = rng.normal(size=(n, d)).astype(np.float32)
    idx = np.clip(np.arange(n)[:, None] + rng.integers(-spread, spread + 1, (n, k)), 0, n - 1)
    idx = np.where(rng.uniform(size=(n, k)) < far, rng.integers(0, n, (n, k)), idx)
    return u, v, idx.astype(np.int32), rng.uniform(size=(n, k)) < 0.9


def _ref(u, v, idx, valid, round_v=False):
    """The gather reference in float64 accumulation order-free form."""
    g = v[idx]
    if round_v:
        g = torch.from_numpy(g).to(torch.bfloat16).to(torch.float32).numpy()
    return np.where(valid[:, :, None], np.tanh(u[:, None, :] + g), 0.0).sum(1)


def _plans(idx, valid, **kw):
    jp = jk.plan_windowed_gather(jnp.asarray(idx), jnp.asarray(valid), tile=TILE, half=HALF,
                                 **kw)
    tp = ek.plan_windowed_gather(torch.from_numpy(idx), torch.from_numpy(valid), tile=TILE,
                                 half=HALF, **kw)
    for name, a, b in zip(PLAN_FIELDS, jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert tp.fb_src.dtype == tp.fb_dst.dtype == torch.int32 and tp.in_mask.dtype == torch.bool
    return jp, tp


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_plain_version_matches_pallas_kernel_in_window():
    u, v, idx, valid = _graph(0)
    jp, tp = _plans(idx, valid)
    assert int(tp.overflow) == 0 and torch.equal(tp.in_mask, torch.from_numpy(valid))
    vpad = np.pad(v, ((HALF, HALF), (0, 0)))
    want = np.asarray(jk.windowed_tanh_sum(*map(jnp.asarray, (u, vpad, idx)), jp.in_mask,
                                           tile=TILE, half=HALF, interpret=True))
    before = ek.windowed_tanh_sum.launches
    got = ek.windowed_tanh_sum(*_t(u, vpad, idx), tp.in_mask, tile=TILE, half=HALF)
    assert ek.windowed_tanh_sum.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _ref(u, v, idx, valid), **TOL)


@pytest.mark.parametrize("far,n", [(0.2, 512), (0.2, 600), (1.0, 512)])
def test_edge_message_sum_matches_jax_with_fallback_edges(far, n):
    """20% far edges (the union tail of the other curve copies), the same
    with N not a multiple of the tile, and every edge far, so that a
    receiver's fallback run is k long; the budget is ample."""
    u, v, idx, valid = _graph(1, n=n, far=far)
    budget = dict(budget=n * 8) if far == 1.0 else {}
    jp, tp = _plans(idx, valid, **budget)
    assert int(tp.overflow) == 0 and int(tp.fb_valid.sum()) > 0
    assert tp.in_mask.shape[0] == -(-n // TILE) * TILE
    want = np.asarray(jk.edge_message_sum(*map(jnp.asarray, (u, v, idx)), jp, tile=TILE,
                                          half=HALF, interpret=True))
    got = ek.edge_message_sum(*_t(u, v, idx), tp, tile=TILE, half=HALF)
    again = ek.edge_message_sum(*_t(u, v, idx), tp, tile=TILE, half=HALF)
    assert got.shape == (n, 64) and torch.equal(got, again)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _ref(u, v, idx, valid), **TOL)


def test_plan_budget_overflow_is_reported():
    n, k = 512, 8
    idx = np.broadcast_to(((np.arange(n)[:, None] + n // 2) % n), (n, k)).astype(np.int32)
    _, tp = _plans(np.ascontiguousarray(idx), np.ones((n, k), bool), budget=64)
    assert int(tp.overflow) > 0 and tp.fb_src.shape == (64,) and bool(tp.fb_valid.all())
    assert isinstance(tp.overflow, torch.Tensor)
    # the default budget is N * k // 4 slots
    assert ek.plan_windowed_gather(*_t(idx, np.ones((n, k), bool))).fb_src.shape == (n * k // 4,)


def test_zero_valid_rows_and_bound_indices():
    n, k, d = 512, 4, 64
    u, v = np.ones((n, d), np.float32), np.full((n, d), 0.5, np.float32)
    idx = np.zeros((n, k), np.int32)
    idx[n - 1] = n - 1
    valid = np.zeros((n, k), bool)
    valid[0] = valid[n - 1] = True
    jp, tp = _plans(idx, valid)
    want = np.asarray(jk.edge_message_sum(*map(jnp.asarray, (u, v, idx)), jp, tile=TILE,
                                          half=HALF, interpret=True))
    got = ek.edge_message_sum(*_t(u, v, idx), tp, tile=TILE, half=HALF).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _ref(u, v, idx, valid), **TOL)
    assert np.abs(got[1:-1]).max() == 0.0


def test_bf16_gather_mode_matches_pallas_and_rounded_reference():
    """The gathered rows are rounded to bfloat16 before the add, ``u`` and
    the sum stay float32, and the fallback edges read unrounded ``v``."""
    u, v, idx, valid = _graph(3, far=0.2)
    jp, tp = _plans(idx, valid)
    want = np.asarray(jk.edge_message_sum(*map(jnp.asarray, (u, v, idx)), jp, tile=TILE,
                                          half=HALF, interpret=True, mxu_dtype=jnp.bfloat16))
    got = ek.edge_message_sum(*_t(u, v, idx), tp, tile=TILE, half=HALF,
                              gather_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    in_mask = tp.in_mask.numpy()
    ref = (_ref(u, v, idx, in_mask, round_v=True) + _ref(u, v, idx, valid & ~in_mask))
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(got - _ref(u, v, idx, valid)).max() > 1e-4  # the rounding is really there


@pytest.mark.parametrize("n,k,d,tile,half", [(111, 3, 12, 37, 5), (90, 5, 4, 30, 0),
                                             (64, 2, 8, 64, 200)])
def test_shapes_the_tpu_kernel_refuses(n, k, d, tile, half):
    """Any positive tile, any half, any d that 4 divides: the window rule
    (mask and 0 <= r < W) against a loop-free numpy form of the same rule."""
    rng = np.random.default_rng(n)
    u, v, _, valid = _graph(n, n=n, k=k, d=d)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    r = idx - (np.arange(n)[:, None] // tile) * tile + half
    in_win = (r >= 0) & (r < tile + 2 * half)
    vpad = np.pad(v, ((half, half), (0, 0)))
    got = ek.windowed_tanh_sum(*_t(u, vpad, idx, valid), tile=tile, half=half)
    np.testing.assert_allclose(got.numpy(), _ref(u, v, idx, valid & in_win), **TOL)
    plan = ek.plan_windowed_gather(*_t(idx, valid), tile=tile, half=half, budget=n * k)
    np.testing.assert_array_equal(plan.in_mask.numpy()[:n], valid & in_win)
    full = ek.edge_message_sum(*_t(u, v, idx), plan, tile=tile, half=half)
    np.testing.assert_allclose(full.numpy(), _ref(u, v, idx, valid), **TOL)


def test_wrapper_checks_and_has_no_gradient():
    u, v, idx, valid = _graph(4, n=256, k=4, d=8)
    vpad = np.pad(v, ((HALF, HALF), (0, 0)))
    tu, tv, ti, tm = _t(u, vpad, idx, valid)
    call = lambda *a, **kw: ek.windowed_tanh_sum(*a, **{"tile": TILE, "half": HALF, **kw})
    with pytest.raises(ValueError, match="multiple of tile"):
        call(tu[:200], tv, ti[:200], tm[:200])
    with pytest.raises(ValueError, match="vpad must have"):
        call(tu, tv[:-1], ti, tm)
    with pytest.raises(ValueError, match="multiple of 4"):
        call(tu[:, :6].contiguous(), tv[:, :6].contiguous(), ti, tm)
    with pytest.raises(ValueError, match="tile"):
        call(tu, tv, ti, tm, tile=0)
    with pytest.raises(TypeError):
        call(tu, tv, ti.long(), tm)
    with pytest.raises(TypeError):
        call(tu.double(), tv, ti, tm)
    with pytest.raises(ValueError, match="contiguous"):
        call(tu, tv, ti.t().contiguous().t(), tm)
    with pytest.raises(ValueError, match="gather_dtype"):
        call(tu, tv, ti, tm, gather_dtype=torch.float16)
    with pytest.raises(RuntimeError, match="no gradient"):
        call(tu.clone().requires_grad_(True), tv, ti, tm)


def test_wrapper_never_takes_the_plain_version_off_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the launch, and a refused
    launch raises. Here the tensors pose as card tensors and the library is
    a stand-in that refuses."""
    class Lib:
        calls = 0

        def edgeconv_windowed_tanh_sum(self, *args):
            Lib.calls += 1
            return 9  # a CUDA error code

    def no_plain(*a, **kw):
        raise AssertionError("the wrapper ran the plain version")

    monkeypatch.setattr(ek.build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(ek, "_lib", lambda: Lib())
    monkeypatch.setattr(ek, "windowed_tanh_sum_torch", no_plain)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    u, v, idx, valid = _graph(5, n=256, k=4, d=8)
    before = ek.windowed_tanh_sum.launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        ek.windowed_tanh_sum(*_t(u, np.pad(v, ((HALF, HALF), (0, 0))), idx, valid),
                             tile=TILE, half=HALF)
    assert Lib.calls == 1 and ek.windowed_tanh_sum.launches == before


@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_edge_message_sum_on_a_real_layer(aggr):
    """``u'`` and ``v`` of the first EdgeConv of a small fused GraphModel on
    Morton-sorted spiral bodies: ``edge_message_sum`` equals the layer's own
    masked tanh sum (1e-5 of max), and the layer's output follows from it."""
    n = 1200
    pos, vel, mass = generate_spiral(torch.Generator().manual_seed(0), n)
    order = torch.sort(morton_keys(pos), stable=True).indices
    pos, vel, mass = pos[order], vel[order], mass[order]
    model = GraphModel(input_dim=4, gnn_dim=16, message_passing_steps=2, aggr=aggr,
                       neighbors=6, knn_method="morton", fused_edgeconv=True,
                       generator=torch.Generator().manual_seed(1)).eval()
    conv = model.convs[0]
    with torch.no_grad():
        idx, valid = build_graph(model.graph_spec, pos[None])
        h = select_input_features(torch.cat([pos, vel, mass[:, None]], -1)[None], 4)
        u, v = (t[0].contiguous() for t in conv.split_terms(h))
        want = torch.where(valid[0][:, :, None],
                           torch.tanh(u[:, None, :] + v[idx[0].long()]), 0.0).sum(1)
        plan = ek.plan_windowed_gather(idx[0], valid[0], tile=TILE, half=HALF)
        assert int(plan.overflow) == 0 and 0 < int(plan.in_mask.sum()) <= int(valid.sum())
        got = ek.edge_message_sum(u, v, idx[0], plan, tile=TILE, half=HALF)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        # the rest of the fused layer on top of the kernel's sum
        cnt = valid[0].sum(1, keepdim=True).float()
        agg = got / cnt.clamp(min=1.0) if aggr == "mean" else got
        out = conv.dense1(agg)
        out = (torch.where(cnt > 0, out, 0.0) if aggr == "mean"
               else out + (cnt - 1.0) * conv.dense1.bias)
        torch.testing.assert_close(out, conv(h, idx, valid)[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["float32", "bfloat16", "overflow", "ragged"])
def test_one_pass_plain_version_matches_jax(case):
    """The plain version of the one-launch ``edge_message_sum`` (every edge
    the plan keeps, the in-window ones rounded in bfloat16 mode) against the
    JAX function (kernel + fallback list): fallback edges read unrounded
    ``v``; with the budget too small the dropped edges stay dropped and the
    overflow is JAX's; N not a multiple of the tile."""
    n = 600 if case == "ragged" else 512
    u, v, idx, valid = _graph(6, n=n, far=0.3)
    kw = dict(budget=200) if case == "overflow" else {}
    jp, tp = _plans(idx, valid, **kw)
    assert (int(tp.overflow) > 0) == (case == "overflow") and int(tp.fb_valid.sum()) > 0
    bf16 = case == "bfloat16"
    want = np.asarray(jk.edge_message_sum(
        *map(jnp.asarray, (u, v, idx)), jp, tile=TILE, half=HALF, interpret=True,
        mxu_dtype=jnp.bfloat16 if bf16 else jnp.float32))
    dtype = torch.bfloat16 if bf16 else torch.float32
    got = ek.edge_message_sum_torch(*_t(u, v, idx), tp, tile=TILE, half=HALF,
                                    gather_dtype=dtype)
    assert torch.equal(got, ek.edge_message_sum(*_t(u, v, idx), tp, tile=TILE, half=HALF,
                                                gather_dtype=dtype))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    kept = (tp.in_mask | tp.fb_mask).numpy()[:n]
    in_mask = tp.in_mask.numpy()[:n]
    ref = (_ref(u, v, idx, in_mask, round_v=bf16) + _ref(u, v, idx, kept & ~in_mask))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    if case == "overflow":  # the sum misses exactly the edges beyond the budget
        assert int((valid & ~kept).sum()) == int(tp.overflow)


@pytest.mark.parametrize("far,n,budget", [(0.2, 512, None), (1.0, 600, None), (1.0, 512, 64)])
def test_plan_fallback_mask_holds_the_jax_list(far, n, budget):
    """The port's ``fb_mask`` marks the JAX plan's fallback list: its edges,
    in row-major order, are JAX's (receiver, sender) slots with
    ``fb_valid`` set, in list order."""
    _, _, idx, valid = _graph(7, n=n, far=far)
    jp, tp = _plans(idx, valid, **({} if budget is None else dict(budget=budget)))
    np_ = tp.in_mask.shape[0]
    assert tp.fb_mask.shape == (np_, 8) and tp.fb_mask.dtype == torch.bool
    rows, slots = np.nonzero(tp.fb_mask.numpy())
    idxp = np.pad(idx, ((0, np_ - n), (0, 0)))
    ok = np.asarray(jp.fb_valid)
    np.testing.assert_array_equal(rows, np.asarray(jp.fb_dst)[ok])
    np.testing.assert_array_equal(idxp[rows, slots], np.asarray(jp.fb_src)[ok])
    assert not (tp.fb_mask & tp.in_mask).any()


def _kernel_tanh(x):
    """The kernel's tanh (``tanh2`` in ``csrc/edgeconv.cu``, its scale read
    from the source) in float32 numpy on the pairs (x[0], x[1]), (x[2],
    x[3]), ..., with exact ex2 and reciprocal in place of the card's
    approximate ones."""
    import re

    src = (Path(ek.__file__).parents[1] / "csrc" / "edgeconv.cu").read_text()
    body = src[src.index("void tanh2("):]
    body = body[:body.index("\n}\n")]
    scale = np.float32(re.search(r"fabsf\(a\) \* (-?[0-9.]+)f", body).group(1))
    f32, f64 = np.float32, np.float64
    x = x.astype(f32)
    with np.errstate(over="ignore"):  # |x| * scale is -inf for the largest floats
        e = np.exp2((np.abs(x) * scale).astype(f32).astype(f64)).astype(f32)
    d = (f32(1) + e).astype(f32)
    da, db = d[0::2], d[1::2]
    r = (1.0 / (da * db).astype(f32).astype(f64)).astype(f32)
    q = np.empty_like(d)
    q[0::2], q[1::2] = (db * r).astype(f32), (da * r).astype(f32)
    t = (-e.astype(f64) * q + q).astype(f32)  # fmaf(-e, q, q)
    return np.copysign(t, x)


def test_kernel_tanh_formula_within_float32_rounding():
    """B11's branch-free tanh with one reciprocal for two channels: with
    exact ex2 and reciprocal it is within 1.8e-7 of tanh over [-20, 20], at
    tiny |x|, at +-0, the largest floats and +-inf, a ninth of the 2e-6 bar
    (the card's approximate ex2 and rcp add their own error;
    ``tests/test_torch_gpu.py`` holds the kernel itself to the bar)."""
    fmax = np.finfo(np.float32).max
    x = np.concatenate([np.linspace(-20, 20, 400_002, dtype=np.float32),
                        np.float32(10.0) ** np.linspace(-30, 0, 20_000, dtype=np.float32),
                        np.array([0.0, -0.0, fmax, -fmax, np.inf, -np.inf], np.float32)])
    x[:-6] = np.random.default_rng(0).permutation(x[:-6])  # pair unlike values
    got = _kernel_tanh(x)
    want = np.tanh(x.astype(np.float64))
    assert float(np.abs(got - want).max()) <= 1.8e-7
    assert np.array_equal(got[-6:], np.array([0.0, -0.0, 1, -1, 1, -1], np.float32))
    assert np.signbit(got[-5])
