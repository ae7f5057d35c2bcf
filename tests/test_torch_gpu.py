"""The port's hand-written CUDA kernels (B1 force and its near-list form,
B2 energy, B3 ContConv collect, B4-B6 its backward, B7 Morton select, B8
Morton merge, B9 and B10 the treecodes' multipole pulls, B11 the windowed
EdgeConv message sum) against their plain-torch twins on the card. A CUDA kernel has no CPU mode, so without a
CUDA device every test here skips. On the card (which has no JAX, hence no
conftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Bars as on the CPU side: forces atol 2e-5 on max-scaled accelerations,
potential energy relative 1e-5, the collect and each cotangent of its
backward 2e-4 of its max (tests/test_models.py:161); B7 and B8 equal their
twins exactly; B9 and B10 1e-5 of max |plain|, B1's near-list form B1's
2e-5; the treecode engines' kernel path against their dense path at the
JAX tests' bar between its two near paths (rtol 2e-3, atol 5e-9 or 2e-8);
B11 rtol = atol = 2e-6 (attic/test_edgeconv_kernel.py:44)."""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.core import SimulationConfig, simulate
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.train import autoregressive_rollout

pytestmark = pytest.mark.gpu

G, EPS = 4.5e-6, 0.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _spiral(n, seed, dev):
    return generate_spiral(torch.Generator().manual_seed(seed), n, device=dev)


@pytest.mark.parametrize("n", [1, 31, 257, 1000])
def test_b1_kernel_matches_twin(cuda, n):
    pos, _, mass = _spiral(n, n, cuda)
    before = pw.partial_accelerations.launches
    got = pw.partial_accelerations(pos, pos, mass, G, EPS)
    assert pw.partial_accelerations.launches == before + 1
    want = pw.partial_accelerations_torch(pos, pos, mass, G, EPS)
    scale = float(want.abs().max()) + 1e-30
    assert float((got - want).abs().max()) / scale <= 2e-5


def test_b1_rectangular_mask_and_zero_softening(cuda):
    pos, _, mass = _spiral(700, 2, cuda)
    tgt = pos[100:190].contiguous()
    got = pw.partial_accelerations(tgt, pos, mass, G, 0.0)
    want = pw.partial_accelerations_torch(tgt, pos, mass, G, 0.0)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) / float(want.abs().max()) <= 2e-5
    mask = torch.arange(700, device=cuda) < 650
    acc = pw.accelerations(pos, mass, G, EPS, mask=mask)
    assert torch.all(acc[650:] == 0)
    ref = pw.partial_accelerations_torch(pos[:650], pos[:650], mass[:650], G, EPS)
    assert float((acc[:650] - ref).abs().max()) / float(ref.abs().max()) <= 2e-5


@pytest.mark.parametrize("n", [2, 255, 256, 1000])
def test_b2_kernel_matches_twin(cuda, n):
    pos, _, mass = _spiral(n, n, cuda)
    got = pw.potential_energy(pos, mass, G, EPS)
    want = pw.pair_potential_torch(pos, mass, pos, mass, G, EPS, masked=True)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    mask = torch.arange(n, device=cuda) < max(n - 7, 1)
    got_m = pw.potential_energy(pos, mass, G, EPS, mask=mask)
    m = mass * mask
    want_m = pw.pair_potential_torch(pos, m, pos, m, G, EPS, masked=True)
    assert abs(float(got_m) - float(want_m)) <= 1e-5 * abs(float(want_m)) + 1e-30


def test_b2_cross_and_chunked(cuda):
    pos, _, mass = _spiral(1500, 5, cuda)
    a, b = pos[:600].contiguous(), pos[600:].contiguous()
    got = pw.cross_potential(a, mass[:600], b, mass[600:], G, EPS)
    want = pw.pair_potential_torch(a, mass[:600], b, mass[600:], G, EPS, masked=False)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    full = float(pw.potential_energy(pos, mass, G, EPS))
    chunked = pw.chunked_potential_energy(pos, mass, G, EPS, chunk=400)
    assert abs(chunked - full) <= 1e-5 * abs(full)


def test_b2_is_deterministic(cuda):
    pos, _, mass = _spiral(3000, 6, cuda)
    us = {float(pw.potential_energy(pos, mass, G, EPS)) for _ in range(5)}
    assert len(us) == 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    pos, _, mass = _spiral(64, 7, cuda)
    with pytest.raises(TypeError):
        pw.partial_accelerations(pos.double(), pos.double(), mass.double(), G, EPS)
    with pytest.raises(ValueError):
        pw.partial_accelerations(pos.t().contiguous().t(), pos, mass, G, EPS)
    with pytest.raises(ValueError):
        pw.partial_accelerations(pos, pos.cpu(), mass, G, EPS)
    with pytest.raises(ValueError):
        pw.pair_potential(pos[:10].contiguous(), mass[:10], pos, mass, G, EPS, masked=True)


def test_simulate_kernel_backend_matches_dense_on_card(cuda):
    pos, vel, mass = _spiral(300, 8, cuda)
    cfg = dict(g_const=1e-3, softening=EPS, dt=1e-3, calc_energy=True)
    tk = simulate(pos, vel, mass, 50, SimulationConfig(**cfg, force_backend="auto"))
    td = simulate(pos, vel, mass, 50, SimulationConfig(**cfg, force_backend="dense"))
    torch.testing.assert_close(tk.positions, td.positions, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tk.u_energy, td.u_energy, rtol=1e-5, atol=0)


def test_surrogate_rollout_on_card_matches_cpu(cuda):
    pos, vel, mass = _spiral(200, 9, torch.device("cpu"))
    model = GraphModel(input_dim=4, gnn_dim=64, message_passing_steps=2, aggr="mean",
                       neighbors=10, generator=torch.Generator().manual_seed(0)).eval()
    want = autoregressive_rollout(model, pos, vel, mass, 10, 1e-4)
    got = autoregressive_rollout(model.to(cuda), pos.to(cuda), vel.to(cuda),
                                 mass.to(cuda), 10, 1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


# ------------------------------------------------ B7/B8 Morton search, B3 collect

from nbody_tpu_torch.models import ContinuousConv  # noqa: E402
from nbody_tpu_torch.ops import contconv_kernel as cck  # noqa: E402
from nbody_tpu_torch.ops import spatial as sp  # noqa: E402
from nbody_tpu_torch.ops.radius import radius_neighbors  # noqa: E402


@pytest.mark.parametrize("n,k,include_self,block", [(1500, 10, False, 256),
                                                    (2000, 32, True, 256),
                                                    (1000, 7, False, 128)])
def test_morton_kernels_match_twins(cuda, n, k, include_self, block):
    pos, _, _ = _spiral(n, n + k, cuda)
    order = sp._curve_order(pos, None, 4)
    cand, _ = sp._candidates(pos, order, block)
    ids, d2 = sp.morton_select(cand, k, block, include_self)
    ids_t, d2_t = sp.morton_select_torch(cand, k, block, include_self)
    assert torch.equal(ids, ids_t) and torch.equal(d2, d2_t)
    cand_m = ids.permute(1, 0, 2).reshape(-1, 4 * k)[:n].contiguous()
    d2_m = d2.permute(1, 0, 2).reshape(-1, 4 * k)[:n].contiguous()
    got = sp.morton_merge(cand_m, d2_m, k)
    want = sp.morton_merge_torch(cand_m, d2_m, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    before = (sp.morton_select.launches, sp.morton_merge.launches)
    idx, valid = sp.knn_morton(pos, k, include_self=include_self, block=block,
                               impl="kernel")
    assert (sp.morton_select.launches, sp.morton_merge.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    idx_c, valid_c = sp.knn_morton(pos.cpu(), k, include_self=include_self,
                                   block=block, impl="kernel")
    assert torch.equal(idx.cpu(), idx_c) and torch.equal(valid.cpu(), valid_c)


def _collect_inputs(m, k, ci, co, d, seed, dev):
    g = torch.Generator().manual_seed(seed)
    gx, gy, gz = (torch.rand(m, k, generator=g) * (d + 1) - 1.0 for _ in range(3))
    window = torch.rand(m, k, generator=g) * (torch.rand(m, k, generator=g) > 0.2)
    feat = torch.randn(m, k, ci, generator=g)
    filters = torch.randn(d ** 3, ci, co, generator=g)
    return [t.to(dev).contiguous() for t in (gx, gy, gz, window, feat, filters)]


@pytest.mark.parametrize("m,k,ci,co,d", [(97, 32, 3, 5, 4), (130, 32, 128, 128, 6),
                                         (45, 6, 128, 128, 4), (70, 40, 16, 16, 3)])
def test_b3_collect_matches_twin(cuda, m, k, ci, co, d):
    args = _collect_inputs(m, k, ci, co, d, m + d, cuda)
    before = cck.contconv_collect.launches
    got = cck.contconv_collect(*args, d=d)
    assert cck.contconv_collect.launches == before + 1
    want = cck.contconv_collect_torch(*args, d=d)
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())
    again = cck.contconv_collect(*args, d=d)
    assert torch.equal(got, again)  # fixed summation order: the same bits


def test_b3_rejects(cuda):
    gx, gy, gz, window, feat, filters = _collect_inputs(40, 8, 16, 16, 4, 1, cuda)
    with pytest.raises(TypeError):
        cck.contconv_collect(gx.double(), gy, gz, window, feat, filters, d=4)
    with pytest.raises(ValueError):
        cck.contconv_collect(gx, gy, gz, window, feat.transpose(0, 1), filters, d=4)
    with pytest.raises(ValueError):
        cck.contconv_collect(gx, gy, gz, window.cpu(), feat, filters, d=4)
    with pytest.raises(RuntimeError):  # d = 1: refused by the launch, no twin
        cck.contconv_collect(gx, gy, gz, window, feat, filters[:1].contiguous(), d=1)


_BWD = (cck.contconv_bwd_geom, cck.contconv_bwd_feat, cck.contconv_bwd_filters)


def _counts():
    return [w.launches for w in _BWD]


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= 2e-4 * float(want.abs().max()) + 1e-30, err


def test_b3_backward_launches_b4_b5_and_b6_only_for_geometry(cuda):
    args = _collect_inputs(70, 8, 16, 12, 4, 2, cuda)
    dout = torch.randn(70, 12, generator=torch.Generator().manual_seed(3)).to(cuda)
    want = cck.contconv_collect_bwd_torch(*args, dout, d=4)
    gx, gy, gz, window, feat, filters = args
    leaves = [feat.clone().requires_grad_(True), filters.clone().requires_grad_(True)]
    before = _counts()
    cck.contconv_collect(gx, gy, gz, window, *leaves, d=4).backward(dout)
    assert [a - b for a, b in zip(_counts(), before)] == [0, 1, 1]  # no B6
    _close(leaves[0].grad, want[4])
    _close(leaves[1].grad, want[5])
    geo = [t.clone().requires_grad_(True) for t in (gx, gy, gz, window)]
    before = _counts()
    cck.contconv_collect(*geo, feat, filters, d=4).backward(dout)
    assert [a - b for a, b in zip(_counts(), before)] == [1, 0, 0]
    for t, w in zip(geo, want[:4]):
        _close(t.grad, w)


@pytest.mark.parametrize("m,k,ci,co,d", [(97, 32, 3, 5, 4), (130, 32, 128, 128, 6),
                                         (45, 6, 128, 128, 4), (70, 40, 16, 16, 3),
                                         (20_000, 32, 128, 128, 6)])
def test_b4_b5_b6_match_plain_backward(cuda, m, k, ci, co, d):
    args = _collect_inputs(m, k, ci, co, d, m + k, cuda)
    dout = torch.randn(m, co, generator=torch.Generator().manual_seed(m)).to(cuda)
    want = cck.contconv_collect_bwd_torch(*args, dout, d=d)
    before = _counts()
    geo = cck.contconv_bwd_geom(*args, dout, d=d)
    dfeat = cck.contconv_bwd_feat(*args, dout, d=d)
    d_f = cck.contconv_bwd_filters(*args, dout, d=d)
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, 1]
    for got, w in zip((*geo, dfeat, d_f), want):
        _close(got, w)
    # fixed summation orders: the same bits on a second run
    assert torch.equal(d_f, cck.contconv_bwd_filters(*args, dout, d=d))
    assert torch.equal(dfeat, cck.contconv_bwd_feat(*args, dout, d=d))
    assert all(torch.equal(a, b) for a, b in zip(geo, cck.contconv_bwd_geom(*args, dout, d=d)))


def test_b4_b5_b6_reject(cuda):
    args = _collect_inputs(40, 8, 16, 16, 4, 1, cuda)
    dout = torch.randn(40, 16, device=cuda)
    for bwd in _BWD:
        with pytest.raises(TypeError):
            bwd(*args, dout.double(), d=4)
        with pytest.raises(ValueError):
            bwd(*args, dout[:30].contiguous(), d=4)
        with pytest.raises(ValueError):
            bwd(*args, dout.cpu(), d=4)
        with pytest.raises(RuntimeError):  # d = 1: refused by the launch, no twin
            bwd(*args[:5], args[5][:1].contiguous(), dout, d=1)
    wide = _collect_inputs(40, 8, 160, 16, 3, 2, cuda)  # ci > 128: B5/B6 refuse
    for bwd in _BWD[:2]:
        with pytest.raises(RuntimeError):
            bwd(*wide, dout, d=3)


def test_b6_takes_a_misaligned_feature_view(cuda):
    """B6 reads feature rows as 16-byte vectors only from a 16-byte aligned
    base; a contiguous view at a 4-byte offset gives the same cotangents."""
    args = _collect_inputs(40, 8, 16, 16, 4, 5, cuda)
    dout = torch.randn(40, 16, generator=torch.Generator().manual_seed(6)).to(cuda)
    buf = torch.empty(args[4].numel() + 1, device=cuda)
    feat = buf[1:].view_as(args[4])
    feat.copy_(args[4])
    assert feat.is_contiguous() and feat.data_ptr() % 16 == 4
    want = cck.contconv_collect_bwd_torch(*args, dout, d=4)
    got = cck.contconv_bwd_geom(*args[:4], feat, args[5], dout, d=4)
    for g, w in zip(got, want[:4]):
        _close(g, w)


def test_morton_wrappers_reject(cuda):
    pos, _, _ = _spiral(600, 3, cuda)
    with pytest.raises(TypeError):
        sp.morton_merge(torch.zeros(10, 40, dtype=torch.int64, device=cuda),
                        torch.zeros(10, 40, device=cuda), 10)
    with pytest.raises(ValueError):
        sp.morton_merge(torch.zeros(10, 40, dtype=torch.int32, device=cuda),
                        torch.zeros(10, 40), 10)
    with pytest.raises(ValueError):
        sp.morton_select(torch.zeros(4, 1024, 4, device=cuda)[:, ::2], 10, 128, False)


def test_contconv_layer_kernel_matches_dense_on_card(cuda):
    pos, _, _ = _spiral(3000, 11, cuda)
    feat = torch.randn(1, 3000, 128, generator=torch.Generator().manual_seed(0)).to(cuda)
    idx, valid = radius_neighbors(pos, 1.0, 32, method="morton", impl="kernel")
    layer = ContinuousConv(128, 128, filter_resolution=6, radius=1.0, impl="dense",
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    with torch.no_grad():
        want = layer(pos[None], feat, idx[None], valid[None])
        layer.impl = "kernel"
        got = layer(pos[None], feat, idx[None], valid[None])
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())
    coarse = ContinuousConv(128, 128, filter_resolution=1, radius=1.0, impl="kernel",
                            generator=torch.Generator().manual_seed(2)).to(cuda)
    with pytest.raises(RuntimeError), torch.no_grad():  # D = 1: no kernel, no twin
        coarse(pos[None], feat, idx[None], valid[None])


# ------------------------------------- B9, B10, B1's near-list form, treecodes

from nbody_tpu_torch.ops import treeforce as tf  # noqa: E402


def _table(k, n_pad, seed, dev):
    """A (K, 10) block table of random moments, the last n_pad rows zero."""
    gen = torch.Generator().manual_seed(seed)
    com = torch.randn(k, 3, generator=gen)
    msum = torch.rand(k, generator=gen) * 1e-3
    d = torch.randn(k, 8, 3, generator=gen) * 0.1
    outer = torch.einsum("kb,kba,kbc->kac", torch.rand(k, 8, generator=gen) * 1e-4, d, d)
    quad = 3 * outer - outer.diagonal(dim1=1, dim2=2).sum(-1)[:, None, None] * torch.eye(3)
    table = tf._blk_rows(com, msum, quad)
    table[k - n_pad:] = 0.0
    return table.to(dev)


def _close_rel(got, want, bar):
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= bar * float(want.abs().max())


@pytest.mark.parametrize("p,k,eps", [(1, 1, EPS), (100, 7, 0.0), (1000, 391, EPS),
                                     (4097, 300, EPS)])
def test_b9_matches_plain(cuda, p, k, eps):
    table = _table(k, min(2, k - 1), p + k, cuda)
    q = torch.randn(p, 3, generator=torch.Generator().manual_seed(p)).to(cuda)
    q[0] = table[0, :3]  # on a COM: finite through the floor
    before = tf.multipole_acc.launches
    got = tf.multipole_acc(q, table, G, eps * eps)
    assert tf.multipole_acc.launches == before + 1
    _close_rel(got, tf.multipole_acc_torch(q, table, G, eps * eps), 1e-5)
    assert torch.equal(got, tf.multipole_acc(q, table, G, eps * eps))


@pytest.mark.parametrize("groups,p,s,k", [(1, 5, 3, 4), (13, 130, 40, 77), (7, 2048, 768, 900),
                                          (31, 128, 80, 400)])
def test_b10_matches_plain(cuda, groups, p, s, k):
    table = _table(k, 3, groups + k, cuda)
    gen = torch.Generator().manual_seed(groups)
    q = torch.randn(groups, p, 3, generator=gen).to(cuda)
    ids = torch.randint(0, k, (groups, s), generator=gen, dtype=torch.int32).to(cuda)
    before = tf.grouped_multipole_acc.launches
    got = tf.grouped_multipole_acc(q, table, ids, G, EPS ** 2)
    assert tf.grouped_multipole_acc.launches == before + 1
    _close_rel(got, tf.grouped_multipole_acc_torch(q, table, ids, G, EPS ** 2), 1e-5)
    assert torch.equal(got, tf.grouped_multipole_acc(q, table, ids, G, EPS ** 2))


@pytest.mark.parametrize("groups,rows,lst,bs", [(7, 256, 32, 256), (13, 128, 48, 32),
                                                (5, 37, 3, 17), (1, 1, 1, 1)])
def test_b1_near_list_matches_plain(cuda, groups, rows, lst, bs):
    gen = torch.Generator().manual_seed(rows + bs)
    n_blocks = lst + 5
    pos, _, mass = _spiral(n_blocks * bs, bs, cuda)
    q = pos[torch.randint(0, n_blocks * bs, (groups * rows,), generator=gen).to(cuda)]
    q = q.reshape(groups, rows, 3).contiguous()  # receivers on sources: self pairs
    near = torch.stack([torch.randperm(n_blocks, generator=gen)[:lst] for _ in range(groups)])
    near = near.to(torch.int32).to(cuda)
    before = pw.near_accelerations.launches
    got = pw.near_accelerations(q, pos, mass, near, bs, G, EPS)
    assert pw.near_accelerations.launches == before + 1
    _close_rel(got, pw.near_accelerations_torch(q, pos, mass, near, bs, G, EPS), 2e-5)
    assert torch.equal(got, pw.near_accelerations(q, pos, mass, near, bs, G, EPS))


def test_treecode_wrappers_reject(cuda):
    table = _table(10, 1, 0, cuda)
    q = torch.randn(4, 3, device=cuda)
    ids = torch.zeros(2, 5, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tf.multipole_acc(q.double(), table.double(), G, 0.0)
    with pytest.raises(ValueError):
        tf.multipole_acc(q, table[:, :9].contiguous(), G, 0.0)
    with pytest.raises(ValueError):
        tf.multipole_acc(q, table.cpu(), G, 0.0)
    with pytest.raises(TypeError):
        tf.grouped_multipole_acc(q.reshape(2, 2, 3), table, ids.long(), G, 0.0)
    with pytest.raises(ValueError):
        tf.grouped_multipole_acc(q.reshape(1, 4, 3), table, ids, G, 0.0)
    with pytest.raises(ValueError):  # 10 source rows are no whole blocks of 3
        pw.near_accelerations(q.reshape(2, 2, 3), torch.zeros(10, 3, device=cuda),
                              torch.zeros(10, device=cuda), ids, 3, G, EPS)
    # list * src_block past int32: refused by the launch, never run as the twin
    wide = torch.zeros(1, 1 << 16, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError):
        pw.near_accelerations(q.reshape(1, 4, 3), torch.zeros(0, 3, device=cuda),
                              torch.zeros(0, device=cuda), wide, 1 << 16, G, EPS)


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_treecode_kernel_path_matches_dense_on_card(cuda, engine):
    pos, _, mass = _spiral(6000, 40, cuda)
    knobs = {"bh": dict(n_near=16, block=128),
             "bh2": dict(n_near=16, block=128, coarse=4, rc=6),
             "bh3": dict(n_near=16, block=128, coarse=4, rc=6, sub_block=32, n_sub=24)}[engine]
    build = {"bh": tf.build_bh_partition, "bh2": tf.build_bh2_partition,
             "bh3": tf.build_bh3_partition}[engine]
    fn = {"bh": tf.bh_accelerations, "bh2": tf.bh2_accelerations,
          "bh3": tf.bh3_accelerations}[engine]
    part = build(pos, mass, **knobs)
    wrappers = (tf.multipole_acc, tf.grouped_multipole_acc, pw.near_accelerations)
    before = [w.launches for w in wrappers]
    got = fn(pos, mass, G, EPS, partition=part)  # "auto": the kernels on the card
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    assert launched == {"bh": [1, 1, 1], "bh2": [1, 3, 1], "bh3": [1, 4, 1]}[engine]
    want = fn(pos, mass, G, EPS, partition=part, near_impl="dense")
    atol = 2e-8 if engine == "bh3" else 5e-9
    torch.testing.assert_close(got, want, rtol=2e-3, atol=atol)
    assert torch.equal(got, fn(pos, mass, G, EPS, partition=part))


def _b11_inputs(n, k, d, half, spread, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn(n, d, generator=gen)
    vpad = torch.nn.functional.pad(torch.randn(n, d, generator=gen), (0, 0, half, half))
    idx = (torch.arange(n)[:, None] + torch.randint(-spread, spread + 1, (n, k), generator=gen)
           ).clamp(0, n - 1).to(torch.int32)
    mask = torch.rand(n, k, generator=gen) < 0.9
    return [t.to(dev) for t in (u, vpad, idx, mask)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,d,tile,half,spread", [
    (111, 3, 12, 37, 5, 30), (2048, 8, 64, 256, 384, 700), (512, 1, 4, 512, 0, 600)])
def test_b11_kernel_matches_plain_version(cuda, n, k, d, tile, half, spread, dtype):
    from nbody_tpu_torch.ops import edgeconv_kernel as ek

    args = _b11_inputs(n, k, d, half, spread, n + k, cuda)
    kw = dict(tile=tile, half=half, gather_dtype=dtype)
    before = ek.windowed_tanh_sum.launches
    got, again = ek.windowed_tanh_sum(*args, **kw), ek.windowed_tanh_sum(*args, **kw)
    assert ek.windowed_tanh_sum.launches == before + 2
    want = ek.windowed_tanh_sum_torch(*args, **kw)
    assert torch.equal(got, again)  # one writer per element, fixed k order
    assert bool(((got - want).abs() <= 2e-6 + 2e-6 * want.abs()).all())


def test_b11_edge_message_sum_on_the_card(cuda):
    """Kernel + fallback list against the full gather, the same bits twice,
    and N not a multiple of the tile."""
    from nbody_tpu_torch.ops import edgeconv_kernel as ek

    n, k, d = 3000, 8, 64
    u, vpad, idx, valid = _b11_inputs(n, k, d, 0, 500, 7, cuda)
    plan = ek.plan_windowed_gather(idx, valid)
    assert int(plan.overflow) == 0 and int(plan.fb_valid.sum()) > 0
    got, again = (ek.edge_message_sum(u, vpad, idx, plan) for _ in range(2))
    want = torch.where(valid[:, :, None], torch.tanh(u[:, None] + vpad[idx.long()]), 0.0).sum(1)
    assert got.shape == (n, d) and torch.equal(got, again)
    assert bool(((got - want).abs() <= 2e-6 + 2e-6 * want.abs()).all())
    with pytest.raises(RuntimeError, match="no gradient"):
        ek.edge_message_sum(u.clone().requires_grad_(True), vpad, idx, plan)


def test_fused_remat_and_chunked_layers_on_the_card(cuda):
    """The fused EdgeConv against the unfused one, ``remat`` against plain
    autograd, and the node-chunked ContConv (B3-B5 per chunk) against the
    unchunked layer, forward and parameter gradients."""
    from nbody_tpu_torch.models import ContinuousConvModel
    from nbody_tpu_torch.train.graphs import build_graph

    pos, vel, mass = _spiral(3000, 5, cuda)
    x = torch.cat([pos, vel, mass[:, None]], -1)[None]
    kw = dict(input_dim=4, gnn_dim=32, message_passing_steps=2, aggr="mean", neighbors=8,
              knn_method="morton", knn_impl="kernel")
    models = [GraphModel(**kw, **extra) for extra in
              ({}, dict(fused_edgeconv=True), dict(fused_edgeconv=True, remat=True))]
    models[0].to(cuda)
    idx, valid = build_graph(models[0].graph_spec, pos[None])
    grads = []
    for m in models:
        m.load_state_dict(models[0].state_dict())
        m.to(cuda).train()
        m(x, idx, valid).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for other in grads[1:]:
        for name, ref in grads[0].items():
            torch.testing.assert_close(other[name], ref, rtol=2e-4,
                                       atol=2e-5 * float(ref.abs().max()))

    ckw = dict(in_channels=4, filter_resolution=(4, 3), radius=1.0, continuous_conv_layers=2,
               continuous_conv_dim=32, radius_method="morton", radius_impl="kernel")
    plain = ContinuousConvModel(**ckw, generator=torch.Generator().manual_seed(1)).to(cuda)
    chunked = ContinuousConvModel(**ckw, conv_node_chunks=3).to(cuda)
    chunked.load_state_dict(plain.state_dict())
    idx, valid = build_graph(plain.graph_spec, pos[None])
    outs = []
    for m in (plain, chunked):
        out = m(x, idx, valid)
        out.square().sum().backward()
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])
    for (name, p), q in zip(plain.named_parameters(), chunked.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=2e-4,
                                   atol=2e-5 * float(p.grad.abs().max()), msg=name)
