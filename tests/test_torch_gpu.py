"""The port's hand-written CUDA kernels (B1 force and its near-list form,
B2 energy, all three also on a group of scenes in one launch,
B3 ContConv collect, B4-B6 its backward (B5 as its dG product and
unbin pass too), B7 Morton select, B8
Morton merge (also a batch's search in one launch of each), B9 and B10 the
treecodes' multipole pulls (also on a group of scenes), B11 the windowed
EdgeConv message sum) against their plain-torch twins on the card. A CUDA kernel has no CPU mode, so without a
CUDA device every test here skips. On the card (which has no JAX, hence no
conftest):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Bars as on the CPU side: forces atol 2e-5 on max-scaled accelerations (B1
also against its float64 run at 2^20 sources and more),
potential energy relative 1e-5 (B2 also one kernel a call and the same bits
on every call), the collect and each cotangent of its
backward 2e-4 of its max (tests/test_models.py:161); B7 and B8 equal their
twins exactly; B9 and B10 1e-5 of max |plain|, B1's near-list form B1's
2e-5; the treecode engines' kernel path against their dense path at the
JAX tests' bar between its two near paths (rtol 2e-3, atol 5e-9 or 2e-8);
B11 rtol = atol = 2e-6 (attic/test_edgeconv_kernel.py:44); the sharded
paths of ``parallel/`` at the dryrun's bars (``parallel/dryrun.py``)."""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.core import SimulationConfig, simulate
from nbody_tpu_torch.ics import generate_spiral
from nbody_tpu_torch.models import GraphModel
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.train import autoregressive_rollout
from nbody_tpu_torch.utils.timing import kernel_events

pytestmark = pytest.mark.gpu

G, EPS = 4.5e-6, 0.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _spiral(n, seed, dev):
    return generate_spiral(torch.Generator().manual_seed(seed), n, device=dev)


@pytest.mark.parametrize("n", [1, 31, 257, 1000, 20_000])
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


def _f64_rows(tgt, pos, mass, rows):
    """The plain version in float64 on the target rows ``rows``, 128 at a
    time."""
    p, m, q = pos.double(), mass.double(), tgt.double()
    return torch.cat([pw.partial_accelerations_torch(q[r], p, m, G, EPS)
                      for r in rows.split(128)])


@pytest.mark.parametrize("ni,nj", [(4096, 1 << 20), (300, (1 << 20) + 37), (70_000, 1 << 20)])
def test_b1_against_float64_at_a_million_sources(cuda, ni, nj):
    """B1 within 2e-5 of max |a| of the float64 sum at 2^20 sources and
    more, with the sources split over blocks (few targets) and not (70,000
    targets fill the card), the same bits twice."""
    pos, _, mass = _spiral(nj, 3, cuda)
    tgt = pos[torch.randperm(nj, generator=torch.Generator().manual_seed(ni))[:ni].to(cuda)]
    chunk = pw.force_chunk(ni, nj, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (nj > chunk) == (ni < 70_000)
    got = pw.partial_accelerations(tgt, pos, mass, G, EPS)
    assert torch.equal(got, pw.partial_accelerations(tgt, pos, mass, G, EPS))
    rows = torch.randperm(ni, generator=torch.Generator().manual_seed(1))[:512].to(cuda)
    want = _f64_rows(tgt, pos, mass, rows)
    err = float((got[rows].double() - want).abs().max())
    assert err <= 2e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("n", [2, 3, 25, 255, 256, 500, 1000, 20_000])
def test_b2_kernel_matches_twin(cuda, n):
    """Masked and cross, with zero-mass rows (a mask's tail and every third
    row), one kernel a call, the same bits five times."""
    pos, _, mass = _spiral(n, n, cuda)
    got = pw.potential_energy(pos, mass, G, EPS)
    want = pw.pair_potential_torch(pos, mass, pos, mass, G, EPS, masked=True)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    mask = torch.arange(n, device=cuda) < max(n - 7, 1)
    got_m = pw.potential_energy(pos, mass, G, EPS, mask=mask)
    m = mass * mask
    want_m = pw.pair_potential_torch(pos, m, pos, m, G, EPS, masked=True)
    assert abs(float(got_m) - float(want_m)) <= 1e-5 * abs(float(want_m)) + 1e-30
    m3 = torch.where(torch.arange(n, device=cuda) % 3 == 1, 0.0, mass)
    a = n // 3 + 1
    x = (pos[:a].contiguous(), m3[:a].contiguous(), pos[a:].contiguous(), m3[a:].contiguous())
    for args, masked in (((pos, m3, pos, m3), True), (x, False)):
        if args[2].shape[0] == 0:
            continue
        got = pw.pair_potential(*args, G, EPS, masked)
        want = pw.pair_potential_torch(*args, G, EPS, masked)
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)) + 1e-30
        names = [name for name, _ in kernel_events(
            lambda: pw.pair_potential(*args, G, EPS, masked), reps=10)]
        assert len(names) == 10 and all("energy_kernel" in x for x in names), names
        before = pw.pair_potential.launches
        bits = {pw.pair_potential(*args, G, EPS, masked).view(torch.int32).item()
                for _ in range(5)}
        assert len(bits) == 1 and pw.pair_potential.launches == before + 5


def _group(s, n, seed, dev):
    ics = [_spiral(n, seed + i, dev) for i in range(s)]
    return torch.stack([x[0] for x in ics]), torch.stack([x[2] for x in ics])


@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("ni,nj", [(7, 7), (500, 500), (4097, 4097), (300, 20_000)])
def test_grouped_b1_b2_are_single_scene_calls(cuda, s, ni, nj):
    """A group of S scenes is one launch of B1 and one of B2 (the counters
    step by one), scene s has the bits of a call on scene s alone, and both
    hold their batched plain versions at the bars. 300 targets over 20,000
    sources split B1's sources into chunks (``force_chunk``)."""
    pos, mass = _group(s, nj, 10 * nj + ni, cuda)
    tgt = pos[:, :ni].contiguous()
    chunk = pw.force_chunk(ni, nj, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (nj > chunk) == (ni == 300)
    b1, b2 = pw.partial_accelerations.launches, pw.pair_potential.launches
    acc = pw.partial_accelerations(tgt, pos, mass, G, EPS)
    u = pw.pair_potential(pos, mass, pos, mass, G, EPS, True)
    a = nj // 3 + 1
    x = (pos[:, :a].contiguous(), mass[:, :a].contiguous(), pos[:, a:].contiguous(),
         mass[:, a:].contiguous())
    ux = pw.pair_potential(*x, G, EPS, False)
    assert pw.partial_accelerations.launches == b1 + 1
    assert pw.pair_potential.launches == b2 + 2
    assert acc.shape == (s, ni, 3) and u.shape == (s,) and ux.shape == (s,)
    for i in range(s):
        assert torch.equal(acc[i], pw.partial_accelerations(tgt[i], pos[i], mass[i], G, EPS))
        assert torch.equal(u[i], pw.pair_potential(pos[i], mass[i], pos[i], mass[i], G, EPS,
                                                   True))
        assert torch.equal(ux[i], pw.pair_potential(*(t[i] for t in x), G, EPS, False))
    want = pw.partial_accelerations_torch(tgt, pos, mass, G, EPS)
    assert float((acc - want).abs().max()) / float(want.abs().max()) <= 2e-5
    for got, want in ((u, pw.pair_potential_torch(pos, mass, pos, mass, G, EPS, True)),
                      (ux, pw.pair_potential_torch(*x, G, EPS, False))):
        assert torch.all((got.double() - want.double()).abs() <= 1e-5 * want.double().abs())


def test_grouped_simulate_is_each_scene_alone(cuda):
    """``simulate`` on a group of 4 through the kernels: every field of
    scene s equals a run of scene s alone, bit for bit, with one B1 and one
    B2 launch a step for the group."""
    ics = [_spiral(300, 40 + i, cuda) for i in range(4)]
    pos, vel, mass = (torch.stack([x[f] for x in ics]) for f in range(3))
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=1e-4, force_backend="kernel")
    b1, b2 = pw.partial_accelerations.launches, pw.pair_potential.launches
    group = simulate(pos, vel, mass, 20, cfg)
    assert (pw.partial_accelerations.launches - b1, pw.pair_potential.launches - b2) == (21, 20)
    for i in range(4):
        alone = simulate(pos[i], vel[i], mass[i], 20, cfg)
        for g_, a_ in zip(group, alone):
            assert torch.equal(g_[:, i], a_)


def test_kernel_events_sees_every_kernel(cuda):
    """Twenty profiler sessions of twenty B2 calls at 20k bodies each see
    all twenty kernels, and their times are the kernel's; with a name, the
    sessions keep that kernel's events."""
    pos, _, mass = _spiral(20_000, 5, cuda)
    for _ in range(20):
        events = kernel_events(lambda: pw.potential_energy(pos, mass, G, EPS), reps=20)
        assert len(events) == 20 and all("energy_kernel" in name for name, _ in events)
        assert all(0 < ms < 10 for _, ms in events)
    named = kernel_events(lambda: pw.potential_energy(pos, mass, G, EPS), reps=5,
                          name="energy_kernel")
    assert len(named) == 5 and all("energy_kernel" in name for name, _ in named)


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


@pytest.mark.parametrize("n,k,include_self,block", [
    (1500, 10, False, 256), (2000, 32, True, 256), (1000, 7, False, 128),
    *((2000, k, inc, 256) for k in (1, 8, 10, 16, 17, 32) for inc in (False, True)
      if (k, inc) not in ((10, False), (32, True))),
    (1000, 32, True, 128), (1000, 8, False, 128), (3000, 10, False, 682), (3000, 32, True, 682),
    (2000, 40, False, 256), (2000, 72, True, 128), (20_000, 40, False, 256),
])
def test_morton_kernels_match_twins(cuda, n, k, include_self, block):
    """B7 (every K of the kernel: 8, 16, 32, and slabs of 32 past k = 32;
    blocks of 128, 256 and 682) and B8 (rows of 4 k: past 128 the wide
    kernel) equal their twins; knn_morton launches each once and equals its
    CPU run."""
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


@pytest.mark.parametrize("k,include_self,block", [(8, False, 256), (10, False, 256),
                                                  (32, True, 256), (32, False, 128),
                                                  (10, True, 682), (40, False, 256)])
def test_morton_select_with_sentinels_in_windows(cuda, k, include_self, block):
    """B7 equals its twin where sentinels (masked rows moved far away, in
    curve order) sit inside windows, not only in the padding blocks."""
    n = 3000
    pos, _, _ = _spiral(n, 11, cuda)
    mask = torch.ones(n, dtype=torch.bool)
    mask[torch.randperm(n, generator=torch.Generator().manual_seed(k))[:n // 10]] = False
    mask = mask.to(cuda)
    order = sp._curve_order(pos, None, 4)
    cand, _ = sp._candidates(torch.where(mask[:, None], pos, sp._BIG), order, block)
    ids, d2 = sp.morton_select(cand, k, block, include_self)
    ids_t, d2_t = sp.morton_select_torch(cand, k, block, include_self)
    assert torch.equal(ids, ids_t)
    assert torch.equal(d2.view(torch.int32), d2_t.view(torch.int32))


@pytest.mark.parametrize("n,w,k", [(4099, 32, 8), (4099, 40, 10), (4099, 128, 32),
                                   (1001, 100, 7), (1001, 5, 3), (1001, 96, 40),
                                   (4099, 160, 40), (1001, 300, 70), (203, 2048, 9)])
def test_b8_matches_plain_on_edge_rows(cuda, n, w, k):
    """B8 equals its plain version bit for bit on rows beyond B7's output
    (``select_bench.merge_edge_rows``: duplicates, unsorted copies, rows
    with fewer than k unique ids, sentinels in the column-mask column at w =
    32, 128 and 2048, infinite distances), at w not a multiple of 32, k past
    w and past the kernel's 32 buffered passes, a last block of part rows,
    and rows wider than 128 (the wide kernel, up to 2048); one launch a
    call, the same bits twice."""
    from nbody_tpu_torch.experiments.select_bench import merge_edge_rows

    cand, d2 = (t.to(cuda) for t in merge_edge_rows(n, w, k, seed=n + w, inf=True))
    before = sp.morton_merge.launches
    got = sp.morton_merge(cand, d2, k)
    assert sp.morton_merge.launches == before + 1
    want = sp.morton_merge_torch(cand, d2, k)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    again = sp.morton_merge(cand, d2, k)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def _collect_inputs(m, k, ci, co, d, seed, dev):
    g = torch.Generator().manual_seed(seed)
    gx, gy, gz = (torch.rand(m, k, generator=g) * (d + 1) - 1.0 for _ in range(3))
    window = torch.rand(m, k, generator=g) * (torch.rand(m, k, generator=g) > 0.2)
    feat = torch.randn(m, k, ci, generator=g)
    filters = torch.randn(d ** 3, ci, co, generator=g)
    return [t.to(dev).contiguous() for t in (gx, gy, gz, window, feat, filters)]


def _grid_inputs(m, k, ci, co, d, seed, dev):
    """:func:`_collect_inputs` with part of the coordinates on the integer
    grid (corners of zero weight) and one receiver without a live edge."""
    args = _collect_inputs(m, k, ci, co, d, seed, dev)
    g = torch.Generator().manual_seed(seed + 1)
    for t in args[:3]:
        on_grid = (torch.rand(m, k, generator=g) < 0.2).to(dev)
        t[on_grid] = torch.randint(0, d, (int(on_grid.sum()),), generator=g).float().to(dev)
    args[3][m // 2] = 0.0
    return args


# (33, ...): fewer receivers than one tile; (50, 40, ..., 2): every receiver
# touches every cell; (70, 64, 128, 128, 6): receivers with more pairs than a
# warp's rows of shared memory (several passes of the bins)
_PLAN_SHAPES = [(97, 32, 3, 5, 4), (130, 32, 128, 128, 6), (33, 7, 5, 3, 3),
                (50, 40, 16, 16, 2), (70, 64, 128, 128, 6), (3000, 32, 128, 128, 6)]


@pytest.mark.parametrize("m,k,ci,co,d", _PLAN_SHAPES)
def test_pair_plan_and_bins_kernels_match_plain(cuda, m, k, ci, co, d):
    gx, gy, gz, window, feat, _ = _grid_inputs(m, k, ci, co, d, m + k + d, cuda)
    plan = cck.pair_plan(gx, gy, gz, window, d=d)
    want = cck.pair_plan_torch(gx, gy, gz, window, d=d)
    for name, got, w in zip(plan._fields, plan, want):
        assert got.dtype == w.dtype and torch.equal(got, w), name
    if d == 2:
        assert plan.cell_r.numel() == (m - 1) * 8  # every cell of every live receiver
    g = cck._bins_cuda(plan, gx, gy, gz, window, feat, d)
    g_want = cck.pair_bins_torch(plan, gx, gy, gz, window, feat, d=d)
    _close(g[:, :ci], g_want)
    assert not g[:, ci:].any()  # pad columns
    assert torch.equal(g, cck._bins_cuda(plan, gx, gy, gz, window, feat, d))


@pytest.mark.parametrize("m,k,ci,co,d", [*_PLAN_SHAPES, (60, 8, 160, 24, 3), (41, 7, 6, 5, 4)])
def test_b5_product_and_unbin_kernels_match_plain(cuda, m, k, ci, co, d):
    """B5's two passes over the plan: dG (the grouped product with dout rows
    gathered by receiver, bank transposed, pad columns zero) and the unbin
    pass (one writer per dfeat row, zeros for dead edges), each against its
    plain version, the same bits twice."""
    gx, gy, gz, window, _, filters = _grid_inputs(m, k, ci, co, d, m + k + d, cuda)
    dout = torch.randn(m, co, generator=torch.Generator().manual_seed(m)).to(cuda)
    plan, items = cck._plan_cuda(gx, gy, gz, window, d)

    def dg_kernel():
        return cck._product_cuda(cck._padded_rows(dout), True, cck._f_transposed(filters),
                                 plan, items, co, ci, d)

    dg = dg_kernel()
    _close(dg[:, :ci], cck.pair_dg_torch(plan, dout, filters))
    assert not dg[:, ci:].any() and torch.equal(dg, dg_kernel())
    dfeat = torch.empty((m, k, ci), device=cuda)
    cck._unbins_cuda(plan, dg, gx, gy, gz, window, d, dfeat)
    _close(dfeat, cck.pair_unbins_torch(plan, dg[:, :ci], gx, gy, gz, window, d=d))
    again = torch.full_like(dfeat, float("nan"))  # every element is written
    assert torch.equal(dfeat, cck._unbins_cuda(plan, dg, gx, gy, gz, window, d, again))


def test_one_plan_serves_b4_and_b5_in_a_backward(cuda, monkeypatch):
    """A backward that wants the filters' and the features' gradients builds
    one plan (the forward built its own) and counts one launch of B4 and of
    B5, also under the filter resolution."""
    plans = []
    real = cck._plan_cuda
    monkeypatch.setattr(cck, "_plan_cuda", lambda *a, **kw: plans.append(1) or real(*a, **kw))
    gx, gy, gz, window, feat, filters = _grid_inputs(97, 32, 16, 12, 4, 5, cuda)
    dout = torch.randn(97, 12, generator=torch.Generator().manual_seed(2)).to(cuda)
    leaves = [feat.clone().requires_grad_(True), filters.clone().requires_grad_(True)]
    out = cck.contconv_collect(gx, gy, gz, window, *leaves, d=4)
    assert len(plans) == 1
    before = [(w.launches, w.launches_by_d[4]) for w in _BWD[1:]]
    out.backward(dout)
    assert len(plans) == 2
    assert [(w.launches, w.launches_by_d[4]) for w in _BWD[1:]] == \
        [(a + 1, b + 1) for a, b in before]
    want = cck.contconv_collect_bwd_torch(gx, gy, gz, window, feat, filters, dout, d=4)
    _close(leaves[0].grad, want[4])
    _close(leaves[1].grad, want[5])


@pytest.mark.parametrize("m,k,ci,co,d", [(60, 8, 160, 24, 3), (33, 7, 5, 3, 3),
                                         (50, 40, 16, 16, 2), (70, 64, 128, 128, 6)])
def test_b3_b4_on_grid_coordinates_and_wide_features(cuda, m, k, ci, co, d):
    """B3, B4 and B5 on geometry with zero-weight corners and a dead
    receiver; ci above 128 (K chunks in B3, slabs in B4 and in B5's
    product)."""
    args = _grid_inputs(m, k, ci, co, d, m + d, cuda)
    dout = torch.randn(m, co, generator=torch.Generator().manual_seed(m)).to(cuda)
    out = cck.contconv_collect(*args, d=d)
    d_f = cck.contconv_bwd_filters(*args, dout, d=d)
    dfeat = cck.contconv_bwd_feat(*args, dout, d=d)
    want = cck.contconv_collect_bwd_torch(*args, dout, d=d, need=(False,) * 4 + (True, True))
    _close(out, cck.contconv_collect_torch(*args, d=d))
    _close(d_f, want[5])
    _close(dfeat, want[4])
    assert not out[m // 2].any() and not dfeat[m // 2].any()
    assert torch.equal(out, cck.contconv_collect(*args, d=d))
    assert torch.equal(d_f, cck.contconv_bwd_filters(*args, dout, d=d))
    assert torch.equal(dfeat, cck.contconv_bwd_feat(*args, dout, d=d))


@pytest.mark.parametrize("m,k,ci,co,d", _PLAN_SHAPES)
def test_plan_sized_by_the_bound_and_by_the_count_agree(cuda, monkeypatch, m, k, ci, co, d):
    """Small shapes size the plan by the most pairs they can have and never
    wait for the device; large ones read the pair count. Both give the exact
    plan's pairs first, the same B3 bits (a row of products does not depend
    on the work items) and B4 within the bar (its partial banks do)."""
    args = _grid_inputs(m, k, ci, co, d, m + k + d, cuda)
    geom = args[:4]
    dout = torch.randn(m, co, generator=torch.Generator().manual_seed(m)).to(cuda)
    rows = cck._plan_rows(m, k, d, ci, co)
    assert rows == m * min(8 * k, d ** 3)
    want = cck.pair_plan_torch(*geom, d=d)
    p = want.cell_r.numel()
    got, (istart, item_rows, bound) = cck._plan_cuda(*geom, d, rows)
    assert got.cell_r.numel() == rows >= p
    assert torch.equal(got.rstart, want.rstart) and torch.equal(got.coff, want.coff)
    for name in ("cell_r", "slot_of", "recv_of"):
        assert torch.equal(getattr(got, name)[:p], getattr(want, name)), name
    want_items = cck._work_items(got, d ** 3)  # the plain version, from the offsets
    assert torch.equal(istart, want_items[0]) and (item_rows, bound) == want_items[1:]
    assert int(istart[-1]) <= bound
    by_bound = cck.contconv_collect(*args, d=d), cck.contconv_bwd_filters(*args, dout, d=d)
    monkeypatch.setattr(cck, "_NO_READ_BYTES", 0)
    assert cck._plan_rows(m, k, d, ci, co) is None
    by_count = cck.contconv_collect(*args, d=d), cck.contconv_bwd_filters(*args, dout, d=d)
    assert torch.equal(by_bound[0], by_count[0])
    _close(by_bound[1], by_count[1])
    _close(by_count[0], cck.contconv_collect_torch(*args, d=d))
    _close(by_count[1], cck.contconv_collect_bwd_torch(*args, dout, d=d,
                                                       need=(False,) * 5 + (True,))[5])


@pytest.mark.parametrize("no_read_bytes", [0, 2 << 30])
def test_b3_b4_without_a_live_edge(cuda, monkeypatch, no_read_bytes):
    monkeypatch.setattr(cck, "_NO_READ_BYTES", no_read_bytes)
    args = _collect_inputs(40, 8, 16, 16, 4, 1, cuda)
    args[3].zero_()
    before = cck.contconv_collect.launches, cck.contconv_bwd_filters.launches
    assert not cck.contconv_collect(*args, d=4).any()
    assert not cck.contconv_bwd_filters(*args, torch.ones(40, 16, device=cuda), d=4).any()
    assert (cck.contconv_collect.launches, cck.contconv_bwd_filters.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("m,k,ci,co,d", [(97, 32, 3, 5, 4), (130, 32, 128, 128, 6),
                                         (45, 6, 128, 128, 4), (70, 40, 16, 16, 3),
                                         (33, 7, 5, 3, 3), (50, 40, 16, 16, 2),
                                         (70, 64, 128, 128, 6)])
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
    big = _collect_inputs(40, 8, 4, 4, 32, 2, cuda)  # d^3 = 32768: past 16-bit cells
    with pytest.raises(RuntimeError):
        cck.contconv_collect(*big, d=32)
    with pytest.raises(ValueError):  # the plan alone checks its inputs too
        cck.pair_plan(gx, gy, gz, window[:30].contiguous(), d=4)


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
                                         (33, 7, 5, 3, 3), (50, 40, 16, 16, 2),
                                         (20_000, 32, 128, 128, 6), (20_000, 32, 128, 128, 4)])
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
    big = _collect_inputs(40, 8, 4, 16, 32, 2, cuda)  # d^3 = 32768: past 16-bit cells
    for bwd in _BWD:
        with pytest.raises(RuntimeError):
            bwd(*big, dout, d=32)


# one shape past each cap the kernels once had: k > 64, co > 128, D > 10,
# ci > 128 (B6 refused it), at a few hundred receivers
_PAST_CAPS = [(300, 72, 16, 16, 3), (300, 8, 16, 136, 3), (300, 8, 8, 8, 11),
              (300, 8, 136, 16, 3)]


@pytest.mark.parametrize("m,k,ci,co,d", _PAST_CAPS)
def test_kernels_past_the_lifted_caps(cuda, m, k, ci, co, d):
    """B3-B6 at shapes the JAX package runs and the card kernels refused
    before: each against its plain version at the bar, the same bits twice,
    one launch a call; the plan against its plain version."""
    args = _grid_inputs(m, k, ci, co, d, m + k + d, cuda)
    dout = torch.randn(m, co, generator=torch.Generator().manual_seed(m)).to(cuda)
    for all_edges in (False, True):
        plan = cck.pair_plan(*args[:4], d=d, all_edges=all_edges)
        want_plan = cck.pair_plan_torch(*args[:4], d=d, all_edges=all_edges)
        assert all(torch.equal(a, b) for a, b in zip(plan, want_plan))
    before = [w.launches for w in (cck.contconv_collect, *_BWD)]
    out = cck.contconv_collect(*args, d=d)
    geo = cck.contconv_bwd_geom(*args, dout, d=d)
    dfeat = cck.contconv_bwd_feat(*args, dout, d=d)
    d_f = cck.contconv_bwd_filters(*args, dout, d=d)
    assert [w.launches - b for w, b in zip((cck.contconv_collect, *_BWD), before)] == [1] * 4
    _close(out, cck.contconv_collect_torch(*args, d=d))
    want = cck.contconv_collect_bwd_torch(*args, dout, d=d)
    for got, w in zip((*geo, dfeat, d_f), want):
        _close(got, w)
    assert torch.equal(out, cck.contconv_collect(*args, d=d))
    assert all(torch.equal(a, b) for a, b in zip(geo, cck.contconv_bwd_geom(*args, dout, d=d)))
    assert torch.equal(dfeat, cck.contconv_bwd_feat(*args, dout, d=d))
    assert torch.equal(d_f, cck.contconv_bwd_filters(*args, dout, d=d))


@pytest.mark.parametrize("m,k,ci,co,d", [*_PLAN_SHAPES, *_PAST_CAPS, (60, 8, 160, 24, 3),
                                         (41, 7, 6, 5, 4)])
def test_b6_geometry_pass_matches_plain(cuda, m, k, ci, co, d):
    """B6's geometry pass over a plan that keeps the edges of zero window
    and B5's dG rows, against its plain version on the same plan and dG
    (zero windows, corners of zero weight, a receiver with no live edge,
    receivers with more pairs than a warp's rows), each element written
    (a NaN-filled output would show), the same bits twice."""
    gx, gy, gz, window, feat, filters = _grid_inputs(m, k, ci, co, d, m + k + d, cuda)
    dout = torch.randn(m, co, generator=torch.Generator().manual_seed(m)).to(cuda)
    plan, items = cck._plan_cuda(gx, gy, gz, window, d, all_edges=True)
    dg = cck._product_cuda(cck._padded_rows(dout), True, cck._f_transposed(filters), plan,
                           items, co, ci, d)
    got = cck._geom_cuda(plan, dg, gx, gy, gz, window, feat, d)
    want = cck.pair_geom_torch(plan, dg[:, :ci], gx, gy, gz, window, feat, d=d)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[3][m // 2].abs().min() > 0  # the dead receiver's dwindow
    again = cck._geom_cuda(plan, dg, gx, gy, gz, window, feat, d)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_one_plan_serves_b4_b5_and_b6_in_a_backward(cuda, monkeypatch):
    """A backward that wants every cotangent builds one plan (the forward
    built its own), the one that keeps the edges of zero window, and counts
    one launch of B4, B5 and B6; the four geometry cotangents, the
    features' and the filters' hold their plain versions."""
    plans = []
    real = cck._plan_cuda
    monkeypatch.setattr(cck, "_plan_cuda",
                        lambda *a, **kw: plans.append(kw.get("all_edges")) or real(*a, **kw))
    gx, gy, gz, window, feat, filters = _grid_inputs(97, 32, 16, 12, 4, 5, cuda)
    dout = torch.randn(97, 12, generator=torch.Generator().manual_seed(2)).to(cuda)
    leaves = [t.clone().requires_grad_(True) for t in (gx, gy, gz, window, feat, filters)]
    out = cck.contconv_collect(*leaves, d=4)
    before = _counts()
    out.backward(dout)
    assert plans == [None, True]  # the forward's, then one with the dead edges
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, 1]
    want = cck.contconv_collect_bwd_torch(gx, gy, gz, window, feat, filters, dout, d=4)
    for t, w in zip(leaves, want):
        _close(t.grad, w)


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
    with pytest.raises(ValueError):  # wider than the packed keys' 2048 columns
        sp.morton_merge(torch.zeros(10, 2049, dtype=torch.int32, device=cuda),
                        torch.zeros(10, 2049, device=cuda), 10)
    with pytest.raises(ValueError):
        sp.morton_select(torch.zeros(4, 1024, 4, device=cuda)[:, ::2], 10, 128, False)
    with pytest.raises(ValueError):  # more than the window's 3 * block candidates
        sp.morton_select(torch.zeros(4, 5 * 64, 4, device=cuda), 193, 64, False)


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


@pytest.mark.parametrize("p,k", [(1, 1), (100, 7), (255, 300), (1000, 391), (4097, 300),
                                 (100_000, 391)])
def test_b9_is_b10_on_every_row(cuda, p, k):
    """B9 runs B10's receiver loop without an id list: it equals B10 given
    one group and the list 0 .. K - 1, bit for bit (4 lanes, and 8 under
    256 receivers)."""
    table = _table(k, min(2, k - 1), p + k, cuda)
    q = torch.randn(p, 3, generator=torch.Generator().manual_seed(p)).to(cuda)
    ids = torch.arange(k, dtype=torch.int32, device=cuda)[None]
    got = tf.multipole_acc(q, table, G, EPS ** 2)
    assert torch.equal(got, tf.grouped_multipole_acc(q[None], table, ids, G, EPS ** 2)[0])


# the redesigns' edges: groups not a multiple of a block's receivers (129,
# 200) or under one thread's (3); an empty list; lists that end inside a
# staged tile (257, 300, and 297 candidates); groups smaller than a block of
# B10; src_block 17 and 300, neither dividing nor divided by the tile.
# These cases also carry ids of -1 and past the table, read as zero rows.
_B10_EDGES = [(3, 129, 300, 77), (2, 200, 0, 10), (5, 3, 257, 40), (4, 64, 33, 50),
              (3, 100, 80, 90)]
_NEAR_EDGES = [(3, 129, 5, 17), (2, 200, 4, 300), (4, 3, 7, 32), (2, 128, 0, 32),
               (3, 130, 9, 33)]


def _out_of_range(ids, n):
    """``ids`` with its first column -1 and its last column n + 2: ids the
    kernels read as zero rows."""
    ids = ids.clone()
    if ids.shape[1]:
        ids[:, 0] = -1
        ids[:, -1] = n + 2
    return ids


def _close_or_zero(got, want, bar, empty):
    if empty:  # nothing listed: exact zeros
        assert torch.equal(got, torch.zeros_like(got))
    else:
        _close_rel(got, want, bar)


@pytest.mark.parametrize("groups,p,s,k", [(1, 5, 3, 4), (13, 130, 40, 77), (7, 2048, 768, 900),
                                          (31, 128, 80, 400), *_B10_EDGES])
def test_b10_matches_plain(cuda, groups, p, s, k):
    table = _table(k, 3, groups + k, cuda)
    gen = torch.Generator().manual_seed(groups)
    q = torch.randn(groups, p, 3, generator=gen).to(cuda)
    ids = torch.randint(0, k, (groups, s), generator=gen, dtype=torch.int32).to(cuda)
    if (groups, p, s, k) in _B10_EDGES:
        ids = _out_of_range(ids, k)
    before = tf.grouped_multipole_acc.launches
    got = tf.grouped_multipole_acc(q, table, ids, G, EPS ** 2)
    assert tf.grouped_multipole_acc.launches == before + 1
    _close_or_zero(got, tf.grouped_multipole_acc_torch(q, table, ids, G, EPS ** 2), 1e-5, s == 0)
    assert torch.equal(got, tf.grouped_multipole_acc(q, table, ids, G, EPS ** 2))


def _near_inputs(groups, rows, lst, bs, dev):
    gen = torch.Generator().manual_seed(rows + bs)
    n_blocks = lst + 5
    pos, _, mass = _spiral(n_blocks * bs, bs, dev)
    q = pos[torch.randint(0, n_blocks * bs, (groups * rows,), generator=gen).to(dev)]
    q = q.reshape(groups, rows, 3).contiguous()  # receivers on sources: self pairs
    near = torch.stack([torch.randperm(n_blocks, generator=gen)[:lst] for _ in range(groups)])
    near = near.to(torch.int32).to(dev)
    if (groups, rows, lst, bs) in _NEAR_EDGES:
        near = _out_of_range(near, n_blocks)
    return q, pos, mass, near


@pytest.mark.parametrize("groups,rows,lst,bs", [(7, 256, 32, 256), (13, 128, 48, 32),
                                                (5, 37, 3, 17), (1, 1, 1, 1), *_NEAR_EDGES])
def test_b1_near_list_matches_plain(cuda, groups, rows, lst, bs):
    q, pos, mass, near = _near_inputs(groups, rows, lst, bs, cuda)
    before = pw.near_accelerations.launches
    got = pw.near_accelerations(q, pos, mass, near, bs, G, EPS)
    assert pw.near_accelerations.launches == before + 1
    _close_or_zero(got, pw.near_accelerations_torch(q, pos, mass, near, bs, G, EPS), 2e-5,
                   lst == 0)
    assert torch.equal(got, pw.near_accelerations(q, pos, mass, near, bs, G, EPS))


@pytest.mark.parametrize("groups,rows,lst,bs", [(3, 200, 10, 300), (2, 129, 40, 17),
                                                (2, 128, 48, 32)])
def test_b1_near_list_is_b1_on_the_gathered_candidates(cuda, groups, rows, lst, bs):
    """The near list runs B1's tile body in B1's order: each group equals
    B1 (one chunk) on its gathered candidates bit for bit, with out-of-range
    ids as zero-mass sources at the origin."""
    q, pos, mass, near = _near_inputs(groups, rows, lst, bs, cuda)
    n_blocks = pos.shape[0] // bs
    near = _out_of_range(near, n_blocks)
    got = pw.near_accelerations(q, pos, mass, near, bs, G, EPS)
    src = torch.cat([torch.cat([pos, mass[:, None]], 1).reshape(-1, bs, 4),
                     torch.zeros(1, bs, 4, device=cuda)])  # the zero block last
    ids = torch.where((near >= 0) & (near < n_blocks), near, n_blocks).long()
    for g in range(groups):
        cand = src[ids[g]].reshape(-1, 4)
        assert pw.force_chunk(rows, cand.shape[0], 132) >= cand.shape[0]  # one chunk
        one = pw.partial_accelerations(q[g], cand[:, :3].contiguous(),
                                       cand[:, 3].contiguous(), G, EPS)
        assert torch.equal(got[g], one), g


def test_bh_exact_when_all_blocks_near_on_card(cuda):
    """Every block near (M >= nb): the far field cancels against the near
    subtraction (B9 against B10, one multipole_pull) and the kernel path is
    B1's exact sum within B1's bar, and within the bar of its CPU twin
    (tests/test_torch_treeforce.py::test_bh_exact_when_all_blocks_near, a
    disk as there)."""
    from nbody_tpu_torch.ics import generate_disk

    pos, _, mass = generate_disk(torch.Generator().manual_seed(2), 5000, device=cuda)
    wrappers = (tf.multipole_acc, tf.grouped_multipole_acc, pw.near_accelerations)
    before = [w.launches for w in wrappers]
    got = tf.bh_accelerations(pos, mass, G, EPS, n_near=64, block=128)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 1]
    exact = pw.accelerations(pos, mass, G, EPS)
    _close_rel(got, exact, 2e-5)
    torch.testing.assert_close(got, exact, rtol=2e-3, atol=1e-12)


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


# a scene axis on B9, B10 and the near list: (kernel, scenes, groups,
# receivers, list, table rows or source blocks, source block rows): groups
# of one block, of several and ragged ones; the near list's src_block
# dividing the tile or not
_SCENE_CASES = [("b9", 3, 1, 1000, 0, 391, 0), ("b9", 2, 1, 4097, 0, 300, 0),
                ("b10", 4, 13, 130, 40, 77, 0), ("b10", 2, 7, 2048, 768, 900, 0),
                ("b10", 3, 31, 128, 80, 400, 0), ("near", 4, 13, 130, 8, 20, 17),
                ("near", 2, 7, 256, 32, 40, 256), ("near", 3, 31, 128, 48, 60, 32)]


@pytest.mark.parametrize("kernel,s,groups,p,lst,k,bs", _SCENE_CASES)
def test_scene_axis_kernels_are_single_scene_calls(cuda, kernel, s, groups, p, lst, k, bs):
    """B9, B10 and B1's near list on a group of scenes: one launch, within
    the plain version's bar, and each scene bit for bit the kernel's call on
    that scene alone; scene 0's ids of -1 and of its own row or block count
    read as zero rows (as a call with a zero row appended, listed there),
    never as another scene's."""
    gen = torch.Generator().manual_seed(s * p + k)
    ids = torch.randint(0, k, (s, groups, lst), generator=gen, dtype=torch.int32).to(cuda)
    if lst:
        ids[0, :, 0], ids[0, :, -1] = -1, k
    as_pad = torch.where((ids[0] >= 0) & (ids[0] < k), ids[0], k)
    if kernel == "near":
        pos, _, mass = _spiral(s * k * bs, k + bs, cuda)
        q = pos[torch.randint(0, s * k * bs, (s * groups * p,), generator=gen).to(cuda)]
        q = q.reshape(s, groups, p, 3).contiguous()  # receivers on sources: self pairs
        pos, mass = pos.reshape(s, k * bs, 3), mass.reshape(s, k * bs)
        wrapper, plain, bar = pw.near_accelerations, pw.near_accelerations_torch, 2e-5
        args = (q, pos, mass, ids, bs, G, EPS)
        padded = (q[0], torch.cat([pos[0], torch.zeros(bs, 3, device=cuda)]),
                  torch.cat([mass[0], torch.zeros(bs, device=cuda)]), as_pad, bs, G, EPS)
    else:
        table = torch.stack([_table(k, 2, i + k, cuda) for i in range(s)])
        q = torch.randn(s, groups, p, 3, generator=gen).to(cuda)
        padded = (q[0], torch.cat([table[0], torch.zeros(1, 10, device=cuda)]), as_pad,
                  G, EPS ** 2)
        if kernel == "b9":
            wrapper, plain = tf.multipole_acc, tf.multipole_acc_torch
            args = (q.reshape(s, groups * p, 3), table, G, EPS ** 2)
        else:
            wrapper, plain = tf.grouped_multipole_acc, tf.grouped_multipole_acc_torch
            args = (q, table, ids, G, EPS ** 2)
        bar = 1e-5
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before + 1
    _close_rel(got, plain(*args), bar)
    for i in range(s):
        assert torch.equal(got[i], wrapper(*(a[i] if torch.is_tensor(a) else a for a in args)))
    if kernel != "b9":
        assert torch.equal(got[0], wrapper(*padded))


def _tree_group(engine, s, n, seed, dev):
    knobs = {"bh": dict(n_near=16, block=128),
             "bh2": dict(n_near=16, block=128, coarse=4, rc=6),
             "bh3": dict(n_near=16, block=128, coarse=4, rc=6, sub_block=32, n_sub=24)}[engine]
    ics = [_spiral(n, seed + i, dev) for i in range(s)]
    return tuple(torch.stack([x[f] for x in ics]) for f in range(3)), knobs


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_treecode_group_is_each_scene_alone_on_card(cuda, engine):
    """A group of 3 scenes: its partition's fields and its accelerations
    equal each scene's own bit for bit, with each kernel launched once for
    the group (B10 3 times for bh2, 4 for bh3, as for one scene)."""
    (pos, _, mass), knobs = _tree_group(engine, 3, 6000, 50, cuda)
    build = getattr(tf, f"build_{engine}_partition")
    fn = getattr(tf, f"{engine}_accelerations")
    part = build(pos, mass, **knobs)
    wrappers = (tf.multipole_acc, tf.grouped_multipole_acc, pw.near_accelerations)
    before = [w.launches for w in wrappers]
    got = fn(pos, mass, G, EPS, partition=part)
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    assert launched == {"bh": [1, 1, 1], "bh2": [1, 3, 1], "bh3": [1, 4, 1]}[engine]
    for i in range(3):
        alone = build(pos[i], mass[i], **knobs)
        for f in alone._fields:
            assert torch.equal(getattr(part, f)[i], getattr(alone, f)), (i, f)
        assert torch.equal(got[i], fn(pos[i], mass[i], G, EPS, partition=alone))


@pytest.mark.parametrize("engine,refresh", [("bh", 4), ("bh3", 2)])
def test_treecode_group_rollout_is_each_scene_alone_on_card(cuda, engine, refresh):
    """``simulate`` on a treecode group (energies through B2) gives each scene
    the trajectory of its run alone, every field bit for bit."""
    (pos, vel, mass), knobs = _tree_group(engine, 3, 4000, 60, cuda)
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=1e-4, force_backend=engine,
                           bh_near=knobs["n_near"], bh_block=knobs["block"],
                           bh_coarse=knobs.get("coarse", 16), bh_rc=knobs.get("rc", 32),
                           bh_sub_block=knobs.get("sub_block", 32),
                           bh_n_sub=knobs.get("n_sub", 24), bh_refresh=refresh)
    before = tf.multipole_acc.launches
    group = simulate(pos, vel, mass, 8, cfg)
    assert tf.multipole_acc.launches == before + 9  # once a force evaluation
    for i in range(3):
        alone = simulate(pos[i], vel[i], mass[i], 8, cfg)
        for g_, a_ in zip(group, alone):
            assert torch.equal(g_[:, i], a_)


@pytest.mark.parametrize("n,k,include_self,masked", [(3000, 8, False, False),
                                                     (2000, 32, True, True)])
def test_batched_morton_graph_is_one_b7_and_one_b8(cuda, n, k, include_self, masked):
    """A batch's Morton search: one B7 launch over its B x 4 copies and one
    B8 launch over its B x N rows; each scene's ids and validity those of a
    call on it alone, also through the Morton radius search."""
    from nbody_tpu_torch.ops import radius

    pos = torch.stack([_spiral(n, n + i, cuda)[0] for i in range(4)])
    mask = None
    if masked:
        mask = torch.rand(4, n, generator=torch.Generator().manual_seed(k)).to(cuda) < 0.9
    before = (sp.morton_select.launches, sp.morton_merge.launches)
    idx, valid = sp.batched_knn_morton(pos, k, mask=mask, include_self=include_self,
                                       impl="kernel")
    assert (sp.morton_select.launches, sp.morton_merge.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    r_idx, r_valid = radius.batched_radius_neighbors(pos, 0.5, k, mask=mask,
                                                     include_self=include_self,
                                                     method="morton", impl="kernel")
    for i in range(4):
        m = None if mask is None else mask[i]
        one = sp.knn_morton(pos[i], k, mask=m, include_self=include_self, impl="kernel")
        assert torch.equal(idx[i], one[0]) and torch.equal(valid[i], one[1])
        r_one = radius.radius_neighbors(pos[i], 0.5, k, mask=m, include_self=include_self,
                                        method="morton", impl="kernel")
        assert torch.equal(r_idx[i], r_one[0]) and torch.equal(r_valid[i], r_one[1])
    with pytest.raises(ValueError, match="copies"):  # past the grid's y
        sp.morton_select(torch.zeros(sp.MAX_COPIES + 1, 3, 4, device=cuda), 1, 1, True)


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


@pytest.mark.parametrize("case", ["float32", "bfloat16", "overflow", "ragged"])
def test_b11_one_launch_edge_message_sum(cuda, case):
    """``edge_message_sum`` as one launch of B11 in its owned mode: against
    its plain version and the full gather (in bfloat16 mode the in-window
    edges rounded, the fallback edges not; with the budget too small, the
    kept edges only), one launch a call and the same bits twice."""
    from nbody_tpu_torch.ops import edgeconv_kernel as ek

    n = 3001 if case == "ragged" else 3072
    u, v, idx, valid = _b11_inputs(n, 8, 64, 0, 900, 11, cuda)
    plan = ek.plan_windowed_gather(idx, valid, tile=256, half=384,
                                   budget=500 if case == "overflow" else n * 8)
    assert (int(plan.overflow) > 0) == (case == "overflow") and int(plan.fb_valid.sum()) > 0
    dtype = torch.bfloat16 if case == "bfloat16" else torch.float32
    kw = dict(tile=256, half=384, gather_dtype=dtype)
    before = ek.windowed_tanh_sum.launches
    got, again = (ek.edge_message_sum(u, v, idx, plan, **kw) for _ in range(2))
    assert ek.windowed_tanh_sum.launches == before + 2
    assert got.shape == (n, 64) and torch.equal(got, again)
    want = ek.edge_message_sum_torch(u, v, idx, plan, **kw)
    kept, in_mask = (plan.in_mask | plan.fb_mask)[:n], plan.in_mask[:n]
    g = v[idx.long()]
    if case == "bfloat16":
        g = torch.where(in_mask[:, :, None], g.to(torch.bfloat16).float(), g)
    full = torch.where(kept[:, :, None], torch.tanh(u[:, None] + g), 0.0).sum(1)
    assert int((valid & ~kept).sum()) == int(plan.overflow)
    for ref in (want, full):
        assert bool(((got - ref).abs() <= 2e-6 + 2e-6 * ref.abs()).all())


def test_b11_tanh_over_the_float_range(cuda):
    """B11's branch-free tanh, read through a k = 1 sum with zero senders,
    against float64 tanh within the bar (rtol = atol = 2e-6): a dense sweep
    of [-20, 20], tiny |x|, +-0, the largest floats and +-inf."""
    from nbody_tpu_torch.ops import edgeconv_kernel as ek

    fmax = torch.finfo(torch.float32).max
    x = torch.cat([torch.linspace(-20, 20, 4_000_001, dtype=torch.float64),
                   10.0 ** torch.linspace(-30, 0, 100_001, dtype=torch.float64),
                   -(10.0 ** torch.linspace(-30, 0, 100_001, dtype=torch.float64)),
                   torch.tensor([0.0, -0.0, fmax, -fmax, float("inf"), float("-inf")],
                                dtype=torch.float64)]).float()
    d = 64
    n = -(-x.numel() // d)
    u = torch.nn.functional.pad(x, (0, n * d - x.numel())).view(n, d).to(cuda)
    zeros = torch.zeros(n, d, device=cuda)
    idx = torch.arange(n, dtype=torch.int32, device=cuda)[:, None]
    mask = torch.ones(n, 1, dtype=torch.bool, device=cuda)
    got = ek.windowed_tanh_sum(u, zeros, idx, mask, tile=n, half=0).double()
    want = torch.tanh(u.double())
    err = (got - want).abs()
    assert bool((err <= 2e-6 + 2e-6 * want.abs()).all()), float(err.max())
    assert bool(torch.isfinite(got).all())


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


def test_parallel_dryrun_on_two_ranks_of_one_card(cuda):
    """Every sharded path of ``parallel/`` at the dryrun's small shapes, on 2
    ranks on cuda:0 over gloo, each rank 0 result held to one process (the
    dryrun raises on a miss); the kernels of the paths launched on the
    ranks."""
    from nbody_tpu_torch.parallel import dryrun

    out = dryrun.main(["--ranks", "2", "--device", "cuda:0", "--backend", "gloo"])
    assert out["device"] == "cuda:0" and out["backend"] == "gloo" and out["world"] == 2
    assert all(out["bh"][e]["bits_equal"] for e in ("bh", "bh2", "bh3", "bh_uneven"))
    ran = out["launches"]
    assert min(ran[k] for k in ("b1", "b1n", "b2", "b3", "b4", "b5", "b9", "b10")) > 0, ran
    assert ran["b6"] == 0, ran
