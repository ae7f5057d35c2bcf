"""Treecode scene groups and a batch's Morton graph in the port, on the CPU:
a group of scenes against each scene run alone, and against ``jax.vmap`` of
the JAX package on the same numpy inputs.

Bars:

- a group against its scenes alone: partition fields, accelerations,
  positions, velocities and kinetic energies equal (``torch.equal``). The
  potential energy of a treecode run on the CPU is the dense path's
  ``forces.potential_energy``, one (S, N, N) sum for the group, which a
  multi-threaded CPU reduction may cut otherwise than one scene's (N, N):
  relative 1e-5 (B2's bar, ``tests/test_forces.py:114-130``); on the card
  it is B2, which gives each scene its own bits;
- partitions against ``jax.vmap`` of the JAX builders: the bars of
  ``tests/test_torch_treeforce.py`` (sorted ids and inverse ranks equal,
  id sets equal on >= 99 % of rows, all-pad blocks left out);
- engines on a partition carried from ``jax.vmap``: rtol 2e-3 with atol
  5e-9 (bh, bh2) or 2e-8 (bh3), the JAX tests' bar between their two near
  paths (``tests/test_treeforce.py:136-137,241-242,401-402``);
- the Morton graph against JAX ``batched_knn_morton(impl="pallas_interpret")``:
  ``tests/test_torch_spatial.py``'s bar (identical rows on >= 99.9 %, the
  rest near-ties).
"""

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.ics import generate_spiral as jgenerate_spiral
from nbody_tpu.ops import spatial as jsp
from nbody_tpu.ops import treeforce as jtf
from nbody_tpu_torch.core import SimulationConfig, simulate
from nbody_tpu_torch.data import generate as tgen
from nbody_tpu_torch.ops import pairwise as tpw
from nbody_tpu_torch.ops import radius as tradius
from nbody_tpu_torch.ops import spatial as tsp
from nbody_tpu_torch.ops import treeforce as ttf

G, EPS, DT = 4.5e-6, 0.05, 1e-4
S, N = 3, 1024
KNOBS = {"bh": dict(n_near=8, block=64),
         "bh2": dict(n_near=8, block=64, coarse=4, rc=3),
         "bh3": dict(n_near=8, block=64, coarse=4, rc=3, sub_block=16, n_sub=12)}
ATOL = {"bh": 5e-9, "bh2": 5e-9, "bh3": 2e-8}
JAX_BUILD = {"bh": jtf.build_bh_partition, "bh2": jtf.build_bh2_partition,
             "bh3": jtf.build_bh3_partition}
JAX_ENGINE = {"bh": jtf.bh_accelerations, "bh2": jtf.bh2_accelerations,
              "bh3": jtf.bh3_accelerations}


def _group(s=S, n=N, seed=0):
    """A group of JAX-made spiral galaxies, as numpy (pos, vel, mass)."""
    ics = [jgenerate_spiral(jax.random.PRNGKey(seed + i), n, g_const=G) for i in range(s)]
    return tuple(np.stack([np.array(x[f]) for x in ics]) for f in range(3))


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _build(engine):
    return getattr(ttf, f"build_{engine}_partition")


def _engine(engine):
    return getattr(ttf, f"{engine}_accelerations")


# --------------------------------------------------- a group and its scenes

@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_group_partition_and_forces_are_each_scene_alone(engine):
    """Every field of a group partition, and the group's accelerations on
    it, equal the single-scene ones bit for bit, also where the scenes are
    built in chunks (a pair-matrix budget of one scene)."""
    pos, _, mass = _torch(*_group())
    part = _build(engine)(pos, mass, **KNOBS[engine])
    acc = _engine(engine)(pos, mass, G, EPS, partition=part)
    assert acc.shape == (S, N, 3)
    for s in range(S):
        alone = _build(engine)(pos[s], mass[s], **KNOBS[engine])
        for f in alone._fields:
            assert torch.equal(getattr(part, f)[s], getattr(alone, f)), (s, f)
        assert torch.equal(acc[s], _engine(engine)(pos[s], mass[s], G, EPS, partition=alone))
    old = ttf._GROUP_PAIR_BYTES
    try:
        ttf._GROUP_PAIR_BYTES = 1  # one scene a chunk
        chunked = _build(engine)(pos, mass, **KNOBS[engine])
    finally:
        ttf._GROUP_PAIR_BYTES = old
    assert all(torch.equal(a, b) for a, b in zip(chunked, part))


@pytest.mark.parametrize("engine,refresh", [("bh", 2), ("bh2", 3), ("bh3", 1)])
def test_group_rollout_is_each_scene_alone(engine, refresh, monkeypatch):
    """``simulate`` on a treecode group runs one step loop: the group's
    partition is built once a refresh for every scene at once (never scene
    by scene), and each scene's trajectory equals its run alone (the
    potential energy at the bar of the module notes)."""
    pos, vel, mass = _torch(*_group(n=512, seed=3))
    knobs = KNOBS[engine]
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT, force_backend=engine,
                           bh_near=knobs["n_near"], bh_block=knobs["block"],
                           bh_coarse=knobs.get("coarse", 16), bh_rc=knobs.get("rc", 32),
                           bh_sub_block=knobs.get("sub_block", 32),
                           bh_n_sub=knobs.get("n_sub", 24), bh_refresh=refresh)
    steps = 4
    builds = []
    real = _build(engine)
    monkeypatch.setattr(ttf, f"build_{engine}_partition",
                        lambda p, m, **kw: builds.append(tuple(p.shape)) or real(p, m, **kw))
    group = simulate(pos, vel, mass, steps, cfg)
    # the initial partition and a rebuild at every step i % refresh == 0,
    # i > 0; with refresh 1 a fresh one at every force evaluation
    evals = steps + 1 if refresh == 1 else 1 + len(range(refresh, steps, refresh))
    assert builds == [(S, 512, 3)] * evals
    assert group.positions.shape == (steps, S, 512, 3)
    for s in range(S):
        alone = simulate(pos[s], vel[s], mass[s], steps, cfg)
        for f in ("positions", "velocities", "accelerations", "k_energy"):
            assert torch.equal(getattr(group, f)[:, s], getattr(alone, f)), (s, f)
        np.testing.assert_allclose(group.u_energy[:, s].numpy(), alone.u_energy.numpy(),
                                   rtol=1e-5)


def test_treecode_group_dataset_is_one_rollout(tmp_path, monkeypatch):
    """``generate_dataset`` with scene groups on runs a seed-only treecode
    group as one rollout over (S, N, 3), whose scenes equal the ungrouped
    dataset's."""
    calls = []
    real = tgen.simulate
    monkeypatch.setattr(tgen, "simulate",
                        lambda p, *a, **kw: calls.append(tuple(p.shape)) or real(p, *a, **kw))
    cfgs = [tgen.ScenarioConfig(n_bodies=300, sim_type="spiral", steps=4, seed=s,
                                force_backend="bh", bh_near=4, bh_refresh=2) for s in (1, 2, 3)]
    tgen.generate_dataset(cfgs, str(tmp_path / "v.csv"), verbose=False, vmap_scenes=True,
                          write_csv_file=False, device="cpu")
    assert calls == [(3, 300, 3)]
    tgen.generate_dataset(cfgs, str(tmp_path / "s.csv"), verbose=False, vmap_scenes=False,
                          write_csv_file=False, device="cpu")
    zv, zs = np.load(tmp_path / "v.npz"), np.load(tmp_path / "s.npz")
    for i in range(3):
        for f in ("pos", "vel", "acc", "k", "mass"):
            np.testing.assert_array_equal(zv[f"scene{i}_{f}"], zs[f"scene{i}_{f}"])
        np.testing.assert_allclose(zv[f"scene{i}_u"], zs[f"scene{i}_u"], rtol=1e-5)


@pytest.mark.parametrize("fn,args", [
    (tgen.run_scenario, (tgen.ScenarioConfig(n_bodies=5, steps=2),)),
    (tgen.run_scenario_group, ([tgen.ScenarioConfig(n_bodies=5, steps=2, seed=s)
                                for s in (1, 2)],)),
    (tgen.generate_dataset, ([tgen.ScenarioConfig(n_bodies=5, steps=2)], "unused.csv")),
])
def test_datagen_runs_on_the_card_unless_told(fn, args, monkeypatch):
    """No device named: the CUDA device, and without one an error (no
    quiet CPU run)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args)


# ----------------------------------------------- against jax.vmap of JAX

def _pad_blocks(n, rows):
    return lambda ids: ids >= -(-n // rows)


def _same_sets(got, want, is_pad):
    got, want = np.asarray(got), np.asarray(want)
    same = [set(a[~is_pad(a)].tolist()) == set(b[~is_pad(b)].tolist())
            for a, b in zip(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))]
    return float(np.mean(same))


def _jax_partition(engine, pn, mn):
    return jax.vmap(lambda p, m: JAX_BUILD[engine](p, m, **KNOBS[engine]))(pn, mn)


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_group_partitions_match_vmapped_jax(engine):
    pn, _, mn = _group(n=1000, seed=5)  # 16 blocks of 64, the last part pad
    jpart = _jax_partition(engine, pn, mn)
    tpart = _build(engine)(*_torch(pn, mn), **KNOBS[engine])
    assert tpart._fields == jpart._fields
    for f in ("sorted_gid", "inv_rank"):
        np.testing.assert_array_equal(getattr(tpart, f).numpy(), np.asarray(getattr(jpart, f)))
    block = KNOBS[engine]["block"]
    assert _same_sets(tpart.near, jpart.near, _pad_blocks(1000, block)) >= 0.99
    if engine != "bh":
        coarse = KNOBS[engine]["coarse"]
        assert _same_sets(tpart.refined, jpart.refined,
                          _pad_blocks(1000, block * coarse)) >= 0.99
    if engine == "bh3":
        bs = KNOBS[engine]["sub_block"]
        for f in ("sub_near", "sub_far"):
            assert getattr(tpart, f).shape == np.asarray(getattr(jpart, f)).shape
            assert _same_sets(getattr(tpart, f), getattr(jpart, f), _pad_blocks(1000, bs)) >= 0.99


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
@pytest.mark.parametrize("impl,jax_impl", [("dense", "xla"), ("kernel", "pallas_interpret")])
def test_group_engines_match_vmapped_jax_on_carried_partition(engine, impl, jax_impl):
    """Scenes from seeds 14-16 (``tests/test_torch_treeforce.py``'s seed for
    bh2 and bh3)."""
    pn, _, mn = _group(seed=14)
    jpart = _jax_partition(engine, pn, mn)
    part = ttf.partition_from_numpy({k: np.asarray(v) for k, v in jpart._asdict().items()})
    assert part.near.shape[0] == S and part.n_blocks == N // KNOBS[engine]["block"]
    want = jax.vmap(lambda p, m, jp: JAX_ENGINE[engine](
        p, m, G, EPS, partition=jp, i_chunk=4, near_impl=jax_impl))(pn, mn, jpart)
    got = _engine(engine)(*_torch(pn, mn), G, EPS, partition=part, i_chunk=4, near_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=ATOL[engine])


# ------------------------------------- the scene-axis plain versions

def _tables(rng, s, k):
    com = rng.normal(size=(s, k, 3)).astype(np.float32)
    msum = rng.uniform(1e-4, 1e-3, size=(s, k)).astype(np.float32)
    d = rng.normal(scale=0.1, size=(s, k, 8, 3)).astype(np.float32)
    w = (rng.uniform(size=(s, k, 8)) * 1e-4).astype(np.float32)
    outer = np.einsum("skb,skba,skbc->skac", w, d, d)
    quad = 3 * outer - np.trace(outer, axis1=-2, axis2=-1)[..., None, None] * np.eye(3)
    return ttf._blk_rows(*_torch(com, msum, quad.astype(np.float32)))


def _out_of_range(ids, k):
    """Scene 0's first id -1 and its last k: read as zero rows, never as
    row 0 of scene 1 (k) or the last row of the scene before."""
    ids = ids.clone()
    ids[0, :, 0] = -1
    ids[0, :, -1] = k
    return ids


@pytest.mark.parametrize("kernel", ["b9", "b10", "near"])
def test_scene_axis_plain_versions_are_per_scene_calls(kernel):
    """B9's, B10's and the near list's plain versions on a scene axis equal
    one call a scene, through the wrappers as on the CPU; an id outside its
    scene's range reads as a zero row, not as another scene's."""
    rng = np.random.default_rng(11)
    s, k, groups, p = 3, 20, 4, 33
    q = torch.from_numpy(rng.normal(size=(s, groups, p, 3)).astype(np.float32))
    table = _tables(rng, s, k)
    ids = _out_of_range(torch.from_numpy(rng.integers(0, k, size=(s, groups, 6))
                                         .astype(np.int32)), k)
    if kernel == "b9":
        flat = q.reshape(s, groups * p, 3)
        got = ttf.multipole_acc(flat, table, G, EPS ** 2)
        want = [ttf.multipole_acc(flat[i], table[i], G, EPS ** 2) for i in range(s)]
    elif kernel == "b10":
        got = ttf.grouped_multipole_acc(q, table, ids, G, EPS ** 2)
        want = [ttf.grouped_multipole_acc(q[i], table[i], ids[i], G, EPS ** 2)
                for i in range(s)]
        zeroed = torch.where((ids[0] >= 0) & (ids[0] < k), ids[0], k)
        padded = torch.cat([table[0], torch.zeros(1, 10)])
        assert torch.equal(got[0], ttf.grouped_multipole_acc_torch(q[0], padded, zeroed,
                                                                   G, EPS ** 2))
    else:
        bs, nb = 8, k
        pos = torch.from_numpy(rng.normal(size=(s, nb * bs, 3)).astype(np.float32))
        mass = torch.from_numpy(rng.uniform(1e-4, 1e-3, size=(s, nb * bs)).astype(np.float32))
        got = tpw.near_accelerations(q, pos, mass, ids, bs, G, EPS)
        want = [tpw.near_accelerations(q[i], pos[i], mass[i], ids[i], bs, G, EPS)
                for i in range(s)]
        zeroed = torch.where((ids[0] >= 0) & (ids[0] < nb), ids[0], nb)
        pad_pos = torch.cat([pos[0], torch.zeros(bs, 3)])
        pad_mass = torch.cat([mass[0], torch.zeros(bs)])
        assert torch.equal(got[0], tpw.near_accelerations_torch(
            q[0], pad_pos, pad_mass, zeroed, bs, G, EPS))
    assert all(torch.equal(got[i], w) for i, w in enumerate(want))


# ------------------------------------------------- a batch's Morton graph

@pytest.mark.parametrize("masked,include_self", [(False, False), (True, True)])
def test_batched_morton_graph_is_per_scene_and_matches_jax(masked, include_self):
    """``batched_knn_morton(impl="kernel")`` (one B7 and one B8 launch on the
    card) and the Morton radius search give each scene the ids and validity
    of a call on it alone, and JAX's vmapped Pallas search (interpret mode)
    the ids of ``tests/test_torch_spatial.py``."""
    pn = _group(n=1100, seed=12)[0]
    mask = (np.random.default_rng(1).uniform(size=pn.shape[:2]) < 0.9) if masked else None
    pos = torch.from_numpy(pn)
    tmask = None if mask is None else torch.from_numpy(mask)
    kw = dict(include_self=include_self, block=128, impl="kernel")
    idx, valid = tsp.batched_knn_morton(pos, 8, mask=tmask, **kw)
    ridx, rvalid = tradius.batched_radius_neighbors(pos, 0.5, 16, mask=tmask,
                                                    include_self=include_self,
                                                    method="morton", impl="kernel")
    for s in range(pn.shape[0]):
        ms = None if tmask is None else tmask[s]
        one = tsp.knn_morton(pos[s], 8, mask=ms, **kw)
        assert torch.equal(idx[s], one[0]) and torch.equal(valid[s], one[1])
        rone = tradius.radius_neighbors(pos[s], 0.5, 16, mask=ms, include_self=include_self,
                                        method="morton", impl="kernel")
        assert torch.equal(ridx[s], rone[0]) and torch.equal(rvalid[s], rone[1])
    want = jsp.batched_knn_morton(pn, 8, mask=mask, include_self=include_self, block=128,
                                  impl="pallas_interpret")
    for s in range(pn.shape[0]):
        _assert_same_or_near_tie(pn[s], (idx[s], valid[s]),
                                 (np.asarray(want[0])[s], np.asarray(want[1])[s]))


def _d2(pos, r, ids):
    d = pos[ids].astype(np.float64) - pos[r].astype(np.float64)
    return np.sort((d * d).sum(-1))


def _assert_same_or_near_tie(pos, got, want):
    gi, gv = (t.numpy() for t in got)
    wi, wv = want
    assert gi.shape == wi.shape and gi.dtype == np.int32
    same = (gi == wi).all(1) & (gv == wv).all(1)
    assert same.mean() >= 0.999, same.mean()
    for r in np.nonzero(~same)[0]:
        np.testing.assert_allclose(_d2(pos, r, gi[r][gv[r]]), _d2(pos, r, wi[r][wv[r]]),
                                   rtol=2.0 ** -12)


def test_batched_morton_graph_stacks_copies_scene_major():
    """The batch's candidates are one (B * C, (nb + 2) * block, 4) array,
    scene-major, each copy with its own sentinel blocks; its rows come back
    as (B * N, C * k), scene s in rows s * N ..; more copies than one launch
    takes are refused on the card (the CPU plain version takes any)."""
    pos = torch.from_numpy(_group(s=2, n=700, seed=4)[0])
    order = tsp._curve_order(pos, None, 4)
    assert order.shape == (2, 4, 700)
    cand, qg = tsp._candidates(pos, order, 128)
    one, qg1 = tsp._candidates(pos[1], order[1], 128)
    assert cand.shape == (8, 6 * 128 + 2 * 128, 4)
    assert torch.equal(cand[4:], one) and torch.equal(qg[4:], qg1)
    ids, d2 = tsp.morton_select(cand, 5, 128, False)
    rows, rd2 = tsp._to_rows(qg, ids, d2, 700, scenes=2)
    rows1, rd21 = tsp._to_rows(qg1, ids[4:], d2[4:], 700)
    assert rows.shape == (1400, 20)
    assert torch.equal(rows[700:], rows1) and torch.equal(rd2[700:], rd21)
    assert tsp.MAX_COPIES == 65535
