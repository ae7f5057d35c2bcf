"""The port's ring all-pairs and sharded treecodes (``nbody_tpu_torch/parallel/
ring.py`` and ``bh.py``) against the JAX package's (``nbody_tpu/parallel``),
on the CPU: the port's ranks are 4 gloo processes, started once for the
module (``tests/_parallel_ranks.ring_bh``), 2-rank cases on a (2, 2) mesh;
the JAX side runs in this process on ``make_mesh(2)`` or ``make_mesh(4)`` of
conftest's 8 CPU devices.

Bars, the JAX tests' own (``tests/test_ring.py``, ``tests/test_sharded_bh.py``):

- ring accelerations atol 1e-5 of max |a| (2e-5 for the kernel backend,
  JAX's ``pallas_interpret`` bar), energies 1e-6 relative, rollouts rtol
  1e-4, atol 1e-6 (trajectory energies rtol 1e-5);
- sharded treecodes against the port's single-rank engines: bit for bit,
  as the JAX test holds them where the blocks (bh) or coarse groups (bh2,
  bh3) divide over the devices, and here also where they do not (JAX pads
  its inputs there and allows rtol 1e-4, atol 1e-9; the port cuts the last
  range short, ``parallel/bh.py``); rollouts rtol 1e-5, atol 1e-8;
- against the JAX sharded engines, on the JAX partition carried over: the
  port's engine-parity bar (``tests/test_torch_treeforce.py``), rtol 2e-3
  with atol 5e-9 (bh, bh2) or 2e-8 (bh3), the JAX tests' bar between their
  two near paths, on all but at most 0.1 % of the elements. Those are the
  float32 cancellation at the near/far seam (``ROADMAP.md``, known
  differences): at the JAX sharded tests' knobs (B = 64, M = 6) 1 or 2 of
  5,376-6,144 elements, where the port's single-rank engine differs from
  JAX's single-device one by as much, and both from the float64 direct sum
  by more.
"""

import jax
import numpy as np
import pytest

from _parallel_ranks import ring_bh
from nbody_tpu.core.forces import energies, pairwise_accelerations
from nbody_tpu.ics import generate_spiral
from nbody_tpu.ops import treeforce as jtf
from nbody_tpu.parallel import bh as jbh
from nbody_tpu.parallel.mesh import make_mesh
from nbody_tpu.parallel.ring import ring_accelerations, ring_energies, ring_simulate
from nbody_tpu_torch.parallel.launch import run_ranks

G, EPS = 4.5e-6, 0.05
ATOL = {"bh": 5e-9, "bh2": 5e-9, "bh3": 2e-8}
KNOBS = {"bh": dict(n_near=8, block=128),
         "bh_uneven": dict(n_near=6, block=128),
         "bh2": dict(n_near=6, block=64, coarse=4, rc=4),
         "bh3": dict(n_near=6, block=64, coarse=4, rc=4, sub_block=16, n_sub=12)}
SIM_KNOBS = {"bh": dict(n_near=8, block=128, refresh=4),
             "bh2": dict(n_near=8, block=64, coarse=4, rc=4, refresh=4),
             "bh3": dict(n_near=8, block=64, coarse=4, rc=4, sub_block=16, n_sub=16,
                         refresh=4)}
# name: (engine, JAX-test seed, N, ranks, knobs, drifted partition); the
# sizes and seeds of tests/test_sharded_bh.py
TREE = {
    "bh_even": ("bh", 0, 2048, 2, KNOBS["bh"], False),
    "bh_uneven": ("bh", 1, 1792, 4, KNOBS["bh_uneven"], False),  # 14 blocks over 4
    "bh_reused": ("bh", 2, 2048, 2, KNOBS["bh"], True),
    "bh2_even": ("bh2", 7, 2048, 2, KNOBS["bh2"], False),
    "bh2_uneven": ("bh2", 8, 1792, 4, KNOBS["bh2"], False),  # 7 groups over 4
    "bh2_reused": ("bh2", 9, 2048, 2, KNOBS["bh2"], True),
    "bh3_even": ("bh3", 11, 2048, 2, KNOBS["bh3"], False),
    "bh3_reused": ("bh3", 12, 2048, 2, KNOBS["bh3"], True),
}
SIMS = {"bh": 5, "bh2": 10, "bh3": 13}  # JAX-test seeds of the rollouts


def _system(n, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 3
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    mass = rng.uniform(0.1, 1, n).astype(np.float32)
    return {"pos": pos, "vel": vel, "mass": mass}


def _spiral(n, seed):
    return dict(zip(("pos", "vel", "mass"),
                    (np.array(a) for a in generate_spiral(jax.random.PRNGKey(seed), n))))


RING = {  # name: (N, seed, kind, ranks, backend, extra)
    "acc_dense": (256, 0, "acc", 2, "dense", {}),
    "acc_kernel": (128, 5, "acc", 2, "kernel", {}),
    "acc_kernel_4": (128, 5, "acc", 4, "kernel", {}),
    "acc_dense_4": (256, 0, "acc", 4, "dense", {}),
    "energies": (128, 1, "energies", 2, "dense", {}),
    "energies_4": (128, 1, "energies", 4, "dense", {}),
    "simulate": (64, 2, "simulate", 2, "dense", dict(steps=20, dt=1e-3, traj=False)),
    "simulate_kernel_4": (64, 2, "simulate", 4, "kernel", dict(steps=20, dt=1e-3,
                                                               traj=False)),
    "trajectory": (64, 7, "simulate", 2, "dense", dict(steps=8, dt=1e-3, traj=True)),
}


@pytest.fixture(scope="module")
def port():
    ring_in = {name: {**_system(n, seed), "kind": kind, "ranks": ranks, "backend": be, **x}
               for name, (n, seed, kind, ranks, be, x) in RING.items()}
    tree_in = {}
    for name, (engine, seed, n, ranks, kw, drift) in TREE.items():
        c = {**_spiral(n, seed), "engine": engine, "ranks": ranks, "knobs": kw,
             "drift": drift}
        part = getattr(jtf, f"build_{engine}_partition")(c["pos"], c["mass"], **kw)
        c["jax_partition"] = {k: np.asarray(v) for k, v in part._asdict().items()}
        if name == "bh3_reused":
            c["ignored"] = dict(rc=99, n_sub=99)  # a given partition decides the knobs
        tree_in[name] = c
    for engine in ("bh", "bh2", "bh3"):
        tree_in[f"kernel_{engine}"] = {**_spiral(2048, 20), "engine": engine, "ranks": 2,
                                       "knobs": {**KNOBS[engine], "near_impl": "kernel"}}
        tree_in[f"sim_{engine}"] = {**_spiral(2048, SIMS[engine]), "engine": engine,
                                    "ranks": 2, "kind": "simulate", "steps": 10,
                                    "knobs": {**SIM_KNOBS[engine], "near_impl": "dense"}}
    out = run_ranks(ring_bh, 4, "gloo", {"ring": ring_in, "tree": tree_in}, device="cpu",
                    timeout=300)
    return {"out": out, "ring": ring_in, "tree": tree_in}


def _scaled_close(got, want, atol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# ------------------------------------------------------------------ ring

@pytest.mark.parametrize("name", ["acc_dense", "acc_kernel", "acc_kernel_4", "acc_dense_4"])
def test_ring_accelerations_match_jax(port, name):
    c = port["ring"][name]
    mesh = make_mesh(c["ranks"])
    jax_backend = "pallas_interpret" if c["backend"] == "kernel" else "dense"
    want = np.asarray(ring_accelerations(c["pos"], c["mass"], G, EPS, mesh,
                                         backend=jax_backend))
    atol = 2e-5 if c["backend"] == "kernel" else 1e-5
    got = port["out"][name]
    _scaled_close(got, want, atol)
    _scaled_close(got, np.asarray(pairwise_accelerations(c["pos"], c["mass"], G, EPS)), atol)


@pytest.mark.parametrize("name", ["energies", "energies_4"])
def test_ring_energies_match_jax(port, name):
    c = port["ring"][name]
    u_r, k_r = ring_energies(c["pos"], c["vel"], c["mass"], G, EPS, make_mesh(c["ranks"]))
    u, k = energies(c["pos"], c["vel"], c["mass"], G, EPS)
    got_u, got_k = port["out"][name]
    for want_u, want_k in ((float(u_r), float(k_r)), (float(u), float(k))):
        assert abs(got_u - want_u) < 1e-6 * abs(want_u)
        assert abs(got_k - want_k) < 1e-6 * abs(want_k)


@pytest.mark.parametrize("name", ["simulate", "simulate_kernel_4"])
def test_ring_simulate_matches_jax(port, name):
    c = port["ring"][name]
    (p, v, _), _ = ring_simulate(c["pos"], c["vel"], c["mass"], c["steps"], G, EPS, c["dt"],
                                 make_mesh(c["ranks"]))
    got = port["out"][name]
    np.testing.assert_allclose(got["pos"], np.asarray(p), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["vel"], np.asarray(v), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["pos"], got["single_pos"], rtol=1e-4, atol=1e-6)


def test_ring_trajectory_and_energies_match_jax(port):
    c = port["ring"]["trajectory"]
    (ps, _, _), (us, ks) = ring_simulate(c["pos"], c["vel"], c["mass"], c["steps"], G, EPS,
                                         c["dt"], make_mesh(2), calc_energy=True,
                                         return_trajectory=True)
    got = port["out"]["trajectory"]
    assert got["pos"].shape == (8, 64, 3) and got["u"].shape == (8,)
    np.testing.assert_allclose(got["pos"], np.asarray(ps), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["u"], np.asarray(us), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(got["k"], np.asarray(ks), rtol=1e-5, atol=1e-12)


# -------------------------------------------------------------- treecodes

@pytest.mark.parametrize("name", list(TREE))
def test_sharded_treecode_matches_the_single_rank_engine(port, name):
    res = port["out"][name]
    pairs = [("carried", "carried_single")]
    if "sharded" in res:
        pairs.append(("sharded", "single"))
    for got, want in pairs:
        # every row over the single-rank engine's block tables: its bits,
        # also where the blocks do not divide over the ranks
        np.testing.assert_array_equal(res[got], res[want])


@pytest.mark.parametrize("name", list(TREE))
def test_sharded_treecode_matches_jax_on_its_partition(port, name):
    c = port["tree"][name]
    engine = c["engine"]
    part_cls = {"bh": jtf.BHPartition, "bh2": jtf.BH2Partition, "bh3": jtf.BH3Partition}
    part = part_cls[engine](**c["jax_partition"])
    q = c["pos"] + c["vel"] * 1e-3 if c["drift"] else c["pos"]
    want = getattr(jbh, f"sharded_{engine}_accelerations")(
        q, c["mass"], G, EPS, make_mesh(c["ranks"]), partition=part, near_impl="xla")
    got, want = port["out"][name]["carried"], np.asarray(want)
    over = np.abs(got - want) > ATOL[engine] + 2e-3 * np.abs(want)
    assert over.mean() <= 1e-3, f"{over.sum()} of {over.size} elements over the bar"


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_kernel_near_impl_keeps_the_single_rank_bits(port, engine):
    """The card's path (B1's near list, B9, B10 on a rank's range), here
    through their plain versions: 16 blocks (8 groups) over 2 ranks."""
    res = port["out"][f"kernel_{engine}"]
    np.testing.assert_array_equal(res["sharded"], res["single"])


@pytest.mark.parametrize("engine", ["bh", "bh2", "bh3"])
def test_treecode_simulate_matches_jax_and_single_rank(port, engine):
    c = port["tree"][f"sim_{engine}"]
    kw = {k: v for k, v in c["knobs"].items() if k != "near_impl"}
    p, v, _ = getattr(jbh, f"{engine}_simulate")(c["pos"], c["vel"], c["mass"], 10, G, EPS,
                                                  1e-4, make_mesh(2), near_impl="xla", **kw)
    got = port["out"][f"sim_{engine}"]
    for want_p, want_v in ((np.asarray(p), np.asarray(v)),
                           (got["single_pos"], got["single_vel"])):
        np.testing.assert_allclose(got["pos"], want_p, rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(got["vel"], want_v, rtol=1e-5, atol=1e-8)
