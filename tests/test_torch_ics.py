"""Port initial-condition generators: the checks of tests/test_ics.py on the
port, plus distributional agreement with the JAX generators (the two draw
from different random streams, so only distributions can agree)."""

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.ics import generate_disk as jgenerate_disk
from nbody_tpu.ics import generate_spiral as jgenerate_spiral
from nbody_tpu.ics.disk import enclosed_mass as jenclosed_mass
from nbody_tpu.ics.profiles import spherical_hernquist_distribution as jhernquist
from nbody_tpu_torch.ics import compose, generate_disk, generate_spiral
from nbody_tpu_torch.ics.disk import enclosed_mass
from nbody_tpu_torch.ics.profiles import spherical_hernquist_distribution

G = 4.5e-6


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_hernquist_profile_values():
    r = np.array([0.5, 1.0, 2.0], np.float32)
    got = spherical_hernquist_distribution(torch.from_numpy(r)).numpy()
    want = (1.0 / (2 * np.pi)) * (1.0 / (r * (1.0 + r) ** 3))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jhernquist(r)), rtol=1e-6)
    at_zero = float(spherical_hernquist_distribution(torch.zeros(1))[0])
    assert np.isfinite(at_zero) and at_zero > 0


def test_enclosed_mass_matches_loop_and_jax():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 5, 64).astype(np.float32)
    d[5] = d[9]  # tie
    m = rng.uniform(0.1, 1, 64).astype(np.float32)
    got = enclosed_mass(torch.from_numpy(d), torch.from_numpy(m)).numpy()
    want = np.array([m[d < d[i]].sum() for i in range(64)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jenclosed_mass(d, m)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gen", [generate_disk, generate_spiral])
def test_generator_invariants(gen):
    n, total = 500, 1.0
    pos, vel, mass = gen(_gen(0), n, total_mass=total, black_hole_mass=0.01, g_const=G)
    assert pos.shape == (n, 3) and vel.shape == (n, 3) and mass.shape == (n,)
    assert pos.dtype == vel.dtype == mass.dtype == torch.float32
    np.testing.assert_allclose(pos[0].numpy(), 0.0, atol=1e-7)
    np.testing.assert_allclose(vel[0].numpy(), 0.0, atol=1e-7)
    assert abs(float(mass[0]) - 0.01 * total) < 1e-7
    assert abs(float(mass.sum()) - total) < 1e-5
    assert bool((mass > 0).all())
    assert all(bool(torch.isfinite(t).all()) for t in (pos, vel, mass))


@pytest.mark.parametrize("gen", [generate_disk, generate_spiral])
def test_same_seed_same_galaxy(gen):
    a = gen(_gen(3), 64)
    b = gen(_gen(3), 64)
    c = gen(_gen(4), 64)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_disk_velocities_are_circular():
    n = 200
    pos, vel, mass = (t.numpy() for t in generate_disk(
        _gen(1), n, total_mass=1.0, radial_scale=3.0, height_scale=0.3,
        g_const=G, black_hole_mass=0.01))
    r_xy = np.linalg.norm(pos[1:, :2], axis=1)
    speed = np.linalg.norm(vel[1:], axis=1)
    m_enc = np.array([mass[np.linalg.norm(pos[:, :2], axis=1) < r].sum() for r in r_xy])
    np.testing.assert_allclose(speed, np.sqrt(G * m_enc / r_xy), rtol=1e-3)
    dots = np.abs((vel[1:, :2] * pos[1:, :2]).sum(1))
    assert np.all(dots < 1e-6 + 1e-4 * speed * r_xy)
    np.testing.assert_allclose(vel[:, 2], 0.0, atol=1e-7)


def test_disk_rotation_and_offset():
    angle, off, ivel = (0.3, -0.2, 1.0), (5.0, -1.0, 2.0), (0.1, 0.2, -0.3)
    p0, v0, _ = generate_disk(_gen(2), 64, angle=(0, 0, 0))
    p1, v1, _ = generate_disk(_gen(2), 64, angle=angle, offset=off, initial_vel=ivel)
    ax, ay, az = angle
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    np.testing.assert_allclose(p1.numpy(), p0.numpy() @ rx.T @ ry.T @ rz.T + np.array(off),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v1.numpy(), v0.numpy() @ rx.T @ ry.T @ rz.T + np.array(ivel),
                               rtol=1e-4, atol=1e-5)


def test_spiral_velocity_magnitude_tracks_vcirc():
    pos, vel, _ = (t.numpy() for t in generate_spiral(
        _gen(3), 2000, total_mass=1.0, radial_scale=3.0, height_scale=0.3,
        g_const=G, black_hole_mass=0.01))
    r = np.linalg.norm(pos[1:, :2], axis=1)
    v_circ = np.sqrt(G * (1 - np.exp(-r / 3.0) * (1 + r / 3.0)) / r)
    ratio = np.linalg.norm(vel[1:, :2], axis=1) / v_circ
    assert 0.95 < ratio.mean() < 1.05
    assert ratio.std() < 0.25


def test_radial_distributions_match_jax():
    """Disk radii ~ Exp(Rd) (mean Rd); spiral radii ~ Gamma(2, Rd) (mean
    2 Rd, variance 2 Rd^2), drawn in the port as two exponentials. Both
    packages' samples agree in mean and spread."""
    n, rs = 5000, 2.0
    pd_, _, _ = generate_disk(_gen(4), n, radial_scale=rs)
    jd, _, _ = jgenerate_disk(jax.random.PRNGKey(4), n, radial_scale=rs)
    r_t = np.linalg.norm(pd_.numpy()[1:, :2], axis=1)
    r_j = np.linalg.norm(np.asarray(jd)[1:, :2], axis=1)
    assert abs(r_t.mean() - rs) < 0.1 * rs
    assert abs(r_t.mean() - r_j.mean()) < 0.1 * rs

    ps, _, _ = generate_spiral(_gen(5), n, radial_scale=rs)
    js, _, _ = jgenerate_spiral(jax.random.PRNGKey(5), n, radial_scale=rs)
    r_t = np.linalg.norm(ps.numpy()[1:, :2], axis=1)
    r_j = np.linalg.norm(np.asarray(js)[1:, :2], axis=1)
    assert abs(r_t.mean() - 2 * rs) < 0.05 * 2 * rs
    assert abs(r_t.std() - np.sqrt(2) * rs) < 0.1 * np.sqrt(2) * rs
    assert abs(r_t.mean() - r_j.mean()) < 0.075 * 2 * rs  # ~5 sigma of the difference
    z_t, z_j = ps.numpy()[1:, 2], np.asarray(js)[1:, 2]
    assert abs(z_t.std() - z_j.std()) < 0.05 * 0.3


def test_compose_concatenates():
    a = generate_disk(_gen(1), 10, offset=(-10, 0, 0))
    b = generate_spiral(_gen(2), 6)
    pos, vel, mass = compose(a, b)
    assert pos.shape == (16, 3) and vel.shape == (16, 3) and mass.shape == (16,)
    assert torch.equal(pos[10:], b[0])
    with pytest.raises(ValueError):
        compose()
