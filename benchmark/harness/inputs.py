"""Inputs drawn from ``--seed``: spiral galaxies (a frozen NumPy copy of the
system's spiral generator, reference ``galaxify/galaxies.py``) and their
softened accelerations by a sampled direct sum, written as the npz dataset
schema the trainer reads."""

from __future__ import annotations

import math
import os

import numpy as np
import torch


def spiral(seed, n, total_mass=1.0, radial_scale=3.0, height_scale=0.3, g=4.5e-6,
           black_hole_mass=0.01, n_arms=2, pitch_angle=-math.pi / 6, arm_strength=0.3):
    """(pos (N, 3), vel (N, 3), mass (N,)) float32 of a spiral galaxy with a
    central black hole as body 0: radii ~ Gamma(2, radial_scale), an arm
    perturbation of the angle, gaussian heights, circular velocities of the
    exponential disk's enclosed mass with dispersions (0.1, 0.07, 0.05)
    v_circ, equal star masses. ``seed`` is any non-negative integer or a
    sequence of them."""
    rng = np.random.default_rng(seed)
    r = rng.gamma(2.0, 1.0, n) * radial_scale
    phi = rng.uniform(0.0, 2 * math.pi, n)
    z = rng.standard_normal(n) * height_scale
    safe_r = np.maximum(r, 1e-30)
    phi_s = phi + arm_strength * np.sin(
        n_arms * (phi - np.log(safe_r / radial_scale) / math.tan(pitch_angle)))
    pos = np.stack([r * np.cos(phi_s), r * np.sin(phi_s), z], axis=1)
    x = r / radial_scale
    m_enc = total_mass * (1.0 - np.exp(-x) * (1.0 + x))
    v_circ = np.sqrt(g * m_enc / safe_r)
    v_r = rng.standard_normal(n) * 0.1 * v_circ
    v_phi = v_circ + rng.standard_normal(n) * 0.07 * v_circ
    v_z = rng.standard_normal(n) * 0.05 * v_circ
    vel = np.stack([v_r * np.cos(phi_s) - v_phi * np.sin(phi_s),
                    v_r * np.sin(phi_s) + v_phi * np.cos(phi_s), v_z], axis=1)
    mass = np.full(n, (total_mass * (1.0 - black_hole_mass)) / max(n - 1, 1))
    mass[0] = total_mass * black_hole_mass
    pos[0] = 0.0
    vel[0] = 0.0
    return pos.astype(np.float32), vel.astype(np.float32), mass.astype(np.float32)


def galaxy(seed, index, n, cfg):
    """Galaxy ``index`` of a run with this seed, with the configuration's
    galaxy parameters (``cfg["galaxy"]``)."""
    return spiral([int(seed), int(index)], n, g=cfg["g"], **cfg["galaxy"])


def sampled_accelerations(pos, mass, g, softening, sources, seed, device, block=4096):
    """(N, 3) float32 softened accelerations G sum_j m_j d / (d^2 + eps^2)^1.5
    over a seeded sample of ``sources`` stars, their masses scaled by (stars
    / sources), plus the black hole (body 0) exactly; in plain torch, in
    blocks of receivers. ``seed`` is a sequence of non-negative integers."""
    n = pos.shape[0]
    rng = np.random.default_rng([*seed, 7])
    stars = n - 1
    pick = 1 + rng.choice(stars, size=min(sources, stars), replace=False)
    src = np.concatenate([[0], pick])
    p = torch.from_numpy(pos).to(device)
    sp = p[torch.from_numpy(src).to(device)]
    sm = torch.from_numpy(mass[src].astype(np.float64)).to(device)
    sm[1:] *= stars / len(pick)
    sm = sm.float()
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    eps2 = softening * softening
    for r0 in range(0, n, block):
        d = sp[None, :, :] - p[r0:r0 + block, None, :]
        inv = torch.rsqrt((d * d).sum(-1) + eps2)
        out[r0:r0 + block] = g * ((sm * inv * inv * inv)[..., None] * d).sum(1)
    return out.cpu().numpy()


def write_snapshots(path, seed, n, count, cfg, sources, device):
    """``count`` snapshots, each its own galaxy, with their sampled targets,
    as one scene of ``count`` steps in the npz schema the trainer reads
    (``n_scenes``, ``scene0_pos`` / ``vel`` / ``acc`` (steps, N, 3),
    ``scene0_mass`` (N,)); ``mass`` is that of the first galaxy, which every
    draw shares."""
    pos, vel, acc = [], [], []
    for i in range(count):
        p, v, m = galaxy(seed, i, n, cfg)
        pos.append(p)
        vel.append(v)
        acc.append(sampled_accelerations(p, m, cfg["g"], cfg["softening"], sources,
                                         [int(seed), i], device))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, n_scenes=np.int64(1), scene0_pos=np.stack(pos), scene0_vel=np.stack(vel),
             scene0_acc=np.stack(acc), scene0_mass=m)
