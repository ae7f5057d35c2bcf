"""Trajectory dataset generation — the port of ``nbody_tpu/data/generate.py``
(reference ``src/s01-dataset-generation.py``).

Each scene's initial conditions are drawn on the CPU from a seeded
``torch.Generator`` (so a seed gives the same galaxy on every device), the
rollout runs on the requested device through ``core.simulate``, and the
trajectory comes back to the host once. Consecutive scenes that differ only
by seed run as one group: one rollout over a leading scene axis, whose
kernels (the direct sum's, or a treecode's) launch once a step for the
whole group. Every function runs on the CUDA device unless the caller names
another (``device="cpu"``), and raises without one. The long-format
CSV has the columns of ``data.schema.CSV_FIELDS`` and is written by the
native writer of ``data.io_native`` (the JAX package's bytes); the ``.npz``
twin has the JAX package's keys, so datasets written by either package load
in the other.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import zipfile
from typing import List, Optional, Sequence

import numpy as np
import torch

from nbody_tpu_torch.core.simulate import (TREECODE_BACKENDS, SimulationConfig,
                                           Trajectory, resolve_backend, simulate)
from nbody_tpu_torch.data.schema import CSV_FIELDS
from nbody_tpu_torch.utils.device import resolve_device
from nbody_tpu_torch.ics import GENERATORS
from nbody_tpu_torch.utils.timing import device_time


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One simulated scene — the unit of the CLI's cartesian fan-out.
    Defaults match the reference CLI."""

    n_bodies: int = 100
    integrator: str = "leapfrog"
    sim_type: str = "disk"  # "disk" | "spiral"
    steps: int = 100
    dt: float = 1e-4
    softening: float = 0.05
    g: float = 4.5e-6
    total_mass: float = 1.0
    radial_scale: float = 3.0
    height_scale: float = 0.3
    black_hole_mass: float = 0.01
    n_arms: int = 2
    pitch_angle: float = -math.pi / 6
    arm_strength: float = 0.3
    seed: Optional[int] = None
    force_backend: str = "auto"  # "auto" | "dense" | "kernel" | "bh" | "bh2" | "bh3"
    # treecode ground-truth knobs (core.simulate.SimulationConfig): exact
    # near-set size and partition refresh interval
    bh_near: int = 32
    bh_refresh: int = 1
    # exact O(N^2) pairwise PE per recorded step; large-N training sets,
    # which never read the u/k columns, switch it off
    calc_energy: bool = True


def scenario_product(**kwargs) -> List[ScenarioConfig]:
    """Cartesian product over list-valued parameters."""
    params = {k: v if isinstance(v, (list, tuple)) else [v]
              for k, v in kwargs.items()}
    keys = list(params)
    return [ScenarioConfig(**dict(zip(keys, combo)))
            for combo in itertools.product(*(params[k] for k in keys))]


def scenario_generator(cfg: ScenarioConfig) -> torch.Generator:
    """Per-scene CPU generator seeded from the seed alone, so the same seed
    reproduces the same galaxy for identical parameters (the reference
    reseeds inside every generator call); fresh entropy when seed is None."""
    gen = torch.Generator()
    if cfg.seed is None:
        gen.seed()
    else:
        gen.manual_seed(cfg.seed)
    return gen


def make_initial_conditions(cfg: ScenarioConfig, generator=None, device=None):
    """Dispatch to the galaxy generator of this scene."""
    if generator is None:
        generator = scenario_generator(cfg)
    common = dict(
        n_bodies=cfg.n_bodies,
        total_mass=cfg.total_mass,
        radial_scale=cfg.radial_scale,
        height_scale=cfg.height_scale,
        g_const=cfg.g,
        black_hole_mass=cfg.black_hole_mass,
        device=device,
    )
    if cfg.sim_type == "disk":
        return GENERATORS["disk"](generator, **common)
    if cfg.sim_type == "spiral":
        return GENERATORS["spiral"](
            generator, **common, n_arms=cfg.n_arms,
            pitch_angle=cfg.pitch_angle, arm_strength=cfg.arm_strength)
    raise ValueError(f"unknown sim_type {cfg.sim_type!r}")


def simulation_config(cfg: ScenarioConfig) -> SimulationConfig:
    return SimulationConfig(
        g_const=cfg.g, softening=cfg.softening, dt=cfg.dt,
        integrator=cfg.integrator, calc_energy=cfg.calc_energy,
        force_backend=cfg.force_backend, bh_near=cfg.bh_near,
        bh_refresh=cfg.bh_refresh)


def _load_kernels(sim_cfg: SimulationConfig, device: torch.device) -> None:
    """Build the rollout's kernels now: a first-use build must not count as
    step time."""
    backend = resolve_backend(sim_cfg, device)
    if device.type == "cuda" and backend != "dense":
        if backend in TREECODE_BACKENDS:
            from nbody_tpu_torch.ops.treeforce import load_kernels
        else:
            from nbody_tpu_torch.ops.pairwise import load_kernels
        load_kernels()


def run_scenario(cfg: ScenarioConfig, generator=None, time_chunks: int = 1,
                 device=None):
    """ICs and the full rollout on ``device`` (default: the CUDA device;
    raises without one). Returns (trajectory on ``device``, masses as numpy,
    step_time in seconds): a scalar mean by default, or a per-step array
    when ``time_chunks > 1`` (the rollout then runs as that many
    sequentially timed segments)."""
    device = resolve_device(device)
    pos, vel, mass = make_initial_conditions(cfg, generator, device=device)
    sim_cfg = simulation_config(cfg)
    _load_kernels(sim_cfg, device)

    bounds = np.linspace(0, cfg.steps, max(time_chunks, 1) + 1).astype(int)
    parts, times = [], np.zeros(cfg.steps)
    p, v = pos, vel
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi == lo:
            continue
        part, elapsed = device_time(
            lambda p=p, v=v, n=int(hi - lo): simulate(p, v, mass, n, sim_cfg),
            device)
        parts.append(part)
        times[lo:hi] = elapsed / (hi - lo)
        p, v = part.positions[-1], part.velocities[-1]
    if len(parts) == 1:
        traj = parts[0]
    else:
        traj = Trajectory(*(
            None if parts[0][i] is None else torch.cat([pt[i] for pt in parts])
            for i in range(5)))
    step_time = float(times.mean()) if time_chunks <= 1 else times
    return traj, mass.cpu().numpy(), step_time


def run_scenario_group(cfgs: Sequence[ScenarioConfig], device=None):
    """Run scenarios that share every parameter but the seed as ONE rollout
    over a leading scene axis (``jax.vmap`` in the JAX package) on
    ``device`` (default: the CUDA device; raises without one): each scene's
    ICs from its own generator (so they equal its ungrouped ICs), stacked,
    then one step loop whose kernels launch once a step for the whole
    group: B1 and B2 for the direct sum, or for a treecode (``bh``, ``bh2``,
    ``bh3``) one partition of the group, rebuilt for every scene at once,
    and B9, B10 and B1's near list once a force evaluation. Each scene gets
    the bits of its own :func:`run_scenario`.

    :return: list of (trajectory, masses, step_time) like
        :func:`run_scenario`; step_time is the group's rollout time over
        ``steps * len(cfgs)``.
    """
    base = cfgs[0]
    assert all(dataclasses.replace(c, seed=base.seed) == base for c in cfgs), \
        "group must differ only by seed"
    device = resolve_device(device)
    ics = [make_initial_conditions(c, device=device) for c in cfgs]
    pos, vel, mass = (torch.stack(x) for x in zip(*ics))
    sim_cfg = simulation_config(base)
    _load_kernels(sim_cfg, device)
    traj, elapsed = device_time(lambda: simulate(pos, vel, mass, base.steps, sim_cfg), device)
    step_time = elapsed / (base.steps * len(cfgs))
    masses = mass.cpu().numpy()
    return [(Trajectory(*(None if x is None else x[:, i] for x in traj)), masses[i], step_time)
            for i in range(len(cfgs))]


def _group_scenarios(scenarios: Sequence[ScenarioConfig]):
    """Consecutive runs of scenarios identical up to the seed, as lists of
    (scene id, config)."""
    groups = []
    for scene_id, cfg in enumerate(scenarios):
        if groups and dataclasses.replace(cfg, seed=groups[-1][0][1].seed) == groups[-1][0][1]:
            groups[-1].append((scene_id, cfg))
        else:
            groups.append([(scene_id, cfg)])
    return groups


def _energy_col(x, s: int) -> np.ndarray:
    """Energy column as (s,) numpy; NaN-filled when not computed."""
    return np.full(s, np.nan, np.float32) if x is None else _np(x)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def trajectory_to_rows(scene_id: int, cfg: ScenarioConfig, traj: Trajectory,
                       mass: np.ndarray, step_time, step_idx=None):
    """Long-format table of one scene: steps x n_bodies rows in the
    reference column order, as a dict of numpy columns.

    :param step_idx: recorded step numbers (default ``arange``; strided
        datasets pass the original indices)."""
    s, n = int(traj.positions.shape[0]), cfg.n_bodies
    if step_idx is None:
        step_idx = np.arange(s)
    p = _np(traj.positions).reshape(s * n, 3)
    v = _np(traj.velocities).reshape(s * n, 3)
    a = _np(traj.accelerations).reshape(s * n, 3)
    st = (np.repeat(np.asarray(step_time, np.float64), n) if np.ndim(step_time)
          else np.full(s * n, step_time, np.float64))
    return {
        "scene": np.full(s * n, scene_id, np.int64),
        "scene_type": np.full(s * n, cfg.sim_type, object),
        "step": np.repeat(np.asarray(step_idx), n),
        "step_time": st,
        "mass": np.tile(mass, s),
        "x": p[:, 0], "y": p[:, 1], "z": p[:, 2],
        "vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2],
        "ax": a[:, 0], "ay": a[:, 1], "az": a[:, 2],
        "u": np.repeat(_energy_col(traj.u_energy, s), n),
        "k": np.repeat(_energy_col(traj.k_energy, s), n),
    }


def generate_dataset(
    scenarios: Sequence[ScenarioConfig],
    output: str,
    write_npz: bool = True,
    verbose: bool = True,
    vmap_scenes: bool = True,
    time_chunks: int = 1,
    check: bool = False,
    snapshot_stride: int = 1,
    write_csv_file: bool = True,
    device=None,
) -> None:
    """Run every scenario on ``device`` (default: the CUDA device; raises
    without one) and write one long-format CSV plus an ``.npz`` twin (same
    stem) for fast reload by ``data.dataset``.

    :param vmap_scenes: run each group of consecutive seed-only-differing
        scenarios as one rollout (:func:`run_scenario_group`); the JAX
        package's name for it.
    :param time_chunks: >1 records per-chunk wall times in ``step_time``
        instead of the uniform mean (see :func:`run_scenario`); turns
        grouping off (chunked timing needs a rollout a scene).
    :param check: raise on a non-finite trajectory instead of writing it.
    :param snapshot_stride: record every this-many-th step (always incl.
        step 0; the ``step`` column keeps original indices).
    :param write_csv_file: False writes only the npz."""
    import pandas as pd

    from nbody_tpu_torch.data.io_native import write_csv

    if time_chunks > 1:
        vmap_scenes = False
    device = resolve_device(device)

    results = {}
    if vmap_scenes:
        for group in _group_scenarios(scenarios):
            ids = [sid for sid, _ in group]
            cfgs = [c for _, c in group]
            if verbose:
                print(f"[scenes {ids[0]}..{ids[-1]}] {cfgs[0].sim_type} "
                      f"n={cfgs[0].n_bodies} steps={cfgs[0].steps} x{len(cfgs)}")
            runs = ([run_scenario(cfgs[0], device=device)] if len(cfgs) == 1
                    else run_scenario_group(cfgs, device=device))
            for sid, (traj, mass, step_time) in zip(ids, runs):  # the device holds one group
                results[sid] = (Trajectory(*(None if x is None else x.cpu() for x in traj)),
                                mass, step_time)

    frames, npz_payload = [], {}
    for scene_id, cfg in enumerate(scenarios):
        if scene_id in results:
            traj, mass, step_time = results.pop(scene_id)
        else:
            if verbose:
                print(f"[{scene_id + 1}/{len(scenarios)}] {cfg.sim_type} "
                      f"n={cfg.n_bodies} steps={cfg.steps} "
                      f"integrator={cfg.integrator} seed={cfg.seed}")
            traj, mass, step_time = run_scenario(cfg, time_chunks=time_chunks,
                                                 device=device)
        if check:
            for name, t in zip(("positions", "velocities", "accelerations"),
                               traj[:3]):
                if not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(
                        f"non-finite values in scene {scene_id} {name}")
        step_idx = np.arange(int(traj.positions.shape[0]))
        if snapshot_stride > 1:
            step_idx = step_idx[::snapshot_stride]
            traj = Trajectory(*(None if x is None else x[::snapshot_stride]
                                for x in traj))
            if np.ndim(step_time):
                step_time = np.asarray(step_time)[::snapshot_stride]
        traj = Trajectory(*(None if x is None else _np(x) for x in traj))
        if write_csv_file:
            frames.append(pd.DataFrame(trajectory_to_rows(
                scene_id, cfg, traj, mass, step_time, step_idx)))
        n_snap = int(traj.positions.shape[0])
        npz_payload[f"scene{scene_id}_pos"] = traj.positions
        npz_payload[f"scene{scene_id}_vel"] = traj.velocities
        npz_payload[f"scene{scene_id}_acc"] = traj.accelerations
        npz_payload[f"scene{scene_id}_mass"] = mass
        npz_payload[f"scene{scene_id}_u"] = _energy_col(traj.u_energy, n_snap)
        npz_payload[f"scene{scene_id}_k"] = _energy_col(traj.k_energy, n_snap)
        npz_payload[f"scene{scene_id}_step"] = step_idx.astype(np.int32)
        npz_payload[f"scene{scene_id}_meta"] = np.array(
            [scene_id, cfg.steps, cfg.n_bodies, float(np.mean(step_time))],
            np.float64)
        if np.ndim(step_time):
            npz_payload[f"scene{scene_id}_step_time"] = np.asarray(step_time)
        npz_payload[f"scene{scene_id}_type"] = np.array(cfg.sim_type)

    if write_csv_file:
        write_csv(pd.concat(frames, ignore_index=True)[CSV_FIELDS], output)
    if write_npz:
        save_npz_atomic(_npz_path(output), n_scenes=len(scenarios), **npz_payload)


def _npz_path(csv_path: str) -> str:
    return csv_path[:-4] + ".npz" if csv_path.endswith(".csv") else csv_path + ".npz"


def save_npz_atomic(path: str, **payload) -> None:
    """``np.savez_compressed`` through a temp file and ``os.replace``, so a
    kill mid-write never leaves a truncated file at ``path``."""
    # np.savez appends ".npz" to names lacking it, so the temp name must
    # already end in ".npz" to land where os.replace expects it.
    tmp = path + ".tmp.npz"
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def valid_npz(path: str) -> bool:
    """True iff ``path`` exists and is a structurally complete zip/npz (its
    end-of-central-directory record, which a truncated write lacks)."""
    if not os.path.exists(path):
        return False
    try:
        with zipfile.ZipFile(path) as z:
            return len(z.namelist()) > 0
    except (zipfile.BadZipFile, OSError):
        return False
