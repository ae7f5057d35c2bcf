"""Results visualization — the port of ``nbody_tpu/experiments/visualize.py``
(a script rebuild of the reference ``results_visualization.ipynb``, 9
cells): renders the four figures from the results CSVs that the port's
experiments write (the JAX package's schemas) into ``figures/``:

- ``loss.png``           loss-vs-epoch curves, / scale_factor (cell 2)
- ``stepwise_loss.png``  per-scene 1-step loss bars (cells 3-4)
- ``stepwise_time.png``  per-scene surrogate step-time bars vs the classical
                         leapfrog step time read from the test CSVs (cell 5)
- ``rollout.png``        grid of pos/vel/acc RMSE rollout curves (cells 6-7)

and, where crossover artifacts exist, ``crossover.png``: the port's
``crossover`` JSON adds ``device_kind``, and each series is drawn per
device, so rows taken on different devices never join one line.

Usage: python -m nbody_tpu_torch.experiments.visualize --base <dir with results/>
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd

SCALE = 1e6  # training scale factor undone for plotting (notebook cell 2)


def _load(base, name, fname):
    p = os.path.join(base, "results", name, fname)
    return pd.read_csv(p) if os.path.exists(p) else None


def _scene_n_bodies(base):
    """n_bodies and classical step_time per (test file, scene), from the test
    CSVs (notebook cell 3 reads the ground-truth step_time the same way).

    Keyed by (filename, scene) — scene ids restart at 0 in every file, so a
    scene-only key would silently overwrite across multi-file test dirs.

    The mapping is persisted to ``results/scene_info.json`` (a committed
    artifact) whenever the test CSVs are readable, and read back from there
    when they are not — the raw ``data/`` dir is gitignored, so a fresh
    checkout must still be able to regenerate correctly-labelled figures."""
    import json

    sidecar = os.path.join(base, "results", "scene_info.json")
    out = {}
    for f in sorted(glob(os.path.join(base, "data", "test", "*.csv"))):
        fname = os.path.basename(f)
        df = pd.read_csv(f, usecols=["scene", "step", "step_time"])
        head = df[df["step"] == 0]
        sizes = head.groupby("scene").size()
        times = df.groupby("scene")["step_time"].mean()
        for scene, n in sizes.items():
            out[(fname, int(scene))] = (int(n), float(times.loc[scene]))
    if out:
        # merge with any committed sidecar: a partially-regenerated
        # data/test dir must not truncate the mapping for files it lacks
        if os.path.exists(sidecar):
            with open(sidecar) as fh:
                for row in json.load(fh):
                    out.setdefault(
                        (row["filename"], int(row["scene"])),
                        (int(row["n_bodies"]), float(row["step_time"])))
        os.makedirs(os.path.dirname(sidecar), exist_ok=True)
        with open(sidecar, "w") as fh:
            json.dump(
                [
                    {"filename": k[0], "scene": k[1], "n_bodies": v[0],
                     "step_time": v[1]}
                    for k, v in sorted(out.items())
                ],
                fh, indent=1,
            )
    elif os.path.exists(sidecar):
        with open(sidecar) as fh:
            for row in json.load(fh):
                out[(row["filename"], int(row["scene"]))] = (
                    int(row["n_bodies"]), float(row["step_time"]))
    return out


def plot_loss(base, names, outdir):
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name in names:
        df = _load(base, name, "epoch_loss.csv")
        if df is None:
            continue
        ax.plot(np.arange(1, len(df) + 1), df["loss"] / SCALE, label=name)
    ax.set_xlabel("epoch")
    ax.set_ylabel("train RMSE (raw acc units)")
    ax.set_yscale("log")
    ax.legend()
    ax.set_title("Training loss")
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "loss.png"), dpi=120)
    plt.close(fig)


def plot_stepwise(base, names, outdir):
    scene_info = _scene_n_bodies(base)
    # x-axis = the (filename, scene) rows of the first available stepwise
    # table, so multi-file test dirs label every bar correctly.
    keys = None
    for name in names:
        df = _load(base, name, "test_results_stepwise.csv")
        if df is not None:
            keys = list(zip(df["filename"], df["scene"].astype(int)))
            break
    if keys is None:
        return
    width = 0.35
    for metric, fname, ylabel, with_gt in [
        ("loss", "stepwise_loss.png", "1-step acc RMSE", False),
        ("step_time", "stepwise_time.png", "step time (s)", True),
    ]:
        fig, ax = plt.subplots(figsize=(7, 4.5))
        xs = np.arange(len(keys))
        n_series = 0  # count only series actually plotted — a missing CSV
        # must not leave an empty bar slot and shift the tick centering
        for name in names:
            df = _load(base, name, "test_results_stepwise.csv")
            if df is None:
                continue
            rows = df.set_index(["filename", "scene"])[metric]
            vals = [rows.get(k, np.nan) for k in keys]
            ax.bar(xs + n_series * width, vals, width, label=name)
            n_series += 1
        if with_gt and scene_info:
            ax.bar(
                xs + n_series * width,
                [scene_info.get(k, (0, np.nan))[1] for k in keys],
                width,
                label="leapfrog (ground truth)",
                color="green",
            )
            n_series += 1
        ax.set_xticks(xs + width * (n_series - 1) / 2)
        ax.set_xticklabels(
            [scene_info.get(k, ("?",))[0] for k in keys]
        )
        ax.set_xlabel("n_bodies")
        ax.set_ylabel(ylabel)
        ax.set_yscale("log")
        ax.legend()
        ax.set_title(f"Stepwise {metric}")
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, fname), dpi=120)
        plt.close(fig)


def plot_rollout(base, names, outdir):
    dfs = {n: _load(base, n, "test_results_rollout.csv") for n in names}
    dfs = {n: d for n, d in dfs.items() if d is not None}
    if not dfs:
        return
    any_df = next(iter(dfs.values()))
    scenes = sorted(
        set(zip(any_df["filename"], any_df["scene"].astype(int)))
    )
    scene_info = _scene_n_bodies(base)
    cols = ["pos_rmse", "vel_rmse", "acc_rmse"]
    fig, axes = plt.subplots(
        len(scenes), 3, figsize=(12, 2.2 * len(scenes)), squeeze=False
    )
    for r, key in enumerate(scenes):
        fname, scene = key
        for c, col in enumerate(cols):
            ax = axes[r][c]
            for name, df in dfs.items():
                sub = df[(df["filename"] == fname) & (df["scene"] == scene)]
                ax.plot(sub["step"], sub[col], label=name, lw=0.8)
            ax.set_yscale("log")
            if r == 0:
                ax.set_title(col)
            if c == 0:
                n = scene_info.get(key, ("?",))[0]
                ax.set_ylabel(f"scene {scene}\n(n={n})")
            if r == len(scenes) - 1:
                ax.set_xlabel("rollout step")
    axes[0][0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "rollout.png"), dpi=120)
    plt.close(fig)


def _device(artifact: dict) -> str:
    """The device an artifact was measured on: the port's ``device_kind``
    (the card's name), else the JAX package's ``device``."""
    return artifact.get("device_kind") or artifact.get("device") or "unknown device"


def plot_crossover(base, outdir):
    """Classical engines vs surrogate step time across N, merged from all
    crossover artifacts (oldest to newest; a newer artifact's row replaces an
    older one with the same (device, n, series)). Skipped silently if none
    exists. A series is one engine on one device: with more than one device
    among the artifacts, each label names its device.

    Series colors are Okabe-Ito colorblind-safe, fixed order."""
    import json
    import re

    rows_by_key = {}  # (device, n, series key) -> row, later artifacts win

    def _key(mode):
        # exact refresh parse — substring tests would fold refresh=16 into
        # the refresh=1 series
        m = re.search(r"refresh=(\d+)", mode)
        return ("direct" if mode == "direct" else
                "classical BH" if mode.startswith("bh(") else
                "two-level BH (bh2)" if mode.startswith("bh2(") else
                "Verlet-refined BH (bh3)" if mode.startswith("bh3(") else
                f"surrogate (refresh={m.group(1)})" if m else mode)

    found = False
    for name in ("crossover.json", "crossover_pallas.json",
                 "crossover_r3.json", "crossover_r4.json",
                 "crossover_r4_direct.json"):
        cand = os.path.join(base, "results", "large_scale", name)
        if not os.path.exists(cand):
            continue
        found = True
        with open(cand) as f:
            artifact = json.load(f)
        for r in artifact["rows"]:
            rows_by_key[(_device(artifact), r["n"], _key(r["mode"]))] = r
    if not found:
        return

    devices = sorted({d for d, _, _ in rows_by_key})
    series = {}  # (series key, device) -> (ns, ms)
    for (device, n, key), r in rows_by_key.items():
        series.setdefault((key, device), ([], []))
        series[(key, device)][0].append(n)
        series[(key, device)][1].append(r["ms_per_step"])

    known = ["direct", "classical BH", "two-level BH (bh2)",
             "Verlet-refined BH (bh3)",
             "surrogate (refresh=1)", "surrogate (refresh=8)"]
    keys = {k for k, _ in series}
    order = [(k, d) for d in devices
             for k in known + sorted(k for k in keys if k not in known)
             if (k, d) in series]
    styles = ["-", "--", ":", "-."]
    colors = {"direct": "#0072B2",
              "classical BH": "#D55E00",
              "two-level BH (bh2)": "#CC79A7",
              "Verlet-refined BH (bh3)": "#000000",
              "surrogate (refresh=1)": "#E69F00",
              "surrogate (refresh=8)": "#009E73"}
    fig, ax = plt.subplots(figsize=(6.4, 4.2))
    for key, device in order:
        ns, ms = series[(key, device)]
        o = np.argsort(ns)
        label = key if len(devices) == 1 else f"{key}, {device}"
        ax.plot(np.asarray(ns)[o], np.asarray(ms)[o], marker="o",
                markersize=5, linewidth=2, color=colors.get(key), label=label,
                linestyle=styles[devices.index(device) % len(styles)])
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("bodies")
    ax.set_ylabel("ms / step")
    ax.set_title(
        "Classical (direct / BH / bh2 / bh3) vs surrogate step time\n"
        f"({'; '.join(devices)})"
    )
    ax.grid(True, which="both", alpha=0.25, linewidth=0.5)
    ax.legend(frameon=False)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "crossover.png"), dpi=120)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base", default=".")
    p.add_argument("--models", nargs="+", default=["gnn", "contconv"])
    args = p.parse_args(argv)
    outdir = os.path.join(args.base, "figures")
    os.makedirs(outdir, exist_ok=True)
    plot_loss(args.base, args.models, outdir)
    plot_stepwise(args.base, args.models, outdir)
    plot_rollout(args.base, args.models, outdir)
    plot_crossover(args.base, outdir)
    print(f"figures written to {outdir}")


if __name__ == "__main__":
    main()
