"""The JAX package's large-N artifacts through the port on one CUDA card: its
treecode sweeps and configurations from 20k to 10M bodies, its treecode
rollouts, its kNN recall table, its N-crossover study and its large-N
ContConv rows. Every row of each artifact below runs at the knobs that the
row (and its artifact in ``results/large_scale/``) records, and is written
to ``OUT/NAME.json`` in the artifact's shape::

    python scripts/h100_treecode_runs.py OUT [NAME ...]   # NAME may be a glob
    python scripts/h100_treecode_runs.py OUT --print [NAME ...]  # command lines only

then copy ``OUT/*.json`` into ``results/large_scale_h100/`` and read them
beside JAX's with ``scripts/answer_ratios.py``. Each answered row keeps the
command line that gives it again (``argv``: an entry point of
``nbody_tpu_torch.experiments``, run here in one process), and each answer
the card's ``device_kind`` and ``nvidia-smi`` line (``card``).

- ``bh``, ``bh2*``, ``bh3*``: ``treeforce_bench``, one call a row, with its
  engine, ``n``, ``n_near``, ``block``, ``coarse``, ``rc``, ``sub_block``,
  ``n_sub`` and ``i_chunk``, the artifact's ``reps`` (10 for ``bh.json``'s
  500k and 1M rows, as its note says), ``--error-sample`` where the row has
  one, the full exact sum (``--error-cap n``) where it has errors without
  one, and none where it has none. Rows of ``bh.json`` without
  ``near_impl`` came from an older XLA near path of JAX's: they run on the
  port's default (kernel) near path, which the row names.
- ``bh_rollout*``: ``bh_rollout --profile`` with the artifact's engine,
  knobs and chunks, and its audit: the exact energy, or the chunked exact
  energy, or (``error_sample``) the sampled force audit.
- ``knn_recall``: one ``knn_recall`` call over the artifact's profiles, Ns,
  windows and blocks; its ``approx`` rows are ``lax.approx_max_k``'s
  selection as XLA computes it off the TPU (``ops/knn.py``).
- ``crossover*``: ``crossover``, one call an N, each mode parsed from the
  row (``surrogate(pallas,...)`` runs the Morton kernels B7 + B8, an untagged
  surrogate the dense search, JAX's ``xla``), plus the flags that JAX's
  command lines gave and the artifacts do not record (``EXTRA``).
- ``contconv_large``, ``contconv_large_r3``: ``large_scale --model
  contconv --modes surrogate`` at the row's N, steps and refresh.

``crossover_window.json`` and ``gather_microbench.json`` have no entry point
in the JAX package that makes them, and ``ring_tpu.json`` is a scope cut:
none of them is answered.

The training artifacts ``train_*`` are answered by ``train_large``, one
process a run, in the lanes of ``scripts/h100_training_runs.sh``, which share
the card. Their command lines come from here: the knobs each artifact
records (``n_bodies``, ``model``, ``dataset``'s scenes, steps, stride and
``bh_near``, ``training``'s epochs, batch size, lr, output scale,
neighbours, scan chunk and remat, ``eval.rollout_horizon``), then the
``EXTRA`` rows. A lane adds only where the files go (``--data-dir``,
``--out``, ``--skip-datagen``, ``--save-every``)::

    python scripts/h100_treecode_runs.py --argv train_20k   # one argument a line

``train_1m_committed_weights`` evaluates ``train_1m``'s committed weights at
``train_1m``'s knobs.

The two reference experiments take their flags from ``run_experiments.sh``'s
own lines, the one place that holds them; a lane adds only placement
(``--base``, ``--epochs``, ``--save-every``, ``--device``)::

    python scripts/h100_treecode_runs.py --ref-argv gnn   # one argument a line
"""

from __future__ import annotations

import gc
import json
import os
import re
import shlex
import subprocess
import sys
import time
from fnmatch import fnmatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (ROOT, os.path.join(ROOT, "scripts")):  # the port's package; answer_ratios
    if _path not in sys.path:
        sys.path.insert(0, _path)

# rows are matched and engines named as the ratio table matches and names them
from answer_ratios import row_key, tree_engine  # noqa: E402

JAX_DIR = os.path.join(ROOT, "results", "large_scale")
TREECODE = ["bh", "bh2", "bh3", "bh3_1m_m48_ns32", "bh3_1m_m48_ns48", "bh3_1m_rc48_ns32",
            "bh3_1m_rc48_ns48", "bh3_1m_rc48_ns64",
            "bh2_2m", "bh2_4m", "bh2_10m_b512", "bh2_10m_b512_m8", "bh2_10m_b512_m32",
            "bh2_10m_b1024", "bh3_10m", "bh3_10m_speed", "bh3_10m_tier", "bh3_10m_tier_m32",
            "bh3_10m_tier_rc96"]
ROLLOUTS = ["bh_rollout", "bh_rollout_500k", "bh_rollout_1m", "bh_rollout_1m_bh3",
            "bh_rollout_2m", "bh_rollout_10m", "bh_rollout_10m_refresh4"]
CROSSOVER = ["crossover", "crossover_pallas", "crossover_pallas_fast", "crossover_r3",
             "crossover_r4", "crossover_r4_direct", "crossover_r5"]
NAMES = TREECODE + ROLLOUTS + ["knn_recall"] + CROSSOVER + ["contconv_large",
                                                             "contconv_large_r3"]
TRAINING = ["train_20k", "train_50k", "train_100k", "train_100k_r3", "train_20k_contconv",
            "train_100k_contconv", "train_100k_contconv_r3", "train_1m", "train_1m_r3",
            "train_1m_committed_weights"]
TRAIN_ARTIFACT = {"train_1m_committed_weights": "train_1m"}
# Flags of JAX's runs that the artifacts do not record, each with its source:
# (flags, source) rows by answer. A flag given here replaces the artifact's
# value of it. JAX's --conv-impl pallas (scripts/_tpu_queue3.sh:17) is the
# port's default on a card, so no row gives --conv-impl.
ZERO_INIT = [(["--zero-init-output"],
              "PERF.md, Findings, the zero-init probe: JAX's 2-scene runs started from a "
              "zero output head; with it the port's epoch 1 is JAX's (train_20k 1.0001x, "
              "the 20k ContConv 1.0046x on an H100), and on the CPU the port follows the "
              "JAX package of train_20k's commit d7ef376 with and without it "
              "(scripts/old_commit_train_check.sh)")]
TRAIN_1M = [(["--epochs", "23"], "results/large_scale/train_1m_epoch_loss.csv: the "
             "--epochs 60 sessions of scripts/tpu_queue20.sh:50-56,92-98 reached epoch 23 "
             "under their --train-time-budget, and that epoch's weights were evaluated"),
            (["--time-chunks", "4"], "scripts/tpu_queue20.sh:52")]
EXTRA = {"crossover_r3": [(["--knn-copies", "2"], "scripts/_tpu_queue.sh job 4")],
         "crossover_pallas_fast": [(["--knn-copies", "2", "--knn-block", "512"],
                                    "ROUND2_NOTES.md: the 2-copy, B=512 search")],
         "crossover_r4": [(["--neighbors", "8"], "scripts/tpu_queue11.sh")],
         "crossover_r5": [(["--neighbors", "8"], "scripts/tpu_queue19.sh")],
         **{n: ZERO_INIT for n in ("train_20k", "train_50k", "train_100k",
                                   "train_20k_contconv", "train_100k_contconv")},
         "train_1m": TRAIN_1M,
         "train_1m_r3": [(["--time-chunks", "4"], "scripts/_tpu_queue5.sh:17-21")],
         "train_1m_committed_weights": TRAIN_1M + [
             (["--load-params", "results/large_scale/train_1m_params.pt"],
              "results/large_scale/train_1m_params.msgpack, the weights train_1m.json "
              "evaluated, converted once to a state_dict")]}


def reference_argv(name: str) -> list:
    """The flags that ``run_experiments.sh`` gives ``NAME_experiment``, without
    its forwarded ``"$@"``."""
    with open(os.path.join(ROOT, "run_experiments.sh")) as f:
        lines = [shlex.split(line) for line in f if f"experiments.{name}_experiment " in line]
    (words,) = lines
    return words[words.index(f"nbody_tpu.experiments.{name}_experiment") + 1:words.index("$@")]


def jax_artifact(name: str) -> dict:
    with open(os.path.join(JAX_DIR, name + ".json")) as f:
        return json.load(f)


def treecode_argv(name: str, art: dict, row: dict) -> list:
    engine = tree_engine(row)
    reps = 10 if name == "bh" and row["n"] >= 500_000 else art["reps"]
    argv = ["--engine", engine, "--n-bodies", row["n"], "--n-near", row["n_near"],
            "--block", row["block"], "--reps", reps, "--seed", 0]
    for key in ("coarse", "rc", "sub_block", "n_sub", "i_chunk"):
        if key in row and (engine != "bh" or key == "i_chunk"):
            argv += ["--" + key.replace("_", "-"), row[key]]
    if "error_sample" in row:
        argv += ["--error-sample", row["error_sample"]]
    elif "rel_err_median" in row:
        argv += ["--error-cap", row["n"]]
    return [str(x) for x in argv]


def parse_mode(mode: str) -> dict:
    """``crossover``'s flags for one JAX mode tag, e.g.
    ``bh3(M=32,B=128,rc=48,K=24,refresh=8)`` or ``surrogate(pallas,refresh=8)``."""
    kind = mode.split("(")[0]
    inner = mode[len(kind) + 1:-1] if "(" in mode else ""
    knobs = dict(p.split("=") for p in inner.split(",") if "=" in p)
    out = {"mode": kind}
    if kind == "surrogate":
        out["refresh"] = knobs["refresh"]
        out["impl"] = "kernel" if "pallas" in inner.split(",") else "dense"
    if "M" in knobs:
        out["bh_near"] = knobs["M"]
    if "rc" in knobs:
        out["rc"] = knobs["rc"]
    if "K" in knobs:
        out["n_sub"] = knobs["K"]
    return out


def crossover_jobs(name: str, art: dict) -> list:
    """One ``crossover`` call a body count: (argv, the JAX rows it answers)."""
    jobs = []
    for n in sorted({r["n"] for r in art["rows"]}):
        rows = [r for r in art["rows"] if r["n"] == n]
        parsed = [parse_mode(r["mode"]) for r in rows]
        modes = sorted({p["mode"] for p in parsed})
        argv = ["--n-bodies", n, "--steps", art["steps"], "--only", *modes]
        refresh = [p["refresh"] for p in parsed if p["mode"] == "surrogate"]
        if refresh:
            (impl,) = {p["impl"] for p in parsed if p["mode"] == "surrogate"}
            argv += ["--graph-refresh", *refresh, "--knn-impl", impl]
            params = {r.get("params") for r in rows if "params" in r} - {None}
            for path in params:
                if not path.startswith("random-init"):  # the 1M weights, as torch saves them
                    argv += ["--load-params", re.sub(r"\.msgpack$", ".pt", path)]
        for key, flag in (("bh_near", "--bh-near"), ("rc", "--rc"), ("n_sub", "--n-sub")):
            vals = {p[key] for p in parsed if key in p}
            if vals:
                (v,) = vals
                argv += [flag, v]
        jobs.append((with_extra([str(x) for x in argv], name), rows))
    return jobs


def with_flags(argv: list, flags: list) -> list:
    """``argv`` with ``flags``: a flag already there takes their values, any
    other is added."""
    argv = list(argv)
    starts = [i for i, a in enumerate(flags) if a.startswith("--")] + [len(flags)]
    for i, j in zip(starts, starts[1:]):
        flag, values = flags[i], flags[i + 1:j]
        if flag in argv:
            k = argv.index(flag)
            argv[k + 1:k + 1 + len(values)] = values
        else:
            argv += [flag, *values]
    return argv


def with_extra(argv: list, name: str) -> list:
    """``argv`` with ``name``'s ``EXTRA`` rows."""
    for flags, _ in EXTRA.get(name, []):
        argv = with_flags(argv, flags)
    return argv


def train_argv(name: str) -> list:
    """``train_large``'s knobs for ``results/large_scale/NAME.json``: what the
    artifact records, then ``EXTRA``."""
    art = jax_artifact(TRAIN_ARTIFACT.get(name, name))
    d, t = art["dataset"], art["training"]
    argv = ["--model", art.get("model", "gnn"), "--n-bodies", art["n_bodies"],
            "--train-scenes", d["train_scenes"], "--steps", d["steps"], "--stride",
            d["stride"], "--bh-near", d["bh_near"], "--epochs", t["epochs"], "--batch-size",
            t["batch_size"], "--lr", t["lr"], "--output-scale", t["output_scale"],
            "--rollout-steps", art["eval"]["rollout_horizon"]]
    if "neighbors" in t:
        argv += ["--neighbors", t["neighbors"]]
    if t.get("scan_chunk") is not None:
        argv += ["--scan-chunk", t["scan_chunk"]]
    if t.get("remat"):
        argv.append("--remat")
    return with_extra([str(x) for x in argv], name)


def knn_argv(art: dict) -> list:
    rows = art["rows"]
    methods = [r["method"] for r in rows]
    windows = [m[len("morton(W="):-1] for m in dict.fromkeys(methods)
               if m.startswith("morton(W=")]
    blocks = [m[len("morton-pallas(B="):-1] for m in dict.fromkeys(methods)
              if m.startswith("morton-pallas(B=")]
    (k,) = {r["k"] for r in rows}
    return ["--n-bodies", *[str(n) for n in dict.fromkeys(r["n"] for r in rows)],
            "--k", str(k), "--windows", *windows, "--kernel-blocks", *blocks,
            "--kernel-copies", "4", "--profiles", *dict.fromkeys(r["profile"] for r in rows)]


def rollout_argv(art: dict) -> list:
    argv = ["--n-bodies", art["n"], "--steps", art["steps"], "--engine",
            art.get("engine", "bh"), "--bh-near", art["bh_near"], "--block",
            art.get("block", 256), "--bh-refresh", art["bh_refresh"], "--profile"]
    for key in ("coarse", "rc", "sub_block", "n_sub", "chunk_steps", "chunked_energy_audit"):
        if key in art:
            argv += ["--" + key.replace("_", "-"), art[key]]
    if "error_sample" in art:
        argv += ["--no-energy-audit", "--error-sample", art["error_sample"]]
    return [str(x) for x in argv]


def contconv_argv(n, steps, refresh) -> list:
    return [str(x) for x in ["--model", "contconv", "--modes", "surrogate", "--n-bodies", n,
                             "--steps", steps, "--graph-refresh", refresh,
                             "--knn-impl", "kernel", "--conv-impl", "kernel"]]


def command(module: str, argv: list) -> str:
    return " ".join(["python", "-m", f"nbody_tpu_torch.experiments.{module}",
                     *map(shlex.quote, argv)])


def jobs_of(name: str, select=None) -> list:
    """(module, argv, JAX rows answered) for every call that answers ``name``
    (with ``select``, the rows for which ``select(row)`` is true); JAX rows
    is None for an artifact without rows."""
    if name in TRAINING:
        return [("train_large", train_argv(name), None)]
    art = jax_artifact(name)
    if select is not None and "rows" in art:
        art = {**art, "rows": [r for r in art["rows"] if select(r)]}
    if name in TREECODE:
        return [("treeforce_bench", treecode_argv(name, art, r), [r]) for r in art["rows"]]
    if name in ROLLOUTS:
        return [("bh_rollout", rollout_argv(art), None)]
    if name == "knn_recall":
        return [("knn_recall", knn_argv(art), art["rows"])]
    if name in CROSSOVER:
        return [("crossover", argv, rows) for argv, rows in crossover_jobs(name, art)]
    if name == "contconv_large":
        return [("large_scale",
                 contconv_argv(r["n"], art["steps"], re.search(r"refresh=(\d+)",
                                                               r["mode"]).group(1)), [r])
                for r in art["rows"]]
    if name == "contconv_large_r3":
        return [("large_scale", contconv_argv(
            art["n_bodies"], art["steps"], art["results"]["surrogate"]["graph_refresh"]),
            None)]
    raise KeyError(name)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_job(module: str, argv: list, jax_rows, device: str):
    """Run one call in this process; returns the answered rows (a list in
    the JAX rows' order) or, for an artifact without rows, the entry point's
    record."""
    import importlib

    main = importlib.import_module(f"nbody_tpu_torch.experiments.{module}").main
    full = argv + ["--device", device]
    cmd = command(module, argv)
    if module == "treeforce_bench":
        (row,) = main(full)
        (want,) = jax_rows
        row = {**row, "engine": tree_engine(want), "near_impl": "kernel",
               "reps": int(argv[argv.index("--reps") + 1]), "argv": cmd}
        if "i_chunk" in want:
            row["i_chunk"] = want["i_chunk"]
        if "near_impl" not in want:
            row["jax_near_path"] = "older XLA near path (lineage row): times not comparable"
        return [row]
    if module == "bh_rollout":
        return {**main(full), "argv": cmd}
    if module in ("knn_recall", "crossover"):
        got = {row_key(r): r for r in main(full)}
        return [{**got[row_key(w)], "argv": cmd} for w in jax_rows]
    if module == "large_scale":
        res = main(full)["surrogate"]
        n, steps = int(argv[argv.index("--n-bodies") + 1]), int(argv[argv.index("--steps") + 1])
        if jax_rows is None:
            return {"n_bodies": n, "steps": steps, "knn_method": "morton", "knn_window": 64,
                    "knn_impl": "kernel", "conv_impl": "kernel", "results": {"surrogate": res},
                    "argv": cmd}
        (want,) = jax_rows
        return [{"n": n, "mode": want["mode"], "ms_per_step": res["seconds"] / steps * 1e3,
                 "psteps_per_s": res["psteps_per_s"], "finite": res["finite"], "argv": cmd}]
    raise KeyError(module)


def answer(name: str, device: str = "cuda", card: str = None, select=None) -> dict:
    """The port's answer to ``results/large_scale/NAME.json``: every row
    (or, with ``select``, the rows for which ``select(jax_row)`` is true)."""
    import torch

    art = jax_artifact(name)
    header = {"device": "gpu" if device.startswith("cuda") else device,
              "device_kind": (torch.cuda.get_device_name(0) if device.startswith("cuda")
                              else "cpu"),
              "card": card if card is not None else (
                  card_line() if device.startswith("cuda") else "cpu"),
              "jax_artifact": f"results/large_scale/{name}.json"}
    rows, record = [], None
    for module, argv, jax_rows in jobs_of(name, select):
        t0 = time.perf_counter()
        got = run_job(module, argv, jax_rows, device)
        print(f"[{name}] {time.perf_counter() - t0:.1f} s: {command(module, argv)}",
              flush=True)
        if isinstance(got, list):
            rows += got
        else:
            record = got
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
    if record is not None:
        return {**record, **header}
    keep = {k: art[k] for k in ("reps", "steps") if k in art}
    return {**header, **keep, "rows": rows}


def selected(patterns: list, names: list = NAMES) -> list:
    """The artifacts of ``names`` that match any of ``patterns`` (all without)."""
    return [n for n in names if not patterns or any(fnmatch(n, p) for p in patterns)]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] in (["--argv"], ["--ref-argv"]):
        (name,) = args[1:]
        print("\n".join((train_argv if args[0] == "--argv" else reference_argv)(name)))
        return 0
    if "--print" in args:
        for name in selected([a for a in args if a != "--print"], NAMES + TRAINING):
            for module, cmd, _ in jobs_of(name):
                print(f"[{name}] {command(module, cmd)}")
        return 0
    out, names = args[0], selected(args[1:])
    os.makedirs(out, exist_ok=True)
    card = card_line()
    print(card, flush=True)
    failed = []
    for name in names:
        t0 = time.perf_counter()
        try:
            ans = answer(name, card=card)
        except Exception as e:  # one artifact's fault leaves the others to run
            print(f"[{name}] FAILED: {type(e).__name__}: {e}", flush=True)
            failed.append(name)
            continue
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump(ans, f, indent=1)
        print(f"[{name}] answered in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"failed: {failed}" if failed else "all answered", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
