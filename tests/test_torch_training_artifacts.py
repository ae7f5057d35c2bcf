"""The port's answers to the JAX package's training artifacts.

``results/large_scale_h100/train_*.json`` answer ``results/large_scale/``'s
files of the same names (and ``train_1m_committed_weights.json`` evaluates
the committed 1M weights on the port's own data); ``results/gnn_h100/`` and
``results/contconv_h100/`` answer the two reference experiments. These tests
hold their form to the reference's: the same keys, the same knobs, a card's
name and power limit, the same CSV headers and row counts. ``train_large``'s defaults must
never point at the reference's own files. The command lines come from
``scripts/h100_treecode_runs.py``: for every JAX artifact they parse to its
recorded knobs, every flag it leaves out names its source, and each answer
was made by the line that ``results/large_scale_h100/train_commands.txt``
holds for it. The reference experiments' lanes take their flags from
``run_experiments.sh``'s own lines, the answers were made by those flags
plus placement (``results/NAME_h100/commands.txt``), and every barred
reading of ``scripts/answer_ratios.py``'s reference section meets its bar.
Reads JSON, CSV and text only.
"""

from __future__ import annotations

import csv
import glob
import importlib.util
import json
import os
import shlex

import pytest

from nbody_tpu_torch.experiments import contconv_experiment, gnn_experiment, train_large

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "results", "large_scale")
PORT_DIR = os.path.join(ROOT, "results", "large_scale_h100")


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                      name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


runs, ratios = _script("h100_treecode_runs"), _script("answer_ratios")

# answer -> the JAX artifact it answers
ANSWERS = {f"train_{t}": f"train_{t}" for t in (
    "20k", "50k", "100k", "100k_r3", "20k_contconv", "100k_contconv", "100k_contconv_r3",
    "1m", "1m_r3")}
ANSWERS["train_1m_committed_weights"] = "train_1m"
# fields the JAX script writes (nbody_tpu/experiments/train_large.py:357-436)
# that its older artifacts predate; the port writes them always
JAX_SCRIPT_FIELDS = {"": {"model"}, "training": {"neighbors", "scan_chunk", "remat"}}
# what the port adds: the card's name
PORT_FIELDS = {"": {"device_kind"}}
# epochs each reference experiment has run on the card: the ContConv run
# stopped at its last checkpoint when its lane's time ran out (PERF.md, Findings)
EPOCHS_REACHED = {"gnn": 100, "contconv": 22}
# readings, not knobs
READINGS = {"datagen_seconds", "seconds_total", "seconds_per_epoch", "final_scaled_rmse",
            "first_scaled_rmse"}


def _load(path):
    with open(path) as f:
        return json.load(f)


def _pair(name):
    return _load(os.path.join(PORT_DIR, name + ".json")), _load(
        os.path.join(JAX_DIR, ANSWERS[name] + ".json"))


def _csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _epochs_run(name, jax):
    """The epochs the JAX artifact's weights saw: its ``epochs`` knob, except
    the 1M run, whose ``--epochs 60`` session ended at epoch 23 and was
    evaluated from that checkpoint (its epoch-loss CSV has 23 rows)."""
    if ANSWERS[name] == "train_1m":
        return len(_csv(os.path.join(JAX_DIR, "train_1m_epoch_loss.csv"))[1])
    return jax["training"]["epochs"]


def test_train_large_defaults_stay_off_the_reference_artifacts():
    reference = os.path.realpath(JAX_DIR)
    p = train_large.build_parser()
    paths = [p.parse_args([]).data_dir + train_large.size_tag(20_000)]
    for argv in ([], ["--model", "contconv"], ["--n-bodies", "1000000", "--neighbors", "8"],
                 ["--model", "contconv", "--n-bodies", "100000"]):
        paths.append(train_large.default_out(p.parse_args(argv)))
    for path in paths:
        full = os.path.realpath(os.path.join(ROOT, path))
        assert os.path.commonpath([full, reference]) != reference, path
        assert os.path.commonpath([full, os.path.realpath(PORT_DIR)]) == os.path.realpath(
            PORT_DIR), path
    assert paths[1].endswith("/train_20k.json")
    assert paths[2].endswith("/train_20k_contconv.json")


@pytest.mark.parametrize("name", sorted(ANSWERS))
def test_answer_has_the_artifacts_keys(name):
    port, jax = _pair(name)
    for section in ("", "dataset", "training", "eval"):
        have = set(port[section] if section else port)
        want = set(jax[section] if section else jax)
        extra = JAX_SCRIPT_FIELDS.get(section, set()) | PORT_FIELDS.get(section, set())
        assert want <= have, (section, want - have)
        assert have - want <= extra, (section, have - want)
    # the eval-only answer trained nothing (its weights came from --load-params)
    assert (port["training"]["seconds_per_epoch"] == []) == name.endswith("_committed_weights")
    assert port["device_kind"].startswith("NVIDIA"), port["device_kind"]
    assert port["device"] == "gpu"


@pytest.mark.parametrize("name", sorted(ANSWERS))
def test_answer_ran_at_the_artifacts_knobs(name):
    port, jax = _pair(name)
    assert port["n_bodies"] == jax["n_bodies"]
    assert port.get("model", "gnn") == jax.get("model", "gnn")
    for section in ("dataset", "training"):
        for key, value in jax[section].items():
            if key in READINGS:
                continue
            want = _epochs_run(name, jax) if (section, key) == ("training", "epochs") else value
            assert port[section][key] == want, (section, key, port[section][key], want)
    assert port["eval"]["rollout_horizon"] == jax["eval"]["rollout_horizon"]
    steps = [r["step"] for r in port["eval"]["rollout_pos_rmse"]]
    assert steps == [r["step"] for r in jax["eval"]["rollout_pos_rmse"]]


@pytest.mark.parametrize("name", sorted(n for n in ANSWERS if n != "train_1m_committed_weights"))
def test_answer_epoch_loss_csv_has_the_artifacts_header(name):
    port, jax = _pair(name)
    header, rows = _csv(os.path.join(PORT_DIR, name + "_epoch_loss.csv"))
    assert header == ["epoch", "loss", "mse_loss", "wall_s"]
    assert [int(r[0]) for r in rows] == list(range(1, _epochs_run(name, jax) + 1))
    assert float(rows[-1][1]) == pytest.approx(port["training"]["final_scaled_rmse"])


@pytest.mark.parametrize("experiment", ["gnn", "contconv"])
@pytest.mark.parametrize("table", ["epoch_loss", "test_results_stepwise",
                                   "test_results_rollout"])
def test_reference_experiment_csv_has_the_references_form(experiment, table):
    ref_header, ref_rows = _csv(os.path.join(ROOT, "results", experiment, table + ".csv"))
    header, rows = _csv(os.path.join(ROOT, "results", experiment + "_h100", table + ".csv"))
    assert header == ref_header
    if table == "epoch_loss":  # one row an epoch, the reference's 100 at most
        assert len(rows) == EPOCHS_REACHED[experiment] <= len(ref_rows)
    else:  # the same files, scenes and steps in the same order
        assert len(rows) == len(ref_rows)
        key = slice(0, 3 if table == "test_results_rollout" else 2)
        assert [r[key] for r in rows] == [r[key] for r in ref_rows]


@pytest.mark.parametrize("path", ["large_scale_h100/train_card.txt", "gnn_h100/card.txt",
                                  "contconv_h100/card.txt"])
def test_answers_name_their_card(path):
    """Beside the answers, the card's ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` line of the runs that made them."""
    with open(os.path.join(ROOT, "results", path)) as f:
        name, limit = f.read().strip().split(", ")
    assert name.startswith("NVIDIA") and limit.endswith(" W")


# flags a lane adds: where the files go, never what is computed
PLACEMENT = {"data_dir", "out", "skip_datagen", "save_every"}
# an artifact's knobs as train_large's arguments: (section, key) -> argument
KNOBS = {("dataset", "train_scenes"): "train_scenes", ("dataset", "steps"): "steps",
         ("dataset", "stride"): "stride", ("dataset", "bh_near"): "bh_near",
         ("training", "epochs"): "epochs", ("training", "batch_size"): "batch_size",
         ("training", "lr"): "lr", ("training", "output_scale"): "output_scale",
         ("training", "neighbors"): "neighbors", ("training", "scan_chunk"): "scan_chunk",
         ("training", "remat"): "remat", ("eval", "rollout_horizon"): "rollout_steps"}


def _args(argv):
    return vars(train_large.build_parser().parse_args(argv))


def test_the_runner_answers_every_training_artifact():
    names = {os.path.basename(p)[:-5] for p in glob.glob(os.path.join(JAX_DIR, "train_*.json"))}
    assert names <= set(runs.TRAINING)
    assert set(runs.TRAINING) == names | set(runs.TRAIN_ARTIFACT) == set(ANSWERS) | {
        "train_1m_committed_weights"}


@pytest.mark.parametrize("name", runs.TRAINING)
def test_runner_argv_gives_the_artifacts_knobs(name):
    """The runner's command line parses with ``train_large``'s own parser and
    gives back every knob the artifact records, except where an ``EXTRA``
    row, which names its source, replaces it."""
    art = runs.jax_artifact(runs.TRAIN_ARTIFACT.get(name, name))
    args = _args(runs.train_argv(name))
    extra = runs.EXTRA.get(name, [])
    replaced = {f[2:].replace("-", "_") for flags, _ in extra for f in flags
                if f.startswith("--")}
    for flags, source in extra:
        assert flags[0].startswith("--") and len(source) > 10, (flags, source)
    assert (args["n_bodies"], args["model"]) == (art["n_bodies"], art.get("model", "gnn"))
    for (section, key), arg in KNOBS.items():
        if key in art[section] and arg not in replaced:
            assert args[arg] == art[section][key], (section, key, args[arg])
    assert not replaced & PLACEMENT


def _commands():
    """``train_commands.txt``: answer name -> the ``train_large`` argv that made it."""
    with open(os.path.join(PORT_DIR, "train_commands.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if ln and not ln.startswith("#")]
    out = {}
    for ln in lines:
        name, cmd = ln.split(": ", 1)
        words = shlex.split(cmd)
        assert words[:3] == ["python", "-m", "nbody_tpu_torch.experiments.train_large"], ln
        out[name] = words[3:]
    return out


@pytest.mark.parametrize("name", sorted(ANSWERS))
def test_answer_was_made_by_the_runners_command_line(name):
    """Each answer's line in ``train_commands.txt`` is the runner's command line
    plus where the files go, and the answer records those knobs."""
    got, want = _args(_commands()[name]), _args(runs.train_argv(name))
    assert {k: v for k, v in got.items() if k not in PLACEMENT} == {
        k: v for k, v in want.items() if k not in PLACEMENT}
    assert os.path.basename(got["out"]) == name + ".json"
    port = _load(os.path.join(PORT_DIR, name + ".json"))
    assert (port["n_bodies"], port["model"]) == (got["n_bodies"], got["model"])
    for (section, key), arg in KNOBS.items():
        assert port[section][key] == got[arg], (section, key)


@pytest.mark.parametrize("name", sorted(n for n in ANSWERS if n == ANSWERS[n]))
def test_committed_answer_holds_its_training_bars(name):
    """``scripts/answer_ratios.py``'s bars on each committed answer, epoch 1
    read from both epoch-loss CSVs: every barred reading met, and only the 1M
    stepwise and baseline unbarred."""
    port, jax = _pair(name)
    port, jax = (ratios.with_epoch_1(port, PORT_DIR, name),
                 ratios.with_epoch_1(jax, JAX_DIR, name))
    rows = {r[2]: r for r in ratios.compare(name, port, jax)}
    for key in ratios.TRAIN_BARS:
        unbarred = port["n_bodies"] == ratios.SEAM_N and key in ratios.SEAM_KEYS
        assert rows[key][7] == ("-" if unbarred else "met"), rows[key]


# the reference experiments: the port's entry point of each, and the flags a lane
# adds to run_experiments.sh's: where the files go, how the run is split
# over calls, the device
REF_ENTRY_POINTS = {"gnn": gnn_experiment, "contconv": contconv_experiment}
REF_PLACEMENT = {"base", "epochs", "save_every", "device"}
# barred reference readings that miss their bar, each with its evidence
# (PERF.md, Findings): results/contconv/epoch_loss.csv is the run of
# commit 1823b01, whose contconv_experiment had no --batch-mode (mixed batches
# and masked BatchNorm came in 79a0b15), so run_experiments.sh's line cannot
# have made it; JAX's own run of that line, results/contconv_h100/
# jax_68a9263_epoch_loss.csv (answer_ratios.JAX_RERUN), reads 72.939 at epoch 1,
# and its first epochs are held to the band below
KNOWN_MISSES = {("reference contconv", "epoch 1", "loss")}


def _run_experiments_line(experiment):
    """run_experiments.sh's line for the JAX entry point, as words, without its
    forwarded ``"$@"``."""
    with open(os.path.join(ROOT, "run_experiments.sh")) as f:
        (line,) = [ln for ln in f
                   if ln.startswith(f"python -m nbody_tpu.experiments.{experiment}_experiment ")]
    words = shlex.split(line)
    assert words[-1] == "$@"
    return words[3:-1]


def _changed(parse, argv, base):
    a, b = vars(parse(argv)), vars(parse(base))
    return {k for k in a if a[k] != b[k]}


@pytest.mark.parametrize("experiment", sorted(REF_ENTRY_POINTS))
def test_reference_lane_takes_run_experiments_flags(experiment):
    """``lane_ref`` reads its flags through the runner's ``reference_argv``,
    which gives ``run_experiments.sh``'s own; they parse with the port
    entry point's parser, and the lane types none of them itself."""
    flags = runs.reference_argv(experiment)
    assert flags == _run_experiments_line(experiment)
    parse = REF_ENTRY_POINTS[experiment].build_parser().parse_args
    assert parse(flags).seed == 42
    assert _changed(parse, flags, []) == {f[2:].replace("-", "_") for f in flags
                                          if f.startswith("--")}
    with open(os.path.join(ROOT, "scripts", "h100_training_runs.sh")) as f:
        text = f.read()
    assert "--ref-argv" in text
    assert not any(f in text for f in ("--batch-mode", "--merge-files", "--lr "))
    # run_experiments.sh's dataset paths, from a working directory of its own
    assert 'cd "$WORK/ref"' in text and "--base . --epochs" in text


@pytest.mark.parametrize("experiment", sorted(REF_ENTRY_POINTS))
def test_reference_answer_was_made_by_run_experiments_flags(experiment):
    """Every command line of ``results/NAME_h100/commands.txt`` (``#`` lines
    say which call ran it) is the port's entry point with ``run_experiments.sh``'s
    flags first, then placement only."""
    flags = runs.reference_argv(experiment)
    parse = REF_ENTRY_POINTS[experiment].build_parser().parse_args
    with open(os.path.join(ROOT, "results", experiment + "_h100", "commands.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip() and not ln.startswith("#")]
    assert lines
    for line in lines:
        words = shlex.split(line)
        assert words[:3] == ["python", "-m", f"nbody_tpu_torch.experiments.{experiment}_experiment"]
        assert words[3:3 + len(flags)] == flags
        assert _changed(parse, words[3:], flags) <= REF_PLACEMENT


@pytest.mark.parametrize("experiment", sorted(REF_ENTRY_POINTS))
def test_reference_answer_meets_its_bars(experiment):
    """``scripts/answer_ratios.py``'s reference section on the committed CSVs:
    epoch 1 always barred, the last epoch and each scene's stepwise loss
    barred once the run reached JAX's 100 epochs; every barred reading met
    but the ``KNOWN_MISSES``, which must still miss; and where a JAX run of
    the script's own recipe is kept beside the answer, its first epochs."""
    rows = ratios.reference_rows(experiment)
    missed = {r[:3] for r in rows if r[7] == "MISSED"}
    assert missed == {m for m in KNOWN_MISSES if m[0] == f"reference {experiment}"}, rows
    assert all(r[7] in ("met", "info", "-") for r in rows if r[:3] not in missed)
    done = EPOCHS_REACHED[experiment] == 100
    rerun = ratios.JAX_RERUN.get(experiment, (None, 0))[1]
    assert sum(r[7] in ("met", "MISSED") for r in rows) == 1 + 7 * done + rerun
    assert rows[1][1] == f"epoch {EPOCHS_REACHED[experiment]}"
