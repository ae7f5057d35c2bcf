"""What a run may import and what it does without a card."""

import os
import shutil
import subprocess
import sys

from benchmark.harness.guard import forbidden_loaded
from benchmark.harness.manifest import BENCH, ROOT

CELL_ON_CPU = """
import sys, torch
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.harness import manifest as mf
from benchmark.harness.guard import forbidden_loaded
man = mf.load()
for m in man["per_layer"]:
    mf.reader(m["name"])
res, _ = run.run_cell({wl!r}, 3, 0.1, True, torch.device("cpu"), 0.0,
                      traffic_overrides={over!r})
print("LOADED", sorted(m.split(".")[0] for m in sys.modules if m.split(".")[0].startswith(("nbody", "jax", "flax"))))
print("FORBIDDEN", forbidden_loaded())
"""


def test_top_level_names_are_compared_whole():
    assert forbidden_loaded(["nbody_tpu_torch", "nbody_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert forbidden_loaded(["jax.numpy", "nbody_tpu.ops", "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "nbody_tpu"]


def _run_cell_in_a_process(wl, over):
    code = CELL_ON_CPU.format(root=str(ROOT), wl=wl, over=over)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_traced_rollout_loads_the_port_and_nothing_forbidden(small):
    out = _run_cell_in_a_process("contconv-rollout-100k", small["rollout"])
    assert "'nbody_tpu_torch'" in out
    assert "FORBIDDEN []" in out


def test_a_traced_training_run_loads_nothing_forbidden(small):
    out = _run_cell_in_a_process("gnn-train-1m", small["train"])
    assert "FORBIDDEN []" in out


def _bench(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], capture_output=True,
                          text=True, cwd=str(cwd), timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_a_timed_run_without_a_card_fails_and_prints_no_result():
    out = _bench(["--workload", "gnn-rollout-1m", "--seed", "7", "--seconds", "1",
                  "--trace", "0"], ROOT)
    assert out.returncode == 3
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_an_unknown_cell_fails():
    out = _bench(["--workload", "no-such-cell", "--seed", "7", "--seconds", "1", "--trace", "0"],
                 ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench(["--workload", "gnn-rollout-1m", "--seed", "7", "--seconds", "1", "--trace", "0"],
                 tmp_path)
    assert out.returncode != 0 and out.stdout == ""
