"""The JAX package's 17 2M-10M treecode configurations through the port on
one CUDA card, each at the knobs, length and audit that its answer in
``results/large_scale_h100/`` records (the knobs of its artifact under the
same name in ``results/large_scale/``), one process each, one after the
other::

    python scripts/h100_treecode_runs.py OUT [NAME ...]

``treeforce_bench`` runs the ``bh2_*`` and ``bh3_*`` answers (its
``--reps``; the sampled audit of ``--error-sample`` receivers where the
answer has one, else the full exact sum where it has an error, else none);
``bh_rollout --profile`` runs the ``bh_rollout_*`` answers (the exact
energy audit, or ``--no-energy-audit`` with the sampled force audit, or
``--chunked-energy-audit``, as recorded). Each writes ``OUT/NAME.json``;
copy them over ``results/large_scale_h100/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANSWERS = os.path.join(ROOT, "results", "large_scale_h100")
NAMES = ["bh2_2m", "bh2_4m", "bh2_10m_b512", "bh2_10m_b512_m8", "bh2_10m_b512_m32",
         "bh2_10m_b1024", "bh3_10m", "bh3_10m_speed", "bh3_10m_tier", "bh3_10m_tier_m32",
         "bh3_10m_tier_rc96", "bh_rollout_500k", "bh_rollout_1m", "bh_rollout_1m_bh3",
         "bh_rollout_2m", "bh_rollout_10m", "bh_rollout_10m_refresh4"]


def argv_of(name: str, out: str) -> list:
    """The entry point's command line that answers ``name`` again."""
    with open(os.path.join(ANSWERS, name + ".json")) as f:
        a = json.load(f)
    if "rows" in a:  # treeforce_bench
        r = a["rows"][0]
        argv = ["nbody_tpu_torch.experiments.treeforce_bench", "--n-bodies", r["n"],
                "--n-near", r["n_near"], "--block", r["block"], "--coarse", r["coarse"],
                "--rc", r["rc"], "--reps", a["reps"], "--seed", r["seed"]]
        argv += (["--engine", "bh3", "--sub-block", r["sub_block"], "--n-sub", r["n_sub"]]
                 if "sub_block" in r else ["--engine", "bh2"])
        if "error_sample" in r:
            argv += ["--error-sample", r["error_sample"]]
        elif "rel_err_median" in r:
            argv += ["--error-cap", r["n"]]
    else:  # bh_rollout
        argv = ["nbody_tpu_torch.experiments.bh_rollout", "--n-bodies", a["n"],
                "--steps", a["steps"], "--engine", a["engine"], "--bh-near", a["bh_near"],
                "--block", a["block"], "--bh-refresh", a["bh_refresh"], "--profile"]
        for key in ("coarse", "rc", "sub_block", "n_sub", "chunk_steps",
                    "chunked_energy_audit"):
            if key in a:
                argv += ["--" + key.replace("_", "-"), a[key]]
        if "error_sample" in a:
            argv += ["--no-energy-audit", "--error-sample", a["error_sample"]]
    return [sys.executable, "-m"] + [str(x) for x in argv] + [
        "--out", os.path.join(out, name + ".json")]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    out, names = args[0], args[1:] or NAMES
    os.makedirs(out, exist_ok=True)
    failed = []
    for name in names:
        cmd = argv_of(name, out)
        t0 = time.perf_counter()
        rc = subprocess.run(cmd, cwd=ROOT).returncode
        print(f"[{name}] exit {rc} in {time.perf_counter() - t0:.1f} s: {' '.join(cmd[2:])}",
              flush=True)
        if rc:
            failed.append(name)
    print(f"failed: {failed}" if failed else "all answered", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
