#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from: one cell on
many seeds in one process, as the program (``--seeds``), as the control
(``--control-seeds``, the reference in TF32 in the program's place) and
with a fault planted in the program (``--fault NAME=SEEDS``, the names of
``benchmark/harness/faults.py``), each run a short window at the cell's own
size. One JSON line a run:

    python benchmark/readings.py --workload gnn-rollout-1m --seconds 3 \\
        --seeds 1,2,3 --control-seeds 4,5,6 --fault answer_altered=7,8,9

Needs the card the cell asks for; the benchmark's own runs never call it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import run  # benchmark/run.py, on the path as this file's directory


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[], metavar="NAME=SEEDS")
    args = p.parse_args(argv)
    from benchmark.harness import faults
    from benchmark.harness import manifest as mf

    man = mf.load()
    run.require_cards([w for w in man["workloads"] if w["name"] == args.workload][0]["chips"])
    import torch

    dev = torch.device("cuda", 0)
    plan = [(int(s), "program") for s in args.seeds.split(",") if s] + \
           [(int(s), "control") for s in args.control_seeds.split(",") if s]
    for spec in args.fault:
        name, seeds = spec.split("=", 1)
        plan += [(int(s), name) for s in seeds.split(",") if s]
    for seed, mode in plan:
        t0 = time.perf_counter()
        planted = faults.plant(mode) if mode not in ("program", "control") else contextlib.nullcontext()
        with planted:
            res, numbers = run.run_cell(args.workload, seed, args.seconds, False, dev, t0,
                                        control=mode == "control")
        print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                          "correct": res["correct"], "numbers": {n: v for n, v, _ in numbers},
                          "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                          "check_s": res["check_s"]}),
              flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
