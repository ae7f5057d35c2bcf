#!/usr/bin/env python3
"""A set of runs of one cell, each its own process as a check runs it, and
the spread of each metric over the set: the readings that the bounds in
``BENCHMARK.json`` are set from.

    python benchmark/sets.py --workload contconv-rollout-100k --seconds 10 \\
        --seeds 1,2,3,4,5,6 --out chiprun_out/sets.jsonl

runs ``benchmark/run.py`` once a seed, in that order, and appends one JSON
line a run to ``--out`` (seed, exit code, wall seconds, the result line,
and the end of standard error where there is no result), then one summary
line: each metric's median and spread, the distance between the first and
the third quartile (``statistics.quantiles(values, n=4)``) over the median.
Needs the card the cell asks for; the benchmark's own runs never call it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values):
    """(median, quartile spread over the median) of ``values``."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    results = []
    with open(args.out, "a") as out:
        for seed in (int(s) for s in args.seeds.split(",") if s):
            cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
                   "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            done = subprocess.run(cmd, capture_output=True, text=True, cwd=os.path.dirname(HERE))
            wall = time.perf_counter() - t0
            lines = done.stdout.strip().splitlines()
            result = None
            if done.returncode == 0 and lines:
                result = json.loads(lines[-1])
                results.append(result)
            line = {"workload": args.workload, "seed": seed, "trace": args.trace,
                    "rc": done.returncode, "wall_s": wall, "result": result}
            if result is None:
                line["stderr"] = done.stderr[-4000:]
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps({k: line[k] for k in ("seed", "rc", "wall_s")}
                             | {"correct": result and result["correct"],
                                "metrics": result and {k: m["value"]
                                                       for k, m in result["metrics"].items()}}),
                  flush=True)
        names = sorted({k for r in results for k in r["metrics"]})
        summary = {"workload": args.workload, "seconds": args.seconds, "trace": args.trace,
                   "runs": len(results), "all_correct": all(r["correct"] for r in results),
                   "spread": {}}
        for name in names:
            values = [r["metrics"][name]["value"] for r in results if name in r["metrics"]]
            med, sp = spread(values)
            summary["spread"][name] = {"median": med, "spread": sp, "n": len(values)}
        out.write(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
