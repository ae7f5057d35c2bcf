"""Wall time of the port's recipe datagen in two checkouts, on one card.

    python scripts/datagen_ab.py PARENT_DIR CHANGE_DIR [--out FILE]

Runs ``chip_smoke.py``'s datagen phases from each checkout, each run in a
process of its own, in the order A, B, B, A: phase 0 (the card, the
kernels' build), phase 2 twice (the six-scene recipe through
``cli.datagen``, 1000 steps; the first run warms the process) and phase 2b
(8 scenes of 500 bodies for 1000 steps, grouped and one at a time, then
grouped with its CSV). Each wall time includes drawing the initial
conditions. Prints every ``[2]``/``[2b]`` wall-time line, then one JSON
object of the walls by checkout and run, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

CHILD = """
import os, sys, tempfile
sys.path.insert(0, {tree!r})
os.chdir({tree!r})
import chip_smoke as cs
cs.phase0_device()
with tempfile.TemporaryDirectory() as tmp:
    for rep in range(2):
        out = os.path.join(tmp, f"recipe{{rep}}")
        os.makedirs(out)
        cs.phase2_datagen(out)
    cs.zero_counts()
    cs.phase2b_grouped_datagen(tmp)
"""
WALL = re.compile(r"^\[(2b?)\] (.*?): ([0-9.]+) s wall")


def run(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD.format(tree=os.path.abspath(tree))],
                          capture_output=True, text=True)
    if proc.returncode:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    walls = {}
    for line in proc.stdout.splitlines():
        m = WALL.match(line)
        if m:
            print(f"{tree}: {line}", flush=True)
            label = f"[{m.group(1)}] {m.group(2)}"
            walls.setdefault(label, []).append(float(m.group(3)))
    return walls


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {"card": card, "runs": []}
    for name, tree in (("parent", args.parent), ("change", args.change),
                       ("change", args.change), ("parent", args.parent)):
        result["runs"].append({"checkout": name, "walls": run(tree)})
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
