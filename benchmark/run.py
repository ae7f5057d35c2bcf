#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the ``nbody_tpu_torch`` package, on a machine with the CUDA cards the
cell asks for. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared with its limit. The last lines of standard error list the
same numbers.

Without the cards the cell needs it exits with code 3 and prints no result;
it exits with code 4 and prints no result if the process loaded ``jax``,
``jaxlib``, ``flax`` or ``nbody_tpu``.
"""

from __future__ import annotations

import os
import sys
import time


def _seconds_since_start() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _seconds_since_start()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every kernel cache of the program at a fixed place inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

GIB = float(1 << 30)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_cards(chips: int) -> None:
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: this cell needs {chips} CUDA card(s), found {have}; no result",
              file=sys.stderr)
        raise SystemExit(3)


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False, traffic_overrides: dict = None, root=None):
    """Set up, measure and check one cell once on ``device``. Returns the
    result object (the printed JSON) and the numbers compared.
    ``traffic_overrides`` replace keys of the traffic file (the tests' small
    sizes); ``root`` is the checkout whose ``BENCHMARK.json`` and files name
    the cell."""
    import torch

    from benchmark.harness import manifest as mf
    from benchmark.harness.trace import WINDOW, Trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = mf.ROOT if root is None else root
    man = mf.load(root)
    cell = mf.cell(man, workload, root)
    traffic = dict(cell["traffic"], **(traffic_overrides or {}))
    drv = mf.driver(traffic["kind"])
    cuda = device.type == "cuda"
    ctx = SimpleNamespace(workload=workload, seed=seed, config=cell["config"], traffic=traffic,
                          device=device, trace=trace, tmpdir=tempfile.gettempdir())
    st = drv.setup(ctx)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    parsed = None
    if trace:
        prof = _profile()
        with prof:
            with torch.profiler.record_function(WINDOW):
                work = drv.window(st, ctx, seconds)
        path = os.path.join(ctx.tmpdir, f"nbody-bench-trace-{workload}-{seed}.json")
        t_read = time.perf_counter()
        prof.export_chrome_trace(path)
        del prof
        try:
            trace_bytes = os.path.getsize(path)
            parsed = Trace.from_file(path)
        finally:
            os.remove(path)
        print(f"trace {trace_bytes} bytes, exported and read in "
              f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    else:
        work = drv.window(st, ctx, seconds)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drv.release(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, counts = drv.check(st, ctx, control=control)
    if cuda:
        torch.cuda.synchronize(device)
    check_s = time.perf_counter() - t_check
    finite = all(math.isfinite(v) for _, v, _ in numbers)
    correct = bool(finite and work["failed"] == 0 and all(v <= lim for _, v, lim in numbers))
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": correct, "attempted": work["attempted"], "failed": work["failed"]}
    if trace:
        rctx = SimpleNamespace(trace=parsed, work=work, counts=counts, config=cell["config"],
                               traffic=traffic)
        metrics = {}
        for m in mf.per_layer(man, workload):
            value = mf.reader(m["name"]).read(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = parsed.busy_s()
        dev_info["window_s"] = parsed.window_s
        result["metrics"] = metrics
        result["device"] = dev_info
        result["breakdown"] = {"device_ops": parsed.device_ops(), "idle_gaps": parsed.idle_gaps()}
    else:
        values = dict(work["end_to_end"], peak_mem_gib=window_peak / GIB, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in mf.end_to_end(man, workload)}
        result["device"] = dev_info
    result["check_s"] = check_s
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    return result, numbers


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.harness import manifest as mf
    from benchmark.harness.guard import forbidden_loaded

    man = mf.load()
    chips = [w for w in man["workloads"] if w["name"] == args.workload]
    if not chips:
        print(f"benchmark: no workload {args.workload!r}", file=sys.stderr)
        return 2
    require_cards(chips[0]["chips"])
    import torch

    result, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda", 0), T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 4
    for name, v, lim in numbers:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
