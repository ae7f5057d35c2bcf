"""Reading a profiler trace of the measured window.

The traced run records the window under ``torch.profiler`` (host and
device activity) and exports its Chrome trace; :class:`Trace` reads that
JSON. Host and device events share one clock there, so busy time, idle
gaps and the attribution of device work to host ranges all come from one
window of one run:

- the window is the host range named :data:`WINDOW`;
- busy time is the union of kernel, copy and memset intervals inside it;
- a device event belongs to a host range when the runtime call that
  launched it (matched by its correlation id) lies inside that range on the
  same thread.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("cpu_op", "user_annotation")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The events of one Chrome trace (``traceEvents``), times in
    microseconds."""

    def __init__(self, events: List[dict]):
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.launch: Dict[int, Tuple[object, float]] = {}
        self.ranges: List[Tuple[object, float, float, str]] = []
        window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launch[args["correlation"]] = (e.get("tid"), ts)
            elif cat in RANGE_CATS:
                self.ranges.append((e.get("tid"), ts, ts + dur, e.get("name", "")))
                if e.get("name") == WINDOW:
                    window = (e.get("tid"), ts, ts + dur)
        if window is None:
            raise ValueError(f"the trace holds no {WINDOW!r} range")
        self.thread, self.t0, self.t1 = window

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _inside(self):
        return [(max(a, self.t0), min(b, self.t1), name, corr)
                for a, b, name, corr in self.device if b > self.t0 and a < self.t1]

    def busy(self) -> List[Tuple[float, float]]:
        """Merged intervals in which a kernel, copy or memset ran."""
        return _merge([(a, b) for a, b, _, _ in self._inside() if b > a])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        """[name, seconds] of the device operations that took most time."""
        tot: Dict[str, float] = defaultdict(float)
        for a, b, name, _ in self._inside():
            tot[name] += (b - a) * 1e-6
        return [[n[:160], s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:top]]

    def kernels(self, match: Callable[[str], bool]) -> Tuple[int, float]:
        """(count, seconds) of the device events whose name ``match`` accepts."""
        hits = [(b - a) for a, b, name, _ in self._inside() if match(name)]
        return len(hits), sum(hits) * 1e-6

    def device_s_under(self, match: Callable[[str], bool]) -> Tuple[int, float]:
        """(ranges, device seconds) of the work launched inside host ranges
        whose name ``match`` accepts: each device event counts once, however
        many such ranges nest around its launch."""
        spans: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
        count = 0
        for tid, a, b, name in self.ranges:
            if match(name) and b > self.t0 and a < self.t1:
                spans[tid].append((a, b))
                count += 1
        merged = {tid: _merge(v) for tid, v in spans.items()}
        starts = {tid: [a for a, _ in v] for tid, v in merged.items()}
        total = 0.0
        for a, b, _, corr in self._inside():
            tid, ts = self.launch.get(corr, (None, None))
            if tid not in merged:
                continue
            i = bisect.bisect_right(starts[tid], ts) - 1
            if i >= 0 and merged[tid][i][1] >= ts:
                total += b - a
        return count, total * 1e-6

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[host activity, idle seconds]: every idle stretch of the device
        inside the window, named by the innermost host range open on the
        window's thread at its middle, summed by name."""
        busy = self.busy()
        gaps, t = [], self.t0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.t1:
            gaps.append((t, self.t1))
        ranges = sorted(((a, -b, name) for tid, a, b, name in self.ranges
                         if tid == self.thread and name != WINDOW), key=lambda r: (r[0], r[1]))
        tot: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[float, str]] = []
        i = 0
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            while i < len(ranges) and ranges[i][0] <= mid:
                a, nb, name = ranges[i]
                while stack and stack[-1][0] < a:
                    stack.pop()
                stack.append((-nb, name))
                i += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            tot[stack[-1][1] if stack else "(no host range)"] += (g1 - g0) * 1e-6
        return [[n[:160], s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:top]]
