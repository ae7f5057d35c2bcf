"""Device timing — the port of ``nbody_tpu/utils/timing.py``.

PyTorch returns from a CUDA call before the device has finished, so a host
timer has to close its region with ``torch.cuda.synchronize``. On the CPU
every op has finished when it returns and no synchronisation is needed.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

# published peaks of one H100 SXM (NVIDIA's data sheet): FP32 outside the
# tensor cores, and HBM bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# seconds between the start of a profiler session and the first recorded
# call of :func:`kernel_events` (four times as long in each session after
# the first), and the sessions it opens at most
_RECORDING_DELAY_S = 0.02
_SESSIONS = 5


def synchronize(device) -> None:
    """Wait for the queued work of a CUDA ``device``; no-op for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_time(fn: Callable[[], object], device) -> Tuple[object, float]:
    """Run ``fn`` and return (result, seconds), with the device's queued
    work finished on both sides of the timed region."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def profile_ms(fn: Callable[[], object], device, top: int = 6
               ) -> Tuple[float, List[Tuple[str, float]]]:
    """Busy milliseconds of one call of ``fn`` under :mod:`torch.profiler`,
    and its ``top`` largest rows as (name, ms). On a CUDA device the busy
    time is the sum of the kernel and copy rows (the ``aten::`` rows would
    count their kernels' time again); on the CPU, the operators' self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    synchronize(device)
    with profile(activities=activities) as prof:
        if cuda:  # as in kernel_events: the card's recording may start late
            time.sleep(_RECORDING_DELAY_S)
        fn()
        synchronize(device)
    rows = []
    for e in prof.key_averages():
        if cuda and e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            rows.append((e.key, (e.self_cuda_time_total if us is None else us) / 1e3))
        elif not cuda:
            rows.append((e.key, e.self_cpu_time_total / 1e3))
    rows.sort(key=lambda r: -r[1])
    return sum(ms for _, ms in rows), rows[:top]


def kernel_events(fn: Callable[[], object], reps: int = 20, name: Optional[str] = None
                  ) -> List[Tuple[str, float]]:
    """(name, device ms) of every CUDA kernel and copy that ``reps`` calls
    of ``fn`` put on the card, from :mod:`torch.profiler`; with ``name``,
    only the kernels whose name holds it. The calls run once before the
    profiler, and the recorded ones start ``_RECORDING_DELAY_S`` into its
    session: the profiler's recording of the card can begin some
    milliseconds after the session does, and then misses the first kernels.
    Late in a long process it can begin after all the calls, so a session
    that recorded none of the wanted kernels is opened again with four times
    the delay, up to ``_SESSIONS`` times. Divide a sum of times by the
    events it counts, not by ``reps``, so that a missed event cannot make a
    kernel look faster."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_events profiles CUDA work; no CUDA device")

    def calls():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    calls()
    events = []
    for session in range(_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(_RECORDING_DELAY_S * 4 ** session)
            calls()
        events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and (name is None or name in e.name)]
        if events:
            break
    return events


def cuda_time_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current CUDA stream, from
    CUDA events around ``reps`` back-to-back calls after ``warmup`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms times CUDA work; no CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> Tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time of work that does
    ``flops`` FP32 operations and moves ``nbytes`` (each input read once,
    each output written once), the larger of the two at the card's peaks."""
    t_ops, t_bytes = 1e3 * flops / PEAK_FLOPS, 1e3 * nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
