"""Device timing — the port of ``nbody_tpu/utils/timing.py``.

PyTorch returns from a CUDA call before the device has finished, so a host
timer has to close its region with ``torch.cuda.synchronize``. On the CPU
every op has finished when it returns and no synchronisation is needed.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch


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
