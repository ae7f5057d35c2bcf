"""Profiler capture — the port of ``nbody_tpu/utils/profiling.py`` on
:mod:`torch.profiler`. The experiment entry points' ``--profile DIR`` wraps the
evaluation in :func:`trace_profile`; the trace is a Chrome-trace JSON file
that Perfetto or ``chrome://tracing`` opens."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host
    operators, and the card's kernels when CUDA is available) into
    ``<logdir>/trace.json``:

        with trace_profile("trace_dir"):
            trainer.test_from_dir(...)
    """
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
