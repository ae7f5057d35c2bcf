"""Start the ranks of a mesh: one process each, over ``torch.distributed``.

    run_ranks(fn, world, backend, *args, device=None)

spawns ``world`` processes (``multiprocessing`` spawn context, so no child
inherits the parent's threads or imports), joins them into a process group
on a free ``localhost`` port, sets each rank's device, runs
``fn(device, *args)`` on every rank and returns rank 0's result. ``fn`` must
be importable by name (a module-level function of a module that imports
only torch and this package: a child imports that module, nothing else of
the caller). A rank that raises fails the whole call: the tracebacks of
the ranks that failed come back in one ``RuntimeError``, and the other
ranks are stopped.

Devices: with ``device=None`` rank r runs on ``cuda:(r % device_count)``
and a machine without a card raises; ``device="cpu"`` puts every rank on
the CPU; any other device name puts every rank on that device (``"cuda:0"``
with the ``gloo`` backend runs several ranks on one card). Nothing moves to
the CPU because no card was found.
"""

from __future__ import annotations

import datetime
import queue
import socket
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# after a rank fails, how long the others get to report before they are stopped
_GRACE_S = 5.0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(rank: int, device=None) -> torch.device:
    """Rank ``rank``'s device under :func:`run_ranks`'s rule."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _child(rank, world, backend, port, device, timeout, fn, args, results):
    try:
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:  # every failure goes back to the parent, then the rank ends
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str, *args, device=None, timeout: float = 900.0):
    """Run ``fn(device, *args)`` on ``world`` ranks of a fresh process group
    and return rank 0's result; raise ``RuntimeError`` with the traceback of
    every rank that failed, or on ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child, args=(r, world, backend, port, device, timeout,
                                              fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    failed_at = None
    try:
        while len(got) + len(errors) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
                (got if ok else errors)[rank] = value
            except queue.Empty:
                for r, p in enumerate(procs):
                    if (r not in got and r not in errors and not p.is_alive()
                            and p.exitcode not in (0, None)):
                        errors[r] = f"rank {r} died with exit code {p.exitcode}"
            now = time.monotonic()
            if errors and failed_at is None:
                failed_at = now
            if failed_at is not None and now - failed_at > _GRACE_S:
                break
            if now > deadline:
                errors.setdefault(-1, f"ranks did not finish in {timeout} s")
                break
    finally:
        for p in procs:
            if p.is_alive() and (errors or time.monotonic() > deadline):
                p.terminate()
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:  # every failed rank's traceback: the first to arrive may be an echo
        raise RuntimeError(f"ranks {sorted(errors)} of {world} failed:\n" + "\n".join(
            f"--- rank {r}:\n{tb}" for r, tb in sorted(errors.items())))
    return got[0]


def imported_jax() -> list:
    """The modules of JAX or of the JAX package that this process has
    imported (a rank body's check that the port stands alone)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "nbody_tpu"))

