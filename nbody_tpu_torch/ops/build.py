"""Build the port's CUDA sources (``nbody_tpu_torch/csrc/*.cu``) at first use,
and the checks every kernel wrapper makes around a launch.

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, which is loaded with :mod:`ctypes`. That
takes seconds, where a source that includes PyTorch's headers would take
minutes. The library lands in ``build/kernels/`` at the root of the checkout
(git-ignored) under a name that carries the source's hash, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module, and this
machine need have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
]

# name -> {"seconds": build time (0.0 when loaded from an earlier build),
#          "log": what nvcc printed}
BUILD_INFO: Dict[str, dict] = {}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built on the machine that has the GPU")


def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu``, building it first if needed. Threads
    may build at the same time (one ``nvcc`` each); two that race on one
    source both build it, each into its own temporary file, and load the
    same library."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    info = {"seconds": 0.0, "log": f"loaded {so.name} from an earlier build"}
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        info = {"seconds": time.perf_counter() - t0, "log": proc.stdout + proc.stderr}
    BUILD_INFO.setdefault(name, info)
    return _libs.setdefault(name, ctypes.CDLL(str(so)))


def load_all(names) -> None:
    """Build (or load) several sources at once, one ``nvcc`` each."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names) or 1) as pool:
        list(pool.map(load_library, names))  # re-raises a failed build


def on_cpu(*ts: torch.Tensor) -> bool:
    """True for CPU tensors (the wrapper's twin path), False for CUDA
    tensors (its kernel path); raises on anything else, or on tensors split
    across devices."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or twin for device {dev}")
    return dev.type == "cpu"


def check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> None:
    """Raise unless ``t`` has the dtype, shape and contiguity a kernel takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def chunks(n: int, cap: int) -> list:
    """``[(lo, hi), ...]``: the indices ``0 .. n - 1`` cut in order into runs
    of at most ``cap``, one a launch where a grid dimension holds at most
    ``cap`` (one run ``(0, n)`` for ``n <= cap``)."""
    return [(lo, min(lo + cap, n)) for lo in range(0, n, cap)]


def raise_on(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
