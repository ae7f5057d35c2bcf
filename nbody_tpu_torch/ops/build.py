"""Build the port's CUDA sources (``nbody_tpu_torch/csrc/*.cu``) at first use.

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
from pathlib import Path
from typing import Dict

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
_lock = threading.Lock()


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
    """The compiled ``csrc/<name>.cu``, building it first if needed."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}_{digest}.so"
        info = {"seconds": 0.0, "log": f"loaded {so.name} from an earlier build"}
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {src}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
            info = {"seconds": time.perf_counter() - t0,
                    "log": proc.stdout + proc.stderr}
        lib = ctypes.CDLL(str(so))
        BUILD_INFO[name] = info
        _libs[name] = lib
        return lib
