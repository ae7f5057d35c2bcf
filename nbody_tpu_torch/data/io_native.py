"""ctypes binding to the native CSV writer (``native/csvio.cpp``), with a
pandas fallback when the library cannot be built or loaded — the port of
``nbody_tpu/data/io_native.py``.

One C pass over contiguous column arrays prints every float column as
``%.9g``, so a dataset written here is byte-equal to the JAX package's for
the same rows (pandas prints each float64's repr, longer and different).
The library is built at first use from the shared source with ``g++ -O2
-shared -fPIC`` into ``build/native/`` at the root of the checkout
(git-ignored), under a name that carries the source's hash; ``native/``
itself is only read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from nbody_tpu_torch.data.schema import CSV_FIELDS

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "csvio.cpp"
BUILD_DIR = _ROOT / "build" / "native"

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _build() -> Path:
    """The library for the current source, compiled first if needed."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libnbodyio_{digest}.so"
    if not so.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise FileNotFoundError("no C++ compiler on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def _load_lib() -> Optional[ctypes.CDLL]:
    """Load (building on first use) the native writer; None when there is
    no toolchain or the library does not load — callers fall back to
    pandas."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.nbody_write_csv.restype = ctypes.c_int
    lib.nbody_write_csv.argtypes = [
        ctypes.c_char_p,  # path
        ctypes.c_char_p,  # header
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,  # int cols
        ctypes.POINTER(ctypes.c_int32),  # str idx
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,  # str names
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,  # dbl cols
        ctypes.c_int64,  # n_rows
    ]
    _lib = lib
    return _lib


_INT_COLS = ["scene", "step"]
_STR_COL = "scene_type"
_DBL_COLS = [c for c in CSV_FIELDS if c not in _INT_COLS and c != _STR_COL]


def write_csv(df, path: str) -> None:
    """Write a trajectory DataFrame in the reference schema to ``path``:
    the native writer when it is available, pandas ``to_csv`` otherwise."""
    lib = _load_lib()
    if lib is None:
        df.to_csv(path, index=False)
        return

    n = len(df)
    ints = np.ascontiguousarray(np.stack([df[c].to_numpy(np.int64) for c in _INT_COLS]))
    types, str_idx = np.unique(df[_STR_COL].to_numpy(object), return_inverse=True)
    str_idx = np.ascontiguousarray(str_idx.astype(np.int32))
    names = (ctypes.c_char_p * len(types))(*[str(t).encode() for t in types])
    dbls = np.ascontiguousarray(np.stack([df[c].to_numpy(np.float64) for c in _DBL_COLS]))
    rc = lib.nbody_write_csv(
        path.encode(), ",".join(CSV_FIELDS).encode(),
        ints.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(_INT_COLS),
        str_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), names, len(types),
        dbls.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(_DBL_COLS), n)
    if rc != 0:
        raise IOError(f"native CSV writer failed with code {rc} for {path}")


def native_available() -> bool:
    return _load_lib() is not None
