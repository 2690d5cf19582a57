"""Build the port's C++ index helpers with ``g++`` and load them with ctypes.

``csrc/data_helpers.cpp`` (the port's copy of the JAX package's
``data/cpp/helpers.cpp``) compiles with ``g++ -O3 -std=c++17 -shared
-fPIC`` at first use into ``build/data_helpers/`` under the checkout,
never into the JAX package's tree.  The library's file name carries a
hash of the source and the flags, so an edited source rebuilds; a build
writes to a private temporary name and renames it into place, so
processes building at the same time do not corrupt it.  A failed build
raises: there is no numpy fallback (``data/indexed.py`` keeps the numpy
versions as the plain versions the tests use).

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "data_helpers.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "data_helpers"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found (set CXX or put g++ on PATH): the port's index "
            "helpers (csrc/data_helpers.cpp) are built at first use"
        )
    return cxx


def build() -> Path:
    """The helper library's path, built first if it is missing.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    cxx = _compiler()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([cxx] + FLAGS).encode())
    path = BUILD_DIR / f"data_helpers-{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    out = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"index helper build failed (g++ exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded helper library with its four index builders typed;
    built and loaded once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            i8p, i32p = ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32)
            i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
            i32, i64, u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
            lib.build_sample_idx.argtypes = [i32p, i32p, i32, i64, i32p]
            lib.build_sample_idx.restype = None
            lib.build_blending_indices.argtypes = [f64p, i32, i64, i8p, i64p]
            lib.build_blending_indices.restype = None
            lib.build_mapping.argtypes = [i64p, i64, i32p, i32, ctypes.c_double, u64, i64,
                                          i64p, i32]
            lib.build_mapping.restype = i64
            lib.build_blocks_mapping.argtypes = [i64p, i64, i32p, i32, u64, i64, i64p]
            lib.build_blocks_mapping.restype = i64
            _LIB = lib
        return _LIB
