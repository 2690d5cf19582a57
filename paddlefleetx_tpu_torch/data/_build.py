"""Build the port's C++ host libraries with ``g++`` and load them with ctypes.

Two sources, each the port's copy of a JAX package source:

  - ``csrc/data_helpers.cpp`` (``data/cpp/helpers.cpp``): the index-map
    builders, loaded by :func:`load`;
  - ``csrc/bpe.cpp`` (``data/cpp/bpe.cpp``): the GPT tokenizer's byte-level
    BPE merge engine, loaded by :func:`load_bpe`.

Each compiles with ``g++ -O3 -std=c++17 -shared -fPIC`` at first use into
``build/<name>/`` under the checkout, never into the JAX package's tree.
The library's file name carries a hash of the source and the flags, so an
edited source rebuilds; a build writes to a private temporary name and
renames it into place, so processes building at the same time do not
corrupt it.  A failed build raises: there is no fallback (``data/indexed.py``
keeps the numpy versions of the index builders as the plain versions the
tests use; the tokenizer's Python merge loop serves only the words the
engine cannot take).

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
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "data_helpers.cpp"
BPE_SOURCE = CSRC / "bpe.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found (set CXX or put g++ on PATH): the port's host libraries "
            "(csrc/data_helpers.cpp, csrc/bpe.cpp) are built at first use"
        )
    return cxx


def build(source: Path, name: str) -> Path:
    """The library of ``source`` under ``build/<name>/``, built first if it
    is missing.  Raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    source = Path(source)
    cxx = _compiler()
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join([cxx] + FLAGS).encode())
    out_dir = BUILD_ROOT / name
    path = out_dir / f"{name}-{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    out = subprocess.run([cxx, *FLAGS, str(source), "-o", str(tmp)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{source.name} build failed (g++ exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded index-helper library with its four builders typed; built
    and loaded once per process."""
    with _LOCK:
        lib = _LIBS.get("data_helpers")
        if lib is None:
            lib = ctypes.CDLL(str(build(SOURCE, "data_helpers")))
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
            _LIBS["data_helpers"] = lib
        return lib


def load_bpe() -> ctypes.CDLL:
    """The loaded BPE merge engine with ``bpe_new`` / ``bpe_free`` /
    ``bpe_encode_word`` typed as the JAX ``data/cpp/build.py:49-62`` types
    them; built and loaded once per process."""
    with _LOCK:
        lib = _LIBS.get("bpe")
        if lib is None:
            lib = ctypes.CDLL(str(build(BPE_SOURCE, "bpe")))
            lib.bpe_new.restype = ctypes.c_void_p
            lib.bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                                    ctypes.c_int64]
            lib.bpe_free.restype = None
            lib.bpe_free.argtypes = [ctypes.c_void_p]
            lib.bpe_encode_word.restype = ctypes.c_int32
            lib.bpe_encode_word.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                                            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            _LIBS["bpe"] = lib
        return lib
