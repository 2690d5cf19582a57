"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``), at first use, into ``build/torch_kernels/``
under the checkout.  The library's file name carries a hash of the
source, of every ``csrc/*.cuh`` header and of the flags, so an edited
source or header rebuilds and an unchanged one loads at once; a build
writes to a private temporary name and renames it into place, so
processes building the same library at the same time do not corrupt it.
``-Xptxas -v`` register/spill lines are kept beside the library
(:func:`build_log`).  :func:`use_build_dir` moves the directory before any
library loads (the serve CLI's ``--compile-cache-dir``: replicas sharing
one directory build each library once, and a spawn into a filled
directory only loads); every ``nvcc`` a process starts is logged and
listed in ``BUILT``.

Nothing here runs at import: the CPU test suite imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

from paddlefleetx_tpu_torch.utils.log import logger

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("decode_attention", "decode_attention_sm90", "paged_attention", "flash_attention",
           "flash_attention_sm90", "fused_layernorm", "paged_attention_sm90")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILT: List[str] = []  # the libraries this process compiled, in order


def use_build_dir(path) -> Path:
    """Build into and load from ``path`` from now on, in place of
    ``build/torch_kernels/``; returns it, resolved.  Raises
    ``RuntimeError`` when a library was already loaded from another
    directory (a process keeps the libraries it loaded)."""
    global BUILD_DIR
    new = Path(path).resolve()
    with _LOCK:
        if _LIBS and new != BUILD_DIR:
            raise RuntimeError(
                f"kernel libraries {sorted(_LIBS)} are already loaded from {BUILD_DIR}; "
                f"the build directory must be set to {new} before the first kernel call")
        BUILD_DIR = new
    return new


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc``
    on the PATH; raises when none exists."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are built from paddlefleetx_tpu_torch/csrc at first use"
    )


def _target(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # what a source may include
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join([nvcc] + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build every named library that is missing, one ``nvcc`` per
    source, all started together; returns name -> library path.  Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _target(name, nvcc) for name in names}
    procs: List = []
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        logger.info(f"kernel build: nvcc {name}.cu -> {path}")
        BUILT.append(name)
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The ``nvcc`` output (``-Xptxas -v`` register and spill lines) of the
    library currently built for ``name``; empty when it was built by an
    earlier process that left no log."""
    log = _target(name, nvcc_path()).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    Loaded once per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib
