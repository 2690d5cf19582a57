"""Index-map cache integrity: atomic ``.npy`` writes, a cross-process
build lock, and validated loads with loud quarantine on corruption.

Counterpart of ``paddlefleetx_tpu/data/index_cache.py``.  The GPT index
maps (doc/sample/shuffle, ``data/gpt_dataset.py``) are built once and
cached beside the corpus:

  - every write goes to a temporary name and ``os.replace``s into place,
    so a cache file is either absent or complete;
  - ``index_map_lock`` serialises builders of one cache prefix across
    processes with an ``fcntl`` file lock; builders re-check the cache
    after acquiring it, so one process pays the build;
  - cached arrays are validated against their expected shape and dtype on
    load; a file that fails to parse or validate is quarantined (renamed
    ``*.corrupt``, ``utils/checkpoint.corrupt_rename``) with every other
    file of its set, and the caller rebuilds.

The cache files are the JAX package's (same names, same arrays), so the
two packages can share a corpus directory.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Tuple

import numpy as np

from paddlefleetx_tpu_torch.utils.checkpoint import corrupt_rename
from paddlefleetx_tpu_torch.utils.log import logger


def atomic_save_npy(path: str, arr: np.ndarray) -> None:
    """Write ``path`` (ending in ``.npy``) through a temporary file and a
    rename."""
    if not path.endswith(".npy"):
        raise ValueError(f"atomic_save_npy expects a .npy path, got {path}")
    tmp = f"{path[:-4]}.tmp{os.getpid()}.npy"
    try:
        np.save(tmp, arr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def quarantine_cache_file(path: str) -> Optional[str]:
    """Rename a corrupt cache file to ``*.corrupt``; returns the new path,
    or None when another process already renamed or removed it."""
    dst = corrupt_rename(path)
    if dst is not None:
        logger.error(f"QUARANTINED corrupt index-map cache: {path} -> {dst} (rebuilding "
                     "from the corpus; inspect or delete the .corrupt file)")
    return dst


@contextlib.contextmanager
def index_map_lock(cache_prefix: str):
    """Cross-process advisory lock over the build of one cache prefix
    (``<prefix>.lock``, left in place).  On an unwritable cache dir the
    build runs unlocked and the maps stay in memory."""
    import fcntl

    lock_path = cache_prefix + ".lock"
    try:
        f = open(lock_path, "a")
    except OSError as e:
        logger.warning(f"index-map lock {lock_path} unavailable ({e})")
        yield
        return
    try:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield
    finally:
        with contextlib.suppress(OSError):
            fcntl.flock(f, fcntl.LOCK_UN)
        f.close()


def load_index_cache(
    cache_prefix: str, expect: Dict[str, Tuple[Tuple[int, ...], type]],
) -> Optional[Dict[str, np.ndarray]]:
    """The cached maps of ``cache_prefix`` (``expect``: name -> (shape,
    dtype)) when every file is present and valid; None when any is
    missing, or when one fails to parse or validate, after quarantining
    the whole set."""
    paths = {name: f"{cache_prefix}_{name}.npy" for name in expect}
    if not all(os.path.exists(p) for p in paths.values()):
        return None
    out: Dict[str, np.ndarray] = {}
    for name, path in paths.items():
        shape, dtype = expect[name]
        try:
            arr = np.load(path, allow_pickle=False)
        except (ValueError, OSError, EOFError) as e:
            logger.error(f"index-map cache {path} unreadable: {e}")
            _quarantine_set(paths)
            return None
        if tuple(arr.shape) != tuple(shape) or arr.dtype != np.dtype(dtype):
            logger.error(f"index-map cache {path} shape/dtype mismatch: got "
                         f"{arr.shape}/{arr.dtype}, expected {tuple(shape)}/{np.dtype(dtype)}")
            _quarantine_set(paths)
            return None
        out[name] = arr
    return out


def _quarantine_set(paths: Dict[str, str]) -> None:
    for p in paths.values():
        if os.path.exists(p):
            quarantine_cache_file(p)


def save_index_cache(cache_prefix: str, maps: Dict[str, np.ndarray]) -> bool:
    """Write every map atomically; False (a warning, the maps stay in
    memory) on unwritable storage."""
    try:
        for name, arr in maps.items():
            atomic_save_npy(f"{cache_prefix}_{name}.npy", arr)
        return True
    except OSError as e:
        logger.warning(f"index cache not written: {e}")
        return False
