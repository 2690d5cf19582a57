"""Index-map builders for Megatron-style token datasets.

Counterpart of ``paddlefleetx_tpu/data/indexed.py`` (``build_sample_idx:42``,
``build_shuffle_idx:92``, ``build_doc_idx:103``,
``build_blending_indices:119``).  Two spellings of the two walks:

  - the C++ helpers of ``csrc/data_helpers.cpp`` (``use_cpp=True``, the
    default), built by ``data/_build.py`` at first use; a failed build
    raises;
  - numpy versions with identical outputs (``use_cpp=False``): the plain
    versions the tests hold the helpers against.

The shuffles draw from the ``numpy.random.Generator`` the caller passes,
so the same seed gives the JAX package's maps bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray, seq_length: int,
                     num_epochs: int, tokens_per_epoch: int,
                     use_cpp: bool = True) -> np.ndarray:
    """Map each training sample to (doc_idx position, in-doc offset):
    int32 [num_samples + 1, 2]; sample i spans boundary i to boundary
    i + 1 (seq_length + 1 tokens, the +1 for the shifted label)."""
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, dtype=np.int32)
    num_samples = (num_epochs * tokens_per_epoch - 1) // seq_length
    out = np.zeros((num_samples + 1, 2), dtype=np.int32)
    if use_cpp:
        from paddlefleetx_tpu_torch.data import _build

        _build.load().build_sample_idx(_ptr(sizes, ctypes.c_int32), _ptr(doc_idx, ctypes.c_int32),
                                       seq_length, num_samples, _ptr(out, ctypes.c_int32))
        return out
    di, offset = 0, 0
    for i in range(1, num_samples + 1):
        remaining = seq_length
        while remaining > 0:
            doc_len = sizes[doc_idx[di]] - offset
            if doc_len > remaining:
                offset += remaining
                remaining = 0
            else:
                remaining -= doc_len
                di += 1
                offset = 0
        out[i] = (di, offset)
    return out


def build_shuffle_idx(num_samples: int, total_size: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Two-part shuffle: the samples inside the requested range shuffled
    apart from the epoch's tail."""
    dtype = np.int64 if total_size >= 2**31 else np.int32
    first = np.arange(num_samples, dtype=dtype)
    rng.shuffle(first)
    last = np.arange(num_samples, total_size, dtype=dtype)
    rng.shuffle(last)
    return np.concatenate([first, last])


def build_doc_idx(num_docs: int, num_epochs: int, rng: np.random.Generator,
                  separate_last: bool = True) -> np.ndarray:
    """Shuffled doc order over epochs; the last epoch shuffled on its own
    (for exact sample counts) unless ``separate_last`` is off."""
    if num_epochs <= 1 or not separate_last:
        idx = np.tile(np.arange(num_docs, dtype=np.int32), max(num_epochs, 1))
        rng.shuffle(idx)
        return idx
    head = np.tile(np.arange(num_docs, dtype=np.int32), num_epochs - 1)
    rng.shuffle(head)
    tail = np.arange(num_docs, dtype=np.int32)
    rng.shuffle(tail)
    return np.concatenate([head, tail])


def build_blending_indices(weights: np.ndarray, num_samples: int,
                           use_cpp: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Interleave datasets by weight: each sample comes from the dataset
    whose emitted share lags its weight most.  Returns (dataset index int8
    [num_samples], sample index within it int64 [num_samples])."""
    weights = np.asarray(weights, dtype=np.float64)
    weights = np.ascontiguousarray(weights / weights.sum())
    n = len(weights)
    ds_index = np.zeros(num_samples, dtype=np.int8)
    ds_sample = np.zeros(num_samples, dtype=np.int64)
    if use_cpp:
        from paddlefleetx_tpu_torch.data import _build

        _build.load().build_blending_indices(_ptr(weights, ctypes.c_double), n, num_samples,
                                             _ptr(ds_index, ctypes.c_int8),
                                             _ptr(ds_sample, ctypes.c_int64))
        return ds_index, ds_sample
    counts = np.zeros(n, dtype=np.int64)
    for i in range(num_samples):
        d = int(np.argmax(weights * (i + 1) - counts))
        ds_index[i] = d
        ds_sample[i] = counts[d]
        counts[d] += 1
    return ds_index, ds_sample
