"""Flash-decode attention over the contiguous KV cache.

Counterpart of ``paddlefleetx_tpu/ops/decode_attention.py``.  At decode
step ``pos`` the cache [b, n, max_len, d] holds real keys in
``[0, pos + t)`` only; attention visits those (``limit = pos + t``),
folds the causal mask and the per-row left-pad mask (``kv_valid_from``)
into an online softmax with float32 state, and returns float32.

Two spellings behind :func:`flash_decode`:

  - the CUDA kernels (built on first use by ``ops/_build.py``) for
    tensors on the card.  ``flash_decode`` (the TPU's ``_decode_kernel``)
    and ``flash_decode_q8`` (``_decode_kernel_q8``, int8 caches with
    per-slot scales) each take one of two routes by q's dtype and the head
    dim only (:func:`kernel_route`): bf16 or float16 q at d = 64 or 128 the
    Hopper kernels of ``csrc/decode_attention_sm90.cu`` ("sm90": split-K
    flash-decoding over bulk copies for t <= 16, the tensor cores for a
    longer prefill), anything else the CUDA-core kernels of
    ``csrc/decode_attention.cu`` ("cuda_core");
  - :func:`decode_attention_plain`, the plain PyTorch version of
    ``_decode_lax`` (same blocked loop, same order of operations), for
    tensors on the CPU, and the reference the kernels are held against.

The paged counterpart (``_paged_lax`` / ``_paged_kernel``, the
continuous-batching engine's attention over block tables) has the same
two spellings behind :func:`paged_decode_attention`: the CUDA kernels
``paged_decode`` / ``paged_decode_q8``, on one of two routes by q's dtype
and the shapes only (:func:`paged_kernel_route`): bf16 or float16 q at d
= 64 or 128 and a block size of 8-128 (a power of two) the Hopper kernels of
``csrc/paged_attention_sm90.cu`` ("sm90": split-K over the block tables
for t <= 16, the tensor cores for a wider chunk), anything else the
CUDA-core kernel of ``csrc/paged_attention.cu`` ("cuda_core"); and
:func:`paged_decode_attention_plain`.

The routing follows the tensors' device only: a CUDA tensor reaches the
kernel or raises; nothing falls back.  :data:`COUNTS` counts kernel
launches (and the plain versions' calls) so a run can show which path
it took.

Env knobs, parsed loudly as in the JAX package:

  PFX_DECODE_BLOCK  kv block of the plain version (default 256; positive
                    multiple of 8).  The CUDA kernels tile on their own.
  PFX_DECODE_ATTN   "blocked" (default) | "dense" — the generation layer's
                    dispatch; "dense" is the attend-over-the-whole-cache
                    path kept for A/B rows
  PFX_KV_DTYPE      "bf16" (default: the cache stays in the model dtype)
                    | "int8" — quantize on write, dequantize in the kernel
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch

NEG_INF = -1e30
KV_QMAX = 127.0
_DEFAULT_BLOCK = 256
_MAX_HEAD_DIM = 128

# Kernel launches per kernel, and calls of the plain versions through
# flash_decode ("plain") and paged_decode_attention ("paged_plain") on CPU
# tensors.  "flash_decode" / "paged_decode" count every launch of the
# bf16/f32 kernel and "flash_decode_q8" / "paged_decode_q8" every launch
# of the int8 one, on either route; "<kernel>_sm90" those on the sm90
# route, and "<kernel>_sm90_prefill" those of them that took its prefill
# kernel (t > SPLIT_MAX_ROWS).  "<kernel>_multi" counts the multi-query
# launches (1 < t <= SPLIT_MAX_ROWS: the speculative verify chunk) on
# either route and "<kernel>_sm90_multi" those on the sm90 route.
# "paged_decode_chunk" / "paged_decode_q8_chunk" count the paged launches
# wider than that (t > SPLIT_MAX_ROWS: a chunked prefill's chunk, a prefix
# hit's suffix or a wide verify) on either route, and "<kernel>_sm90_chunk"
# those that took the sm90 route's tensor-core chunk kernel.  "<kernel>_f16"
# counts the launches of each kernel under float16 q (any route), so a run can
# tell the types apart.
# Process-wide; reset with reset_counts().
COUNTS = {
    "flash_decode": 0, "flash_decode_sm90": 0, "flash_decode_sm90_prefill": 0,
    "flash_decode_multi": 0, "flash_decode_sm90_multi": 0,
    "flash_decode_q8": 0, "flash_decode_q8_sm90": 0, "flash_decode_q8_sm90_prefill": 0,
    "flash_decode_q8_multi": 0, "flash_decode_q8_sm90_multi": 0,
    "plain": 0, "paged_decode": 0, "paged_decode_sm90": 0, "paged_decode_multi": 0,
    "paged_decode_sm90_multi": 0, "paged_decode_q8": 0, "paged_decode_q8_sm90": 0,
    "paged_decode_q8_multi": 0, "paged_decode_q8_sm90_multi": 0, "paged_decode_chunk": 0,
    "paged_decode_sm90_chunk": 0, "paged_decode_q8_chunk": 0, "paged_decode_q8_sm90_chunk": 0,
    "paged_plain": 0, "flash_decode_f16": 0, "flash_decode_q8_f16": 0, "paged_decode_f16": 0,
    "paged_decode_q8_f16": 0,
}

# The sm90 route (csrc/decode_attention_sm90.cu): t up to SPLIT_MAX_ROWS
# takes the split-K kernel, whose CTAs hold 1 query row at t = 1 and
# SPLIT_ROWS otherwise; a split takes at least SPLIT_MIN_KEYS keys (one
# stage of the d = 64 kernel).
SM90_HEAD_DIMS = (64, 128)
SM90_DTYPES = (torch.bfloat16, torch.float16)
SPLIT_MAX_ROWS = 16
SPLIT_ROWS = 4
SPLIT_MIN_KEYS = 64
# The sm90 paged route (csrc/paged_attention_sm90.cu): block sizes it takes,
# and the keys of a row one CTA takes (a multiple of 128 up to 512, so of
# every block size and key stage).  256 measured fastest of 128 / 256 / 512
# on rows of 6 to 1027 keys, and all three alike on phase 7's short rows,
# which take one split each (chip_smoke.py phase 6; PERF.md).
PAGED_SM90_BLOCKS = (8, 16, 32, 64, 128)
PAGED_SPLIT_KEYS = 256
# The same for the chunk kernel (t > SPLIT_MAX_ROWS): the keys of a 64-row
# query tile one CTA takes, any multiple of 128 (whole key tiles);
# chip_smoke.py phase 17 times 128 / 256 / 512 / 1024 against each other
PAGED_CHUNK_SPLIT_KEYS = 256
CHUNK_ROWS = 64


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def _count(name: str, t: int, route: str, dtype: Optional[torch.dtype] = None) -> None:
    """One launch of kernel ``name`` with ``t`` queries a row (of q's
    ``dtype``) on ``route``."""
    multi = 1 < t <= SPLIT_MAX_ROWS
    COUNTS[name] += 1
    COUNTS[f"{name}_f16"] += dtype == torch.float16
    COUNTS[f"{name}_multi"] += multi
    if name.startswith("paged"):
        COUNTS[f"{name}_chunk"] += t > SPLIT_MAX_ROWS
    if route == "sm90":
        COUNTS[f"{name}_sm90"] += 1
        COUNTS[f"{name}_sm90_multi"] += multi
        if name.startswith("paged"):
            COUNTS[f"{name}_sm90_chunk"] += t > SPLIT_MAX_ROWS


def kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """The route a CUDA launch of ``flash_decode`` takes for q of ``dtype``
    at ``head_dim``, over caches of q's dtype or int8 caches alike: "sm90"
    (``csrc/decode_attention_sm90.cu``) for bfloat16 or float16 q at d = 64
    or 128, else "cuda_core" (``csrc/decode_attention.cu``)."""
    return "sm90" if dtype in SM90_DTYPES and head_dim in SM90_HEAD_DIMS else "cuda_core"


def paged_kernel_route(dtype: torch.dtype, head_dim: int, t: int, block: int) -> str:
    """The route a CUDA launch of ``paged_decode`` takes for q of ``dtype``
    at ``head_dim`` with ``t`` queries a row over pools of ``block`` slots a
    block, pools of q's dtype or int8 pools alike: "sm90"
    (``csrc/paged_attention_sm90.cu``: split-K for t <= SPLIT_MAX_ROWS, the
    tensor-core chunk kernel above) for bfloat16 or float16 q at d = 64 or
    128, t >= 1 and a block size in PAGED_SM90_BLOCKS (each divides the
    kernels' key stages and tiles or is a multiple of them), else
    "cuda_core" (``csrc/paged_attention.cu``)."""
    if (dtype in SM90_DTYPES and head_dim in SM90_HEAD_DIMS and t >= 1
            and block in PAGED_SM90_BLOCKS):
        return "sm90"
    return "cuda_core"


def paged_splits(table_width: int, block: int, split_keys: int = PAGED_SPLIT_KEYS) -> int:
    """How many splits the sm90 paged kernel cuts each (row, head, row
    group) into: enough of ``split_keys`` keys each to cover the
    ``table_width`` x ``block`` slots of the widest row the tables allow.
    From shapes only, never from the rows' positions (no copy to the host):
    on the card a split past its row's end exits at once, so a row of
    ``positions + t`` keys runs ceil(keys / split_keys) CTAs."""
    return max(1, -(-int(table_width) * int(block) // int(split_keys)))


def paged_scratch_size(b: int, n: int, t: int, d: int, table_width: int, block: int,
                       split_keys: Optional[int] = None) -> tuple:
    """(float32 partials, int32 counters) the sm90 paged route needs for a
    launch at these shapes, (0, 0) when it takes one split: a counter per
    (row, head, group of :func:`paged_rows` queries), and per counter
    ``splits`` partial rows of d + 2 floats for each of its queries."""
    if split_keys is None:
        split_keys = PAGED_SPLIT_KEYS if t <= SPLIT_MAX_ROWS else PAGED_CHUNK_SPLIT_KEYS
    splits = paged_splits(table_width, block, split_keys)
    if splits == 1:
        return 0, 0
    rows = paged_rows(t)
    groups = b * n * -(-t // rows)
    return groups * splits * rows * (d + 2), groups


def split_rows(t: int) -> int:
    """Query rows per CTA of the sm90 split-K kernel (t <= SPLIT_MAX_ROWS)."""
    return 1 if t == 1 else SPLIT_ROWS


def paged_rows(t: int) -> int:
    """Query rows per CTA of the sm90 paged route at ``t``: the split-K
    kernel's (:func:`split_rows`), or the chunk kernel's 64-row tile above
    SPLIT_MAX_ROWS."""
    return split_rows(t) if t <= SPLIT_MAX_ROWS else CHUNK_ROWS


def decode_splits(ctas: int, keys: int, sms: int) -> int:
    """How many splits the sm90 split-K kernel cuts each of its ``ctas``
    (batch, head, row group) CTAs into: as many as keep one CTA per SM
    (``sms // ctas``), but no split under SPLIT_MIN_KEYS of the ``keys``
    (the limit).  Once every SM holds a CTA, more splits only add partials
    and the combining step: each CTA's 4-stage ring keeps its own copies
    in flight.  One split means no partials."""
    return max(1, min(sms // max(ctas, 1), keys // SPLIT_MIN_KEYS))


def _parse_int_env(name: str) -> int:
    env = os.environ.get(name) or "0"
    try:
        return int(env)
    except ValueError:
        raise ValueError(
            f"{name}={env!r} is not an integer; pass a positive multiple "
            f"of 8 (e.g. 256) or unset it"
        ) from None


def decode_block(max_len: int, block: int = 0) -> int:
    """The plain version's kv block: explicit ``block``, else
    PFX_DECODE_BLOCK, else 256; clamped to ``max_len`` and, when the clamp
    breaks alignment, rounded down to a multiple of 8 (only a cache
    shorter than 8 slots gets a smaller block)."""
    force = int(block) or _parse_int_env("PFX_DECODE_BLOCK")
    if force:
        if force < 0 or force % 8:
            raise ValueError(
                f"decode block {force} must be a positive multiple of 8 "
                "(block arg / PFX_DECODE_BLOCK)"
            )
    else:
        force = _DEFAULT_BLOCK
    clamped = min(force, max_len)
    if clamped % 8 and clamped > 8:
        clamped -= clamped % 8
    return clamped


def kv_cache_dtype(override: str = "") -> str:
    """KV-cache storage dtype: ``override`` (``Generation.speculative.
    kv_dtype``), else PFX_KV_DTYPE, else "bf16".  "bf16" means the model
    dtype (an f32 model keeps f32); "int8" quantizes on write."""
    raw = str(override or os.environ.get("PFX_KV_DTYPE") or "bf16").strip().lower()
    if raw not in ("bf16", "int8"):
        raise ValueError(f"PFX_KV_DTYPE={raw!r}; valid: bf16 (native), int8")
    return raw


def quantize_kv(x: torch.Tensor):
    """Symmetric per-vector int8 quantization: ``x`` [..., d] ->
    (int8 [..., d], float32 scales [...]) with scale = max(amax/127, 1e-8)
    and round-half-to-even, as ``jnp.round``."""
    xf = x.float()
    scl = torch.clamp(xf.abs().amax(dim=-1) / KV_QMAX, min=1e-8)
    q = torch.clamp(torch.round(xf / scl[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scl


def decode_attn_mode() -> str:
    """PFX_DECODE_ATTN: "blocked" (flash decode) or "dense"."""
    mode = os.environ.get("PFX_DECODE_ATTN") or "blocked"
    if mode not in ("blocked", "dense"):
        raise ValueError(f"PFX_DECODE_ATTN={mode!r}; valid: blocked, dense")
    return mode


def blocks_visited(limit: int, block: int, max_len: int) -> int:
    """Number of kv blocks the plain version visits for keys [0, limit)."""
    return min(-(-int(limit) // block), -(-max_len // block))


# ---------------------------------------------------------------------------
# Plain PyTorch version (``_decode_lax``)
# ---------------------------------------------------------------------------


def decode_attention_plain(
    q_t: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    limit: int,
    valid_from: Optional[torch.Tensor],
    block: int,
    scale: float,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q_t [b, n, t, d]; caches [b, n, L, d]; keys [0, limit) are real.
    Returns float32 [b, n, t, d].

    The blocked online softmax of ``_decode_lax``: the last block's start
    is clamped to ``L - block`` and its overlap with the previous block
    masked.  Dot products take the inputs as float32 (the JAX
    ``preferred_element_type=float32``); with a bf16/f32 cache the
    probabilities are rounded to the cache dtype before ``p @ v``; with
    an int8 cache the scales multiply the scores (key) and the
    probabilities (value)."""
    b, n, t, d = q_t.shape
    max_len = k_cache.shape[2]
    quant = k_scale is not None
    dev = q_t.device
    q_pos = limit - t + torch.arange(t, device=dev)
    qf = q_t.float()
    m = torch.full((b, n, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n, t, d), dtype=torch.float32, device=dev)
    for j in range(blocks_visited(limit, block, max_len)):
        start = max(min(j * block, max_len - block), 0)
        k = k_cache[:, :, start:start + block].float()
        v = v_cache[:, :, start:start + block].float()
        s = scale * torch.einsum("bntd,bnkd->bntk", qf, k)
        if quant:
            s = s * k_scale[:, :, None, start:start + block]
        col = start + torch.arange(block, device=dev)
        mask = (col[None, :] <= q_pos[:, None]) & (col[None, :] >= j * block)
        mask = mask[None, None]
        if valid_from is not None:
            mask = mask & (col[None, None, None, :] >= valid_from[:, None, None, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if quant:
            pv = p * v_scale[:, :, None, start:start + block]
        else:
            pv = p.to(v_cache.dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("bntk,bnkd->bntd", pv, v)
        m = m_new
    # fully masked rows (left-pad positions) come out 0, not NaN
    return acc / torch.clamp(l, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/decode_attention.cu, csrc/decode_attention_sm90.cu)
# ---------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None
_SM90_LIB: Optional[ctypes.CDLL] = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# split-K scratch of the sm90 routes per device: float32 partials and int32
# arrival counters, which every launch leaves zeroed.  Launches on one
# device run in stream order (eager launches and CUDA graph replays alike),
# so one pair serves them all.  A captured graph keeps the pointers it was
# captured with: a capture never allocates (reserve_split_scratch sizes the
# pair first), and the graph cache (core/step_graphs.py) holds a reference
# to the pair, so a later eager launch that grows the scratch never frees
# memory a graph still writes
_SCRATCH: dict = {}
_SMS: dict = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from paddlefleetx_tpu_torch.ops import _build

        lib = _build.load("decode_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode.argtypes = [ptr] * 5 + [i32] * 6 + [f32, i32, ptr]
        lib.flash_decode.restype = i32
        lib.flash_decode_q8.argtypes = [ptr] * 7 + [i32] * 6 + [f32, i32, ptr]
        lib.flash_decode_q8.restype = i32
        lib.flash_decode_error_string.argtypes = [i32]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _sm90_lib() -> ctypes.CDLL:
    global _SM90_LIB
    if _SM90_LIB is None:
        from paddlefleetx_tpu_torch.ops import _build

        lib = _build.load("decode_attention_sm90")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode_sm90.argtypes = [ptr] * 7 + [i32] * 7 + [f32, i32, ptr]
        lib.flash_decode_sm90.restype = i32
        lib.flash_decode_q8_sm90.argtypes = [ptr] * 9 + [i32] * 7 + [f32, i32, ptr]
        lib.flash_decode_q8_sm90.restype = i32
        lib.flash_decode_sm90_error_string.argtypes = [i32]
        lib.flash_decode_sm90_error_string.restype = ctypes.c_char_p
        _SM90_LIB = lib
    return _SM90_LIB


def reserve_split_scratch(dev: torch.device, part_floats: int, groups: int):
    """Grow the device's split-K scratch to at least ``part_floats``
    float32 partials and ``groups`` counters (the counters zeroed when
    allocated); returns (partials, counters).  A buffer is replaced, never
    resized in place: whoever captured the old one keeps it alive."""
    part, counters = _SCRATCH.get(dev.index, (None, None))
    if part is None or part.numel() < part_floats:
        part = torch.empty(max(part_floats, 1), dtype=torch.float32, device=dev)
    if counters is None or counters.numel() < groups:
        counters = torch.zeros(max(groups, 1), dtype=torch.int32, device=dev)
    _SCRATCH[dev.index] = (part, counters)
    return part, counters


def split_scratch(dev: torch.device):
    """The device's split-K scratch (partials, counters) now in use, or None."""
    return _SCRATCH.get(dev.index)


def _split_scratch(dev: torch.device, part_floats: int, groups: int):
    """(partials, counters) of at least the sizes asked.  Under a CUDA graph
    capture the reserved pair must already be large enough: allocating
    there would bake a pointer nobody keeps."""
    part, counters = _SCRATCH.get(dev.index, (None, None))
    if (part is not None and part.numel() >= part_floats and counters.numel() >= groups):
        return part, counters
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        have = (0, 0) if part is None else (part.numel(), counters.numel())
        raise RuntimeError(
            f"split-K scratch {have} (floats, counters) is smaller than this launch needs "
            f"({part_floats}, {groups}) during a CUDA graph capture: reserve_split_scratch "
            "for the largest captured step first")
    return reserve_split_scratch(dev, part_floats, groups)


def _launch_sm90(q_t, k_cache, v_cache, limit, scale, out, vf_ptr, stream, k_scale, v_scale):
    """The sm90 route, over caches of q's type, bf16 or float16
    (``flash_decode_sm90``), or int8 caches with their scales
    (``flash_decode_q8_sm90``): the split-K kernel
    for t <= SPLIT_MAX_ROWS (its split count from :func:`decode_splits`),
    the tensor-core prefill above.  TMA and the bulk copies need 16-byte
    aligned tensors."""
    dev = q_t.device
    b, n, t, d = q_t.shape
    L = k_cache.shape[2]
    for x in (q_t, k_cache, v_cache):
        _require(x.data_ptr() % 16 == 0, "the sm90 route needs 16-byte aligned tensors")
    splits, part, counters = 1, None, None
    if t <= SPLIT_MAX_ROWS:
        rows = split_rows(t)
        groups = b * n * -(-t // rows)
        if dev.index not in _SMS:
            _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = decode_splits(groups, int(limit), _SMS[dev.index])
        if splits > 1:
            part, counters = _split_scratch(dev, groups * splits * rows * (d + 2), groups)
    lib = _sm90_lib()
    scratch = (out.data_ptr(), None if part is None else part.data_ptr(),
               None if counters is None else counters.data_ptr(),
               b, n, t, L, d, int(limit), splits, float(scale), _DTYPE_CODES[q_t.dtype], stream)
    if k_scale is not None:
        name = "flash_decode_q8"
        rc = lib.flash_decode_q8_sm90(q_t.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                      k_scale.data_ptr(), v_scale.data_ptr(), vf_ptr, *scratch)
    else:
        name = "flash_decode"
        rc = lib.flash_decode_sm90(q_t.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                   vf_ptr, *scratch)
    if rc != 0:
        msg = lib.flash_decode_sm90_error_string(rc).decode()
        raise RuntimeError(f"{name} (sm90) kernel launch failed: CUDA error {rc} ({msg})")
    _count(name, t, "sm90", q_t.dtype)
    if t > SPLIT_MAX_ROWS:
        COUNTS[f"{name}_sm90_prefill"] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode: {msg}")


def _launch(q_t, k_cache, v_cache, limit, valid_from, scale, k_scale, v_scale):
    """Check the inputs, allocate the float32 output and launch on the
    current stream."""
    dev = q_t.device
    b, n, t, d = q_t.shape
    L = k_cache.shape[2]
    quant = k_scale is not None
    _require(q_t.dtype in _DTYPE_CODES,
             f"q dtype {q_t.dtype}; valid: float32, bfloat16, float16")
    _require(tuple(k_cache.shape) == (b, n, L, d) and v_cache.shape == k_cache.shape,
             f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} vs q {tuple(q_t.shape)}")
    _require(1 <= d <= _MAX_HEAD_DIM, f"head dim {d} outside [1, {_MAX_HEAD_DIM}]")
    _require(1 <= t <= limit <= L, f"need 1 <= t ({t}) <= limit ({limit}) <= L ({L})")
    _require(b * n <= 65535, f"batch*heads {b * n} > 65535")
    tensors = [q_t, k_cache, v_cache]
    if quant:
        _require(k_cache.dtype == torch.int8 and v_cache.dtype == torch.int8,
                 f"int8 path needs int8 caches, got {k_cache.dtype}/{v_cache.dtype}")
        for s in (k_scale, v_scale):
            _require(s.dtype == torch.float32 and tuple(s.shape) == (b, n, L),
                     f"scales must be float32 [b, n, L], got {s.dtype} {tuple(s.shape)}")
        tensors += [k_scale, v_scale]
    else:
        _require(k_cache.dtype == q_t.dtype and v_cache.dtype == q_t.dtype,
                 f"cache dtype {k_cache.dtype}/{v_cache.dtype} != q dtype {q_t.dtype}")
    if valid_from is not None:
        _require(valid_from.dtype == torch.int32 and tuple(valid_from.shape) == (b,),
                 f"kv_valid_from must be int32 [b], got {valid_from.dtype} "
                 f"{tuple(valid_from.shape)}")
        tensors.append(valid_from)
    for x in tensors:
        _require(x.device == dev, f"tensor on {x.device}, q on {dev}")
        _require(x.is_contiguous(), "inputs must be contiguous")
    out = torch.empty((b, n, t, d), dtype=torch.float32, device=dev)
    vf_ptr = valid_from.data_ptr() if valid_from is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel_route(q_t.dtype, d) == "sm90":
        _launch_sm90(q_t, k_cache, v_cache, limit, scale, out, vf_ptr, stream, k_scale, v_scale)
        return out
    lib = _lib()
    if quant:
        rc = lib.flash_decode_q8(
            q_t.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), vf_ptr, out.data_ptr(),
            b, n, t, L, d, int(limit), float(scale), _DTYPE_CODES[q_t.dtype], stream,
        )
        name = "flash_decode_q8"
    else:
        rc = lib.flash_decode(
            q_t.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), vf_ptr,
            out.data_ptr(), b, n, t, L, d, int(limit), float(scale),
            _DTYPE_CODES[q_t.dtype], stream,
        )
        name = "flash_decode"
    if rc != 0:
        msg = lib.flash_decode_error_string(rc).decode()
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {rc} ({msg})")
    _count(name, t, "cuda_core", q_t.dtype)
    return out


def flash_decode(
    q_t: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    limit: int,
    valid_from: Optional[torch.Tensor],
    scale: float,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block: int = 0,
) -> torch.Tensor:
    """The kernel wrapper (``_decode_pallas``'s contract): q_t [b, n, t, d],
    caches [b, n, L, d] (int8 with float32 ``k_scale``/``v_scale`` [b, n, L]
    for the q8 kernel), ``limit`` a Python int (keys [0, limit) are real),
    ``valid_from`` int32 [b] or None.  Returns float32 [b, n, t, d].

    CUDA tensors launch the kernel of their route (:func:`kernel_route`)
    or raise; CPU tensors run :func:`decode_attention_plain` with
    ``decode_block(L, block)``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if q_t.device.type == "cuda":
        return _launch(q_t, k_cache, v_cache, limit, valid_from, scale, k_scale, v_scale)
    if q_t.device.type != "cpu":
        raise ValueError(f"flash_decode: unsupported device {q_t.device}")
    COUNTS["plain"] += 1
    bs = decode_block(k_cache.shape[2], block)
    return decode_attention_plain(
        q_t, k_cache, v_cache, limit, valid_from, bs, scale, k_scale, v_scale
    )


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    *,
    kv_valid_from: Optional[torch.Tensor] = None,
    block: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over keys [0, pos + t): q [b, t, n, d] at positions
    [pos, pos + t) (its K/V already written), caches [b, n, L, d].
    Returns [b, t, n, d] in q's dtype."""
    b, t, n, d = q.shape
    scale = float(1.0 / (d**0.5))
    q_t = q.transpose(1, 2).contiguous()
    out = flash_decode(
        q_t, k_cache, v_cache, int(pos) + t, kv_valid_from, scale,
        k_scale, v_scale, block,
    )
    return out.transpose(1, 2).to(q.dtype)


def dense_cache_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    *,
    kv_valid_from: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The attend-over-the-whole-cache path (PFX_DECODE_ATTN=dense): a
    materialized [., 1, t, L] additive bias and a full softmax, as the
    JAX ``dense_cache_attention``.  An int8 cache is dequantized up front
    (in float32, cast once).  Returns [b, t, n, d] in q's dtype."""
    b, t, n, d = q.shape
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if k_scale is not None:
        k_cache = (k_cache.float() * k_scale[..., None]).to(q.dtype)
        v_cache = (v_cache.float() * v_scale[..., None]).to(q.dtype)
    max_len = k_cache.shape[2]
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    q_pos = int(pos) + torch.arange(t, device=dev)[:, None]
    k_pos = torch.arange(max_len, device=dev)[None, :]
    zero = torch.zeros((), device=dev)
    big = torch.full((), -1e9, device=dev)
    bias = torch.where(k_pos <= q_pos, zero, big)[None, None]  # [1, 1, t, L]
    if kv_valid_from is not None:
        bias = bias + torch.where(k_pos >= kv_valid_from[:, None], zero, big)[:, None, None, :]
    scores = torch.einsum("btnd,bnkd->bntk", q.float(), k_cache.float()) * scale
    scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bntk,bnkd->bntd", probs, v_cache)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Paged (block-table-indexed) decode attention: the continuous-batching
# engine's kernel (core/paged_cache.py owns the pool layout)
# ---------------------------------------------------------------------------


def paged_decode_attention_plain(
    q_t: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    positions: torch.Tensor,
    scale: float,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of ``_paged_lax``: q_t [b, n, t, d];
    pools [nb, n, bs, d]; tables [b, M] pool block ids; positions [b] the
    slot of each row's FIRST query (query qi sits at slot positions + qi,
    causal within the chunk).  Returns float32 [b, n, t, d].

    Blocked online softmax over each row's own block list, with the
    JAX loop's bound (the batch max of the blocks needed, capped at M)
    and its per-row clamp: a row past its last needed block
    ``(pos + t - 1) // bs`` re-reads that block, fully masked, so a
    table entry beyond it (null padding) is never gathered.  float32
    state, ``acc / max(l, 1e-30)``; int8 pools take ``k_scale`` /
    ``v_scale`` [nb, n, bs] on the scores and the probabilities."""
    b, n, t, d = q_t.shape
    bs = k_pool.shape[2]
    M = tables.shape[1]
    quant = k_scale is not None
    dev = q_t.device
    tables = tables.long()
    positions = positions.long()
    qf = q_t.float()
    m = torch.full((b, n, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n, t, d), dtype=torch.float32, device=dev)
    last_blk = torch.clamp(positions + t - 1, min=0) // bs
    qpos = positions[:, None] + torch.arange(t, device=dev)[None, :]  # [b, t]
    rows = torch.arange(b, device=dev)
    nvisit = min((int(positions.max()) + t + bs - 1) // bs, M)
    for j in range(nvisit):
        blk = tables[rows, torch.clamp(last_blk, max=j)]  # [b]
        k = k_pool[blk].float()  # [b, n, bs, d] gather
        v = v_pool[blk].float()
        s = scale * torch.einsum("bntd,bnkd->bntk", qf, k)
        if quant:
            s = s * k_scale[blk][:, :, None, :]
        col = j * bs + torch.arange(bs, device=dev)
        mask = col[None, None, None, :] <= qpos[:, None, :, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if quant:
            pv = p * v_scale[blk][:, :, None, :]
        else:
            pv = p.to(v_pool.dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("bntk,bnkd->bntd", pv, v)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


_PAGED_LIB: Optional[ctypes.CDLL] = None
_PAGED_SM90_LIB: Optional[ctypes.CDLL] = None
_MAX_PAGED_BLOCK = 128


def _paged_lib() -> ctypes.CDLL:
    global _PAGED_LIB
    if _PAGED_LIB is None:
        from paddlefleetx_tpu_torch.ops import _build

        lib = _build.load("paged_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode.argtypes = [ptr] * 6 + [i32] * 7 + [f32, i32, ptr]
        lib.paged_decode.restype = i32
        lib.paged_decode_q8.argtypes = [ptr] * 8 + [i32] * 7 + [f32, i32, ptr]
        lib.paged_decode_q8.restype = i32
        lib.paged_decode_error_string.argtypes = [i32]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _PAGED_LIB = lib
    return _PAGED_LIB


def _paged_sm90_lib() -> ctypes.CDLL:
    global _PAGED_SM90_LIB
    if _PAGED_SM90_LIB is None:
        from paddlefleetx_tpu_torch.ops import _build

        lib = _build.load("paged_attention_sm90")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_sm90.argtypes = [ptr] * 8 + [i32] * 9 + [f32, i32, ptr]
        lib.paged_decode_sm90.restype = i32
        lib.paged_decode_q8_sm90.argtypes = [ptr] * 10 + [i32] * 9 + [f32, i32, ptr]
        lib.paged_decode_q8_sm90.restype = i32
        lib.paged_decode_sm90_error_string.argtypes = [i32]
        lib.paged_decode_sm90_error_string.restype = ctypes.c_char_p
        _PAGED_SM90_LIB = lib
    return _PAGED_SM90_LIB


def _paged_launch_sm90(q_t, k_pool, v_pool, tables, positions, scale, k_scale, v_scale, out,
                       stream, split_keys):
    """The sm90 route over pools of q's type, bf16 or float16
    (``paged_decode_sm90``), or int8 pools with their scales
    (``paged_decode_q8_sm90``): the split-K kernel for t
    <= SPLIT_MAX_ROWS, the tensor-core chunk kernel above (the C entry
    chooses by t), :func:`paged_splits` CTAs of ``split_keys`` keys for
    each (row, head, group of :func:`paged_rows` queries).  The scratch
    comes from :func:`_split_scratch` (shared with the contiguous route:
    launches on one device run in stream order).  TMA and the bulk copies need
    16-byte aligned tensors."""
    dev = q_t.device
    b, n, t, d = q_t.shape
    nb, _, bs, _ = k_pool.shape
    M = tables.shape[1]
    tensors = (q_t, k_pool, v_pool) + (() if k_scale is None else (k_scale, v_scale))
    for x in tensors:
        _paged_require(x.data_ptr() % 16 == 0, "the sm90 route needs 16-byte aligned tensors")
    if split_keys is None:
        split_keys = PAGED_SPLIT_KEYS if t <= SPLIT_MAX_ROWS else PAGED_CHUNK_SPLIT_KEYS
    splits = paged_splits(M, bs, split_keys)
    part_floats, groups = paged_scratch_size(b, n, t, d, M, bs, split_keys)
    part = counters = None
    if splits > 1:
        part, counters = _split_scratch(dev, part_floats, groups)
    lib = _paged_sm90_lib()
    args = (tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            b, n, t, M, bs, d, nb, splits, split_keys, float(scale), _DTYPE_CODES[q_t.dtype],
            stream)
    if k_scale is not None:
        rc = lib.paged_decode_q8_sm90(q_t.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                                      k_scale.data_ptr(), v_scale.data_ptr(), *args)
    else:
        rc = lib.paged_decode_sm90(q_t.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *args)
    if rc != 0:
        msg = lib.paged_decode_sm90_error_string(rc).decode()
        raise RuntimeError(f"paged_decode (sm90) kernel launch failed: CUDA error {rc} ({msg})")


def _paged_require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_decode: {msg}")


def _paged_launch(q_t, k_pool, v_pool, tables, positions, scale, k_scale, v_scale, route=None,
                  split_keys=None):
    """Check the inputs, allocate the float32 output and launch on the
    current stream, on the route :func:`paged_kernel_route` gives.
    ``tables`` and ``positions`` must already be int32 CUDA tensors (the
    engine uploads them once per step).  ``route`` and ``split_keys`` are
    for measurements only (``chip_smoke.py`` times the CUDA-core route at
    the sm90 route's shapes, and the sm90 kernels at other split sizes than
    PAGED_SPLIT_KEYS / PAGED_CHUNK_SPLIT_KEYS): the wrapper never passes
    them, and "sm90" where the shapes do not take it raises."""
    dev = q_t.device
    b, n, t, d = q_t.shape
    nb, _, bs, _ = k_pool.shape
    M = tables.shape[1] if tables.dim() == 2 else -1
    quant = k_scale is not None
    _paged_require(q_t.dtype in _DTYPE_CODES,
                   f"q dtype {q_t.dtype}; valid: float32, bfloat16, float16")
    _paged_require(tuple(k_pool.shape) == (nb, n, bs, d) and v_pool.shape == k_pool.shape,
                   f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} vs q "
                   f"{tuple(q_t.shape)}")
    _paged_require(1 <= d <= _MAX_HEAD_DIM, f"head dim {d} outside [1, {_MAX_HEAD_DIM}]")
    _paged_require(bs % 8 == 0 and 8 <= bs <= _MAX_PAGED_BLOCK,
                   f"block size {bs} must be a multiple of 8 in [8, {_MAX_PAGED_BLOCK}]")
    _paged_require(b * n <= 65535, f"batch*heads {b * n} > 65535")
    _paged_require(tables.dtype == torch.int32 and tuple(tables.shape) == (b, M) and M >= 1,
                   f"tables must be int32 [b, M], got {tables.dtype} {tuple(tables.shape)}")
    _paged_require(positions.dtype == torch.int32 and tuple(positions.shape) == (b,),
                   f"positions must be int32 [b], got {positions.dtype} "
                   f"{tuple(positions.shape)}")
    tensors = [q_t, k_pool, v_pool, tables, positions]
    if quant:
        _paged_require(k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8,
                       f"int8 path needs int8 pools, got {k_pool.dtype}/{v_pool.dtype}")
        for s in (k_scale, v_scale):
            _paged_require(s.dtype == torch.float32 and tuple(s.shape) == (nb, n, bs),
                           f"scales must be float32 [nb, n, bs], got {s.dtype} "
                           f"{tuple(s.shape)}")
        tensors += [k_scale, v_scale]
    else:
        _paged_require(k_pool.dtype == q_t.dtype and v_pool.dtype == q_t.dtype,
                       f"pool dtype {k_pool.dtype}/{v_pool.dtype} != q dtype {q_t.dtype}")
    for x in tensors:
        _paged_require(x.device == dev, f"tensor on {x.device}, q on {dev}")
        _paged_require(x.is_contiguous(), "inputs must be contiguous")
    shape_route = paged_kernel_route(q_t.dtype, d, t, bs)
    route = route or shape_route
    _paged_require(route == "cuda_core" or shape_route == "sm90",
                   f"the sm90 route does not take q {q_t.dtype}, d={d}, t={t}, block {bs}")
    out = torch.empty((b, n, t, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = "paged_decode_q8" if quant else "paged_decode"
    if route == "sm90":
        _paged_launch_sm90(q_t, k_pool, v_pool, tables, positions, scale, k_scale, v_scale, out,
                           stream, split_keys)
        _count(name, t, "sm90", q_t.dtype)
        return out
    lib = _paged_lib()
    if quant:
        rc = lib.paged_decode_q8(
            q_t.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            b, n, t, M, bs, d, nb, float(scale), _DTYPE_CODES[q_t.dtype], stream,
        )
    else:
        rc = lib.paged_decode(
            q_t.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(), b, n, t, M, bs, d, nb, float(scale),
            _DTYPE_CODES[q_t.dtype], stream,
        )
    if rc != 0:
        msg = lib.paged_decode_error_string(rc).decode()
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {rc} ({msg})")
    _count(name, t, "cuda_core", q_t.dtype)
    return out


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Block-table-indexed attention for the paged KV cache (the
    ``paged_decode_attention`` of the JAX package).

    q [b, t, n, d]; pools [num_blocks, n, block, d] (one layer's arena);
    ``tables`` [b, M] int32 maps row i's logical block j to a pool block;
    ``positions`` [b] int32 is the slot of each row's first query (its
    chunk already written): query qi of row i attends over slots
    [0, positions[i] + qi + 1).  t = 1 is the decode step, t > 1 the
    speculative verify chunk or a chunked prefill's chunk.  int8 pools take float32 ``k_scale`` /
    ``v_scale`` [num_blocks, n, block] (both or neither).  Returns
    [b, t, n, d] in q's dtype.

    CUDA tensors launch ``paged_decode`` / ``paged_decode_q8`` on the
    route of :func:`paged_kernel_route` (or raise); CPU tensors run
    :func:`paged_decode_attention_plain`."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    b, t, n, d = q.shape
    if t < 1:
        raise ValueError(f"paged_decode_attention needs t >= 1; got t={t}")
    scale = float(1.0 / (d**0.5))
    q_t = q.transpose(1, 2).contiguous()
    if q.device.type == "cuda":
        out = _paged_launch(q_t, k_pool, v_pool, tables, positions, scale, k_scale, v_scale)
    elif q.device.type == "cpu":
        COUNTS["paged_plain"] += 1
        out = paged_decode_attention_plain(
            q_t, k_pool, v_pool, tables, positions, scale, k_scale, v_scale
        )
    else:
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    return out.transpose(1, 2).to(q.dtype)
