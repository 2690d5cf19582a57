"""Causal flash attention: the CUDA kernels K3-K6 and their plain versions.

Counterpart of ``paddlefleetx_tpu/ops/flash_attention.py``.  Inputs are
[batch, seq, heads, head_dim] (model layout); the kernels run on
[batch*heads, seq, head_dim], as the JAX wrapper's transpose does.  The
forward saves the float32 per-row logsumexp for the backward (the
FlashAttention-2 scheme: dq swept over key blocks, dk/dv over query
blocks).

Two spellings of every kernel, chosen by the tensors' device only:

  - the CUDA kernels (built on first use by ``ops/_build.py``) for
    tensors on the card: ``flash_fwd`` (the TPU's ``_fwd_kernel``),
    ``flash_bwd_dq`` + ``flash_bwd_dkv`` (the split backward,
    ``_dq_kernel`` + ``_dkv_kernel``) and ``flash_bwd_fused``
    (``_bwd_fused_kernel``);
  - :func:`flash_forward`, :func:`flash_bwd_split` and
    :func:`flash_bwd_fused`, plain PyTorch versions of the TPU kernels
    (same block loops, same order of operations, same roundings to the
    input type), for tensors on the CPU and as the reference the kernels
    are held against.

On the card the route is chosen by the input type and nothing else
(:func:`kernel_route`): bfloat16 K3-K6 take the tensor-core kernels of
``csrc/flash_attention_sm90.cu`` (``wgmma`` on TMA-fed shared-memory
rings; route ``sm90``); float32 K3-K6 take the CUDA-core kernels of
``csrc/flash_attention.cu`` (route ``cuda_core``; float32 stays in full
FP32 there, where tensor cores would make it TF32).  Anything neither
route takes raises in :func:`_check_inputs`.  A CUDA tensor reaches a
kernel or raises; nothing falls back.  :data:`COUNTS` counts kernel
launches (each kernel's name counts every launch on either route, the
``*_sm90`` keys the tensor-core ones) and plain-version calls.

Block sizes: the knob handling is the JAX package's, copied
(``_block_sizes``, ``_parse_block_env``, ``_check_block``,
``_block_k_override``, ``_resolve_bwd_schedule``, ``flash_supported``),
so on the CPU the same seq takes flash or the plain attention path in
both packages, and the same bad ``Model.flash_block`` /
``PFX_FLASH_BLOCK`` / ``PFX_FLASH_BLOCK_K`` / ``PFX_FLASH_BWD`` values
raise everywhere.  ``(block_q, block_k)`` drives the plain versions'
loops.  The CUDA kernels tile by their own (query, key) tile
(:data:`KERNEL_TILES`, :func:`kernel_tile`) whatever the block and mask a
partial last tile, so on the card every seq takes them: the block then
changes only the order in which the float32 sums round, not the values
computed.

The forward is the custom op ``pfx::flash_attn_fwd`` (one op returning
out and lse), so a selective-recompute policy can name it
(``models/gpt/model._layer_remat``); :class:`FlashAttention` is the
autograd Function around it.
"""

import ctypes
import os
from typing import Optional, Tuple

import torch
from torch import Tensor

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")
# (query, key) tile of each kernel per route: the block at which the plain
# versions round as the kernel does.  Head dim 64 and 128 tile alike.
KERNEL_TILES = {
    ("flash_fwd", "sm90"): (128, 128),
    ("flash_bwd_dq", "sm90"): (128, 64),
    ("flash_bwd_dkv", "sm90"): (64, 128),
    ("flash_bwd_fused", "sm90"): (64, 128),
    ("flash_fwd", "cuda_core"): (64, 64),
    ("flash_bwd_dq", "cuda_core"): (64, 64),
    ("flash_bwd_dkv", "cuda_core"): (64, 64),
    ("flash_bwd_fused", "cuda_core"): (64, 64),
}

# Kernel launches per kernel (the *_sm90 keys: the tensor-core route's
# share), and calls of the plain versions on CPU tensors ("flash_plain").
# Process-wide; reset with reset_counts().
COUNTS = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_bwd_fused": 0,
    "flash_fwd_sm90": 0, "flash_bwd_dq_sm90": 0, "flash_bwd_dkv_sm90": 0,
    "flash_bwd_fused_sm90": 0, "flash_plain": 0,
}


def kernel_route(name: str, dtype: torch.dtype) -> str:
    """The route a CUDA launch of kernel ``name`` takes for inputs of
    ``dtype``: "sm90" (``csrc/flash_attention_sm90.cu``, tensor cores) for
    bfloat16, else "cuda_core" (``csrc/flash_attention.cu``).  Every
    kernel has both."""
    return "sm90" if dtype == torch.bfloat16 else "cuda_core"


def kernel_tile(name: str, dtype: torch.dtype) -> Tuple[int, int]:
    """The (query, key) tile of kernel ``name`` for inputs of ``dtype``."""
    return KERNEL_TILES[(name, kernel_route(name, dtype))]


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


# ---------------------------------------------------------------------------
# Knobs (copied from the JAX package)
# ---------------------------------------------------------------------------


def _block_sizes(seq: int, block: int = 0) -> Tuple[int, int]:
    """(block_q, block_k) for ``seq``: ``block`` (Model.flash_block), else
    PFX_FLASH_BLOCK, else the ladder 512 / 256 / 128 / one block for a seq
    under 256 that is a multiple of 8.  Invalid overrides raise; a seq the
    ladder misses returns (256, 256), which :func:`flash_supported`
    reports as unsupported."""
    force = int(block) or _parse_block_env("PFX_FLASH_BLOCK")
    if force:
        _check_block(force, seq, "Model.flash_block / PFX_FLASH_BLOCK")
        return force, _block_k_override(seq, force)
    for b in (512, 256, 128):
        if seq % b == 0:
            return b, _block_k_override(seq, b)
    if seq < 256 and seq % 8 == 0:
        return seq, _block_k_override(seq, seq)
    # unsupported seq: a set-but-invalid PFX_FLASH_BLOCK_K still raises
    bk = _parse_block_env("PFX_FLASH_BLOCK_K")
    if bk:
        _check_block(bk, seq, "block_k; PFX_FLASH_BLOCK_K")
    return 256, 256


def _parse_block_env(name: str) -> int:
    env = os.environ.get(name) or "0"
    try:
        return int(env)
    except ValueError:
        raise ValueError(
            f"{name}={env!r} is not an integer; pass a positive divisor "
            f"of seq (e.g. 256) or unset it"
        ) from None


def _check_block(val: int, seq: int, label: str) -> None:
    if val < 0 or seq % val:
        raise ValueError(
            f"flash block {val} must be a positive divisor of seq "
            f"{seq} ({label})"
        )
    if val % 8:
        raise ValueError(
            f"flash block {val} must be a multiple of 8 (TPU "
            f"sublane tiling; {label})"
        )


def _block_k_override(seq: int, default_bk: int) -> int:
    """PFX_FLASH_BLOCK_K: an asymmetric key block, validated like the
    query block."""
    bk = _parse_block_env("PFX_FLASH_BLOCK_K")
    if not bk:
        return default_bk
    _check_block(bk, seq, "block_k; PFX_FLASH_BLOCK_K")
    return bk


def _resolve_bwd_schedule(bwd_schedule: str) -> str:
    mode = bwd_schedule or os.environ.get("PFX_FLASH_BWD", "split")
    if mode not in ("split", "fused"):
        raise ValueError(f"flash bwd schedule {mode!r}; valid: split, fused")
    return mode


def flash_supported(seq: int, block: int = 0) -> bool:
    """True when the block tiling divides ``seq`` (the dispatch helper of
    ``ops/attention.attention``).  An explicit invalid ``block`` raises."""
    bq, bk = _block_sizes(seq, block)
    return seq % bq == 0 and seq % bk == 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions ([bh, s, d] inputs; lse, delta float32 [bh, s])
#
# A block need not divide s: the last query or key block is then partial,
# as the kernels' last tile is, so at a kernel's own tile (kernel_tile) the
# plain versions round as that kernel does at every seq.  The dispatch passes them
# only dividing blocks, as the JAX package does.
# ---------------------------------------------------------------------------


def _mask(rows: Tensor, cols: Tensor) -> Tensor:
    return cols[None, :] <= rows[:, None]


def _blocks(n: int, size: int) -> int:
    return -(-n // size)


def flash_forward(q: Tensor, k: Tensor, v: Tensor, scale: float,
                  block: Tuple[int, int]) -> Tuple[Tensor, Tensor]:
    """``_fwd_kernel``: per query block, an online softmax over the key
    blocks up to the diagonal.  Products are summed in float32; p is
    rounded to v's type before p @ v.  Returns (out in q's type, lse
    float32 [bh, s])."""
    bh, s, d = q.shape
    bq, bk = block
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=dev)
    for qi in range(_blocks(s, bq)):
        r0 = qi * bq
        qb = q[:, r0:r0 + bq].float()
        nq = qb.shape[1]
        rows = r0 + torch.arange(nq, device=dev)
        m = torch.full((bh, nq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((bh, nq), dtype=torch.float32, device=dev)
        acc = torch.zeros((bh, nq, d), dtype=torch.float32, device=dev)
        for j in range(_blocks(r0 + nq, bk)):
            kb = k[:, j * bk:(j + 1) * bk].float()
            vb = v[:, j * bk:(j + 1) * bk].float()
            sc = scale * torch.bmm(qb, kb.transpose(1, 2))
            mask = _mask(rows, j * bk + torch.arange(kb.shape[1], device=dev))
            sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.bmm(p.to(v.dtype).float(), vb)
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        out[:, r0:r0 + nq] = (acc / l_safe[..., None]).to(q.dtype)
        lse[:, r0:r0 + nq] = m + torch.log(l_safe)
    return out, lse


def _bwd_tile(qb, kb, vb, dob, lse_b, delta_b, mask, scale, dtype):
    """The shared tile math of ``_bwd_tile`` (float32 blocks in): p from
    the saved lse, ds = p * (do.v - delta) * scale.  Returns (p, ds), both
    rounded to the input type ``dtype`` and back to float32."""
    sc = scale * torch.bmm(qb, kb.transpose(1, 2))
    p = torch.where(mask, torch.exp(sc - lse_b[..., None]), torch.zeros_like(sc))
    dov = torch.bmm(dob, vb.transpose(1, 2))
    ds = p * (dov - delta_b[..., None]) * scale
    return p.to(dtype).float(), ds.to(dtype).float()


def flash_bwd_dq(q, k, v, do, lse, delta, scale, block):
    """``_dq_kernel``: per query block, over the key blocks up to the
    diagonal, dq += ds @ k in float32.  Returns dq in q's type."""
    bh, s, d = q.shape
    bq, bk = block
    dev = q.device
    dq = torch.empty_like(q)
    for qi in range(_blocks(s, bq)):
        r0 = qi * bq
        qb, dob = q[:, r0:r0 + bq].float(), do[:, r0:r0 + bq].float()
        nq = qb.shape[1]
        rows = r0 + torch.arange(nq, device=dev)
        acc = torch.zeros((bh, nq, d), dtype=torch.float32, device=dev)
        for j in range(_blocks(r0 + nq, bk)):
            kb = k[:, j * bk:(j + 1) * bk].float()
            vb = v[:, j * bk:(j + 1) * bk].float()
            mask = _mask(rows, j * bk + torch.arange(kb.shape[1], device=dev))
            _, ds = _bwd_tile(qb, kb, vb, dob, lse[:, r0:r0 + nq], delta[:, r0:r0 + nq],
                              mask, scale, k.dtype)
            acc = acc + torch.bmm(ds, kb)
        dq[:, r0:r0 + nq] = acc.to(q.dtype)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, block):
    """``_dkv_kernel``: per key block, over the query blocks from the
    diagonal on.  Returns (dk, dv) in the input type."""
    dk, dv, _ = _dkv_sweep(q, k, v, do, lse, delta, scale, block, with_dq=False)
    return dk, dv


def flash_bwd_split(q, k, v, do, lse, delta, scale, block):
    """The split schedule (``_flash_bwd``): :func:`flash_bwd_dq` then
    :func:`flash_bwd_dkv`.  Returns (dq, dk, dv) in the input type."""
    return (flash_bwd_dq(q, k, v, do, lse, delta, scale, block),
            *flash_bwd_dkv(q, k, v, do, lse, delta, scale, block))


def _dkv_sweep(q, k, v, do, lse, delta, scale, block, with_dq):
    bh, s, d = q.shape
    bq, bk = block
    dev = q.device
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dq32 = torch.zeros((bh, s, d), dtype=torch.float32, device=dev) if with_dq else None
    for kj in range(_blocks(s, bk)):
        c0 = kj * bk
        kb, vb = k[:, c0:c0 + bk].float(), v[:, c0:c0 + bk].float()
        nk = kb.shape[1]
        cols = c0 + torch.arange(nk, device=dev)
        dk_acc = torch.zeros((bh, nk, d), dtype=torch.float32, device=dev)
        dv_acc = torch.zeros((bh, nk, d), dtype=torch.float32, device=dev)
        for i in range(c0 // bq, _blocks(s, bq)):
            r0 = i * bq
            qb, dob = q[:, r0:r0 + bq].float(), do[:, r0:r0 + bq].float()
            nq = qb.shape[1]
            mask = _mask(r0 + torch.arange(nq, device=dev), cols)
            p_lo, ds = _bwd_tile(qb, kb, vb, dob, lse[:, r0:r0 + nq], delta[:, r0:r0 + nq],
                                 mask, scale, q.dtype)
            dv_acc = dv_acc + torch.bmm(p_lo.transpose(1, 2), dob)
            dk_acc = dk_acc + torch.bmm(ds.transpose(1, 2), qb)
            if with_dq:
                dq32[:, r0:r0 + nq] += torch.bmm(ds, kb)
        dk[:, c0:c0 + nk] = dk_acc.to(k.dtype)
        dv[:, c0:c0 + nk] = dv_acc.to(v.dtype)
    return dk, dv, dq32


def flash_bwd_fused(q, k, v, do, lse, delta, scale, block):
    """``_bwd_fused_kernel``: one sweep per key block that also adds each
    tile's ds @ k to a float32 dq slab, cast to q's type at the end.
    Returns (dq, dk, dv)."""
    dk, dv, dq32 = _dkv_sweep(q, k, v, do, lse, delta, scale, block, with_dq=True)
    return dq32.to(q.dtype), dk, dv


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/flash_attention.cu, csrc/flash_attention_sm90.cu)
# ---------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None
_LIB_SM90: Optional[ctypes.CDLL] = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from paddlefleetx_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i32, i32, i32, f32, i32, ptr]  # bh, s, d, scale, dtype, stream
        lib.flash_fwd.argtypes = [ptr] * 5 + tail
        lib.flash_bwd_dq.argtypes = [ptr] * 7 + tail
        lib.flash_bwd_dkv.argtypes = [ptr] * 8 + tail
        lib.flash_bwd_fused.argtypes = [ptr] * 9 + tail
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv, lib.flash_bwd_fused):
            fn.restype = i32
        lib.flash_attn_error_string.argtypes = [i32]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _lib_sm90() -> ctypes.CDLL:
    global _LIB_SM90
    if _LIB_SM90 is None:
        from paddlefleetx_tpu_torch.ops import _build

        lib = _build.load("flash_attention_sm90")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i32, i32, i32, f32, ptr]  # bh, s, d, scale, stream
        lib.flash_fwd_sm90.argtypes = [ptr] * 5 + tail
        lib.flash_bwd_dq_sm90.argtypes = [ptr] * 7 + tail
        lib.flash_bwd_dkv_sm90.argtypes = [ptr] * 8 + tail
        lib.flash_bwd_fused_sm90.argtypes = [ptr] * 9 + tail
        for fn in (lib.flash_fwd_sm90, lib.flash_bwd_dq_sm90, lib.flash_bwd_dkv_sm90,
                   lib.flash_bwd_fused_sm90):
            fn.restype = i32
        lib.flash_sm90_error_string.argtypes = [i32]
        lib.flash_sm90_error_string.restype = ctypes.c_char_p
        _LIB_SM90 = lib
    return _LIB_SM90


def _check_inputs(name: str, tensors, stats=()) -> None:
    """What the kernels take: [bh, s, d] contiguous CUDA tensors of one
    type (float32 or bfloat16) on one device, d in 64 or 128; ``stats``
    (lse, delta) float32 [bh, s] contiguous on the same device."""
    q = tensors[0]
    if q.dim() != 3:
        raise ValueError(f"{name}: inputs must be [bh, s, d], got {tuple(q.shape)}")
    bh, s, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype}; valid: float32, bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d}; the kernel takes {_HEAD_DIMS}")
    for x in tensors:
        if tuple(x.shape) != (bh, s, d) or x.dtype != q.dtype:
            raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} vs q {q.dtype} "
                             f"{tuple(q.shape)}")
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned "
                             f"on {q.device}")
    for x in stats:
        if (x.dtype != torch.float32 or tuple(x.shape) != (bh, s) or x.device != q.device
                or not x.is_contiguous()):
            raise ValueError(f"{name}: lse/delta must be contiguous float32 [bh, s] on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _call(name: str, q: Tensor, scale: float, *ptrs: int) -> None:
    """Launch kernel ``name`` on q's route (:func:`kernel_route`) with the
    given pointers, on the current stream; raises if the launch fails."""
    bh, s, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kernel_route(name, q.dtype) == "sm90":
        lib, fn = _lib_sm90(), f"{name}_sm90"
        rc = getattr(lib, fn)(*ptrs, bh, s, d, float(scale), stream)
        err = lib.flash_sm90_error_string
    else:
        lib, fn = _lib(), name
        rc = getattr(lib, fn)(*ptrs, bh, s, d, float(scale), _DTYPE_CODES[q.dtype], stream)
        err = lib.flash_attn_error_string
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {rc} ({err(rc).decode()})")
    COUNTS[name] += 1
    if fn != name:
        COUNTS[fn] += 1


def launch_fwd(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tuple[Tensor, Tensor]:
    """K3 on the card: (out in q's type, lse float32 [bh, s])."""
    _check_inputs("flash_fwd", (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _call("flash_fwd", q, scale, *(x.data_ptr() for x in (q, k, v, out, lse)))
    return out, lse


def launch_bwd_dq(q, k, v, do, lse, delta, scale):
    """K4 on the card: dq in q's type."""
    _check_inputs("flash_bwd_dq", (q, k, v, do), (lse, delta))
    dq = torch.empty_like(q)
    _call("flash_bwd_dq", q, scale, *(x.data_ptr() for x in (q, k, v, do, lse, delta, dq)))
    return dq


def launch_bwd_dkv(q, k, v, do, lse, delta, scale):
    """K5 on the card: (dk, dv) in the input type."""
    _check_inputs("flash_bwd_dkv", (q, k, v, do), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("flash_bwd_dkv", q, scale,
          *(x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)))
    return dk, dv


def launch_bwd_split(q, k, v, do, lse, delta, scale):
    """K4 then K5 on the card: (dq, dk, dv) in the input type."""
    return (launch_bwd_dq(q, k, v, do, lse, delta, scale),
            *launch_bwd_dkv(q, k, v, do, lse, delta, scale))


def launch_bwd_fused(q, k, v, do, lse, delta, scale):
    """K6 on the card: dq accumulated in a zeroed float32 slab (bf16: TMA
    reduce-adds of whole tiles; float32: atomics; either way the order of
    the adds varies from run to run), then cast to q's type; (dq, dk,
    dv)."""
    _check_inputs("flash_bwd_fused", (q, k, v, do), (lse, delta))
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("flash_bwd_fused", q, scale,
          *(x.data_ptr() for x in (q, k, v, do, lse, delta, dq32, dk, dv)))
    return dq32.to(q.dtype), dk, dv


def _device_kind(x: Tensor, name: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# The op and its autograd Function
# ---------------------------------------------------------------------------


@torch.library.custom_op("pfx::flash_attn_fwd", mutates_args=())
def flash_attn_fwd(q: Tensor, k: Tensor, v: Tensor, scale: float, block_q: int,
                   block_k: int) -> Tuple[Tensor, Tensor]:
    """K3 for CUDA tensors, :func:`flash_forward` for CPU tensors:
    (out, lse float32 [bh, s])."""
    if _device_kind(q, "flash_attn_fwd") == "cuda":
        return launch_fwd(q, k, v, scale)
    COUNTS["flash_plain"] += 1
    return flash_forward(q, k, v, scale, (block_q, block_k))


@flash_attn_fwd.register_fake
def _flash_attn_fwd_fake(q, k, v, scale, block_q, block_k):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


def flash_backward(q, k, v, out, lse, do, scale, block, mode):
    """delta = rowsum(do * out) in float32 (outside the kernels, as
    ``_flash_bwd`` computes it), then the split (K4 + K5) or fused (K6)
    schedule.  Returns (dq, dk, dv) in the input type."""
    delta = (do.float() * out.float()).sum(dim=-1)
    if _device_kind(q, "flash_backward") == "cuda":
        fn = launch_bwd_fused if mode == "fused" else launch_bwd_split
        return fn(q, k, v, do, lse, delta, scale)
    COUNTS["flash_plain"] += 1
    fn = flash_bwd_fused if mode == "fused" else flash_bwd_split
    return fn(q, k, v, do, lse, delta, scale, block)


class FlashAttention(torch.autograd.Function):
    """Causal attention on [bh, s, d]; saves q, k, v, out and the float32
    lse for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, block, mode):
        out, lse = torch.ops.pfx.flash_attn_fwd(q, k, v, scale, block[0], block[1])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.block, ctx.mode = scale, block, mode
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do.contiguous(), ctx.scale,
                                    ctx.block, ctx.mode)
        return dq, dk, dv, None, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    block: int = 0, bwd_schedule: str = "") -> Tensor:
    """q, k, v [batch, seq, heads, head_dim] -> [batch, seq, heads,
    head_dim] in q's type.  ``block`` (0 = PFX_FLASH_BLOCK, else the
    ladder) and ``bwd_schedule`` ("" = PFX_FLASH_BWD, else "split") are
    ``Model.flash_block`` / ``Model.flash_bwd``.  A seq the ladder misses
    raises on the CPU (the plain versions' loops need a dividing block)
    and runs on the card, whose kernels tile by their own tile."""
    if not causal:
        raise NotImplementedError("only causal flash attention")
    b, s, n, d = q.shape
    bq, bk = _block_sizes(s, block)
    if (s % bq or s % bk) and q.device.type != "cuda":
        raise ValueError(
            f"flash_attention needs seq divisible by block size {bq}, got {s}; "
            "pad the sequence or use attn_impl='xla'"
        )
    scale = float(1.0 / (d**0.5))
    mode = _resolve_bwd_schedule(bwd_schedule)

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * n, s, d).contiguous()

    out = FlashAttention.apply(to_bh(q), to_bh(k), to_bh(v), scale, (bq, bk), mode)
    return out.reshape(b, n, s, d).transpose(1, 2)
