"""Fused LayerNorm (+ optional residual add): the CUDA kernels K1/K2 and
their plain versions.

Counterpart of ``paddlefleetx_tpu/ops/fused_layernorm.py``:
``fused_layer_norm(x, scale, bias, residual=None, eps=1e-5)`` over the
last dim, with float32 statistics, a float32 affine and the output in x's
type.  The backward recomputes xhat from the saved mean and rstd:
``dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat))`` with
``gs = g * scale``, ``dres = dx``, and dscale / dbias summed over the rows
(returned in scale's type).

Two spellings of each direction, chosen by the tensors' device only:

  - the CUDA kernels of ``csrc/fused_layernorm.cu`` (built on first use by
    ``ops/_build.py``) for tensors on the card: ``fused_ln_fwd`` (K1, the
    TPU's ``_fwd_kernel``) and ``fused_ln_bwd`` (K2, ``_bwd_kernel``: dx
    per row, then the per-band column sums added in a fixed order).  Each
    takes one of two paths, chosen in the library by dtype, width and
    alignment only (:func:`register_vecs` reports it): rows held in
    registers from 16-byte loads, or a strided path for any other width or
    alignment;
  - :func:`layer_norm_fwd_plain` and :func:`layer_norm_bwd_plain`, plain
    PyTorch versions with the same math (the variance as the mean of
    squared deviations, the residual added in float32 inside the norm),
    for tensors on the CPU and as the reference the kernels are held
    against.

A CUDA tensor reaches the kernel or raises; nothing falls back.
:data:`COUNTS` counts kernel launches and plain-version calls.

The forward is the custom op ``pfx::fused_ln_fwd`` (y, mean, rstd), so a
selective-recompute policy sees it (``models/gpt/model._layer_remat``).
The policy does not keep it: like the JAX ``selective`` policy, which
saves only named values and so re-runs the custom VJP's forward inside a
rematerialised layer, the port recomputes K1 in the backward of a
selectively recomputed layer.
"""

import ctypes
from typing import Optional, Tuple

import torch
from torch import Tensor

# Kernel launches (K1, K2) and plain-version calls on CPU tensors.
# Process-wide; reset with reset_counts().
COUNTS = {"fused_ln_fwd": 0, "fused_ln_bwd": 0, "fused_ln_fwd_plain": 0,
          "fused_ln_bwd_plain": 0}

# The register paths of K1 and K2 (csrc/fused_layernorm.cu, up to 8 16-byte
# vectors per lane and tensor) take rows up to this n, where n is a multiple
# of the vector (8 bf16 or float16, 4 float32) and the tensors are 16-byte aligned;
# other rows take the strided paths.  Both are held against the plain
# version.  The kernels choose the path themselves (register_vecs asks them).
REGISTER_MAX_N = {torch.float32: 1024, torch.bfloat16: 2048, torch.float16: 2048}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions ([rows, n] inputs; mean, rstd float32 [rows])
# ---------------------------------------------------------------------------


def _norm_input(x2: Tensor, res2: Optional[Tensor]) -> Tensor:
    xf = x2.float()
    return xf if res2 is None else xf + res2.float()


def layer_norm_fwd_plain(x2: Tensor, res2: Optional[Tensor], scale: Tensor, bias: Tensor,
                         eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """``_fwd_kernel``: (y in x's type, mean, rstd float32 [rows])."""
    v = _norm_input(x2, res2)
    mean = v.mean(dim=-1)
    var = (v - mean[:, None]).square().mean(dim=-1)
    rstd = torch.rsqrt(var + eps)
    xhat = (v - mean[:, None]) * rstd[:, None]
    y = xhat * scale.float() + bias.float()
    return y.to(x2.dtype), mean, rstd


def layer_norm_bwd_plain(x2: Tensor, res2: Optional[Tensor], scale: Tensor, mean: Tensor,
                         rstd: Tensor, g: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``_bwd_kernel``: (dx in x's type, dscale, dbias in scale's type)."""
    v = _norm_input(x2, res2)
    xhat = (v - mean[:, None]) * rstd[:, None]
    gf = g.float()
    gs = gf * scale.float()
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (gs - m1 - xhat * m2)
    dscale = (gf * xhat).sum(dim=0)
    dbias = gf.sum(dim=0)
    return dx.to(x2.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/fused_layernorm.cu)
# ---------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from paddlefleetx_tpu_torch.ops import _build

        lib = _build.load("fused_layernorm")
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.fused_ln_fwd.argtypes = [ptr] * 7 + [i64, i32, f32, i32, ptr]
        lib.fused_ln_bwd.argtypes = [ptr] * 11 + [i64, i32, i32, ptr]
        lib.fused_ln_fwd.restype = i32
        lib.fused_ln_bwd.restype = i32
        lib.fused_ln_bwd_bands.argtypes = [i64]
        lib.fused_ln_bwd_bands.restype = i64
        lib.fused_ln_register_vecs.argtypes = [i32, i32, ctypes.c_uint64]
        lib.fused_ln_register_vecs.restype = i32
        lib.fused_ln_error_string.argtypes = [i32]
        lib.fused_ln_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def register_vecs(dtype: torch.dtype, n: int, *ptrs: Optional[int]) -> int:
    """The path K1 / K2 take for rows of ``n`` elements of ``dtype`` over
    tensors at the addresses ``ptrs`` (None for an absent residual), as the
    kernels' library chooses it: the 16-byte vectors per lane of the
    register path, or 0 for the strided path.  Labels only: the entry
    points apply the rule themselves."""
    addr = 0
    for p in ptrs:
        addr |= p or 0
    return _lib().fused_ln_register_vecs(_DTYPE_CODES[dtype], n, addr)


def _check_inputs(name: str, rows_tensors, vecs, stats=()) -> None:
    """What the kernels take: [rows, n] contiguous CUDA tensors of one
    type (float32, bfloat16 or float16) on one device; ``vecs`` (scale, bias)
    float32 [n]; ``stats`` (mean, rstd) float32 [rows]; all contiguous."""
    x = rows_tensors[0]
    if x.dim() != 2:
        raise ValueError(f"{name}: inputs must be [rows, n], got {tuple(x.shape)}")
    rows, n = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype}; valid: float32, bfloat16, float16")
    for t in rows_tensors:
        if tuple(t.shape) != (rows, n) or t.dtype != x.dtype:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} vs x {x.dtype} "
                             f"{tuple(x.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on {x.device}")
    for t in vecs:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: scale/bias must be contiguous float32 [n] on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (rows,) or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: mean/rstd must be contiguous float32 [rows] on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _call(name: str, *args) -> None:
    lib = _lib()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.fused_ln_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
    COUNTS[name] += 1


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_fwd(x2: Tensor, res2: Optional[Tensor], scale: Tensor, bias: Tensor,
               eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K1 on the card: (y in x's type, mean, rstd float32 [rows])."""
    _check_inputs("fused_ln_fwd", (x2,) if res2 is None else (x2, res2), (scale, bias))
    rows, n = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(rows, dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    _call("fused_ln_fwd", x2.data_ptr(), None if res2 is None else res2.data_ptr(),
          scale.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
          rows, n, float(eps), _DTYPE_CODES[x2.dtype], _stream(x2))
    return y, mean, rstd


def launch_bwd(x2: Tensor, res2: Optional[Tensor], scale: Tensor, mean: Tensor, rstd: Tensor,
               g: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K2 on the card: (dx in x's type, dscale, dbias float32 [n])."""
    rows_tensors = (x2, g) if res2 is None else (x2, res2, g)
    _check_inputs("fused_ln_bwd", rows_tensors, (scale,), (mean, rstd))
    rows, n = x2.shape
    bands = _lib().fused_ln_bwd_bands(rows)
    part = torch.empty((2, bands, n), dtype=torch.float32, device=x2.device)
    dx = torch.empty_like(x2)
    dscale = torch.empty(n, dtype=torch.float32, device=x2.device)
    dbias = torch.empty_like(dscale)
    _call("fused_ln_bwd", x2.data_ptr(), None if res2 is None else res2.data_ptr(),
          scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(), g.data_ptr(), dx.data_ptr(),
          part[0].data_ptr(), part[1].data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
          rows, n, _DTYPE_CODES[x2.dtype], _stream(x2))
    return dx, dscale, dbias


def _device_kind(x: Tensor, name: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# The op and its autograd Function
# ---------------------------------------------------------------------------


@torch.library.custom_op("pfx::fused_ln_fwd", mutates_args=())
def fused_ln_fwd(x2: Tensor, res2: Optional[Tensor], scale: Tensor, bias: Tensor,
                 eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    """K1 for CUDA tensors, :func:`layer_norm_fwd_plain` for CPU tensors:
    (y, mean, rstd float32 [rows])."""
    if _device_kind(x2, "fused_ln_fwd") == "cuda":
        return launch_fwd(x2, res2, scale, bias, eps)
    COUNTS["fused_ln_fwd_plain"] += 1
    return layer_norm_fwd_plain(x2, res2, scale, bias, eps)


@fused_ln_fwd.register_fake
def _fused_ln_fwd_fake(x2, res2, scale, bias, eps):
    stats = x2.new_empty(x2.shape[:1], dtype=torch.float32)
    return torch.empty_like(x2), stats, torch.empty_like(stats)


def fused_ln_backward(x2, res2, scale, mean, rstd, g):
    """K2 for CUDA tensors, :func:`layer_norm_bwd_plain` for CPU tensors:
    (dx, dscale, dbias), the sums in scale's type (float32 on the card,
    where the kernel takes no other)."""
    if _device_kind(x2, "fused_ln_backward") == "cuda":
        return launch_bwd(x2, res2, scale, mean, rstd, g)
    COUNTS["fused_ln_bwd_plain"] += 1
    return layer_norm_bwd_plain(x2, res2, scale, mean, rstd, g)


class FusedLayerNorm(torch.autograd.Function):
    """LayerNorm of [rows, n] (+ residual); saves x, the residual, scale
    and the float32 mean and rstd for the backward, as the JAX custom VJP
    does (``_fused_ln_fwd:130``)."""

    @staticmethod
    def forward(ctx, x2, res2, scale, bias, eps):
        y, mean, rstd = torch.ops.pfx.fused_ln_fwd(x2, res2, scale, bias, eps)
        ctx.save_for_backward(x2, res2, scale, mean, rstd)
        ctx.has_res = res2 is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x2, res2, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = fused_ln_backward(x2, res2 if ctx.has_res else None, scale, mean,
                                              rstd, g.contiguous())
        return dx, (dx if ctx.has_res else None), dscale, dbias, None


def fused_layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
                     residual: Optional[Tensor] = None, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last dim of ``x`` (+ ``residual``, added in
    float32 inside the norm), float32 statistics, output in x's type."""
    shape = x.shape
    n = shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    res2 = None if residual is None else residual.reshape(-1, n).contiguous()
    return FusedLayerNorm.apply(x2, res2, scale, bias, float(eps)).reshape(shape)
