"""How far K8's tensor-core prefill would drift with ``p * v_scale`` in one
bf16 part instead of two.

    python -m paddlefleetx_tpu_torch.tools.q8_prefill_precision [--out FILE.json]

The int8 prefill (``flash_decode_q8_sm90`` at t > 16, in
``csrc/decode_attention_sm90.cu``) feeds ``p * v_scale`` to its P.V
products as a bf16 high part and a bf16 low part, two wgmmas into one
float32 accumulator.  This builds a copy of that source with the low
part's wgmmas taken out (under ``build/torch_kernels/variants/``; the
shipped kernel is not touched) and holds both against the plain version
(``decode_attention_plain``) on the same inputs: request D's prefill (batch
8, 16 heads, d = 64, t = 64, left pads), batch 8 at t = 512, and head dim
128 at t = 256.  Prints one JSON line with each case's max |error| for the
two parts and for the one part, beside the int8 gate of ``chip_smoke.py``
(1e-4).  Needs one CUDA card and nvcc.
"""

import argparse
import ctypes
import json
import subprocess

import torch

from paddlefleetx_tpu_torch.ops import _build
from paddlefleetx_tpu_torch.ops import decode_attention as da

GATE = 1e-4
D_PADS = [64 - n for n in (12, 20, 28, 36, 44, 52, 60, 64)]
# (name, b, n, t, d, L, limit, kv_valid_from)
CASES = [
    ("request_d_prefill", 8, 16, 64, 64, 96, 64, D_PADS),
    ("b8_t512", 8, 16, 512, 64, 1024, 512, [0, 17, 100, 255, 0, 3, 400, 511]),
    ("b8_t256_d128", 8, 16, 256, 128, 1024, 512, [0, 17, 100, 255, 0, 3, 400, 511]),
]
# the low part's products, one per head dim; each must appear exactly once
LOW_PART = ("        wgmma_rs_n64<1>(o, pl[kk], bv, 1);\n",
            "        wgmma_rs_n128<1>(o, pl[kk], bv, 1);\n")
ENTRIES = ("flash_decode_sm90", "flash_decode_q8_sm90", "flash_decode_sm90_error_string")


def one_part_library(stock: ctypes.CDLL) -> ctypes.CDLL:
    """The sm90 decode library built from a copy of its source without the
    low part's wgmmas, bound like ``stock``."""
    src = (_build.CSRC / "decode_attention_sm90.cu").read_text()
    for line in LOW_PART:
        if src.count(line) != 1:
            raise RuntimeError(f"low-part product not found once in the source: {line!r}")
        src = src.replace(line, "")
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "decode_attention_sm90_one_part.cu", out / "decode_attention_sm90_one_part.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(so), str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ENTRIES:
        getattr(lib, name).argtypes = getattr(stock, name).argtypes
        getattr(lib, name).restype = getattr(stock, name).restype
    return lib


def inputs(b, n, t, d, L, vf, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, n, t, d, generator=g, device="cuda").bfloat16()
    k, ks = da.quantize_kv(torch.randn(b, n, L, d, generator=g, device="cuda"))
    v, vs = da.quantize_kv(torch.randn(b, n, L, d, generator=g, device="cuda"))
    return q, k, v, torch.tensor(vf, dtype=torch.int32, device="cuda"), ks, vs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.q8_prefill_precision")
    ap.add_argument("--out", default="", help="write the result as JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    stock = da._sm90_lib()
    variant = one_part_library(stock)
    rows = []
    for name, b, n, t, d, L, limit, vf in CASES:
        q, k, v, vft, ks, vs = inputs(b, n, t, d, L, vf)
        scale = 1.0 / d**0.5
        assert da.kernel_route(q.dtype, d) == "sm90" and t > da.SPLIT_MAX_ROWS
        ref = da.decode_attention_plain(q, k, v, limit, vft, da.decode_block(L), scale, ks, vs)
        errs = {}
        for parts, lib in (("two_parts", stock), ("one_part", variant)):
            da._SM90_LIB = lib
            try:
                got = da.flash_decode(q, k, v, limit, vft, scale, ks, vs)
                torch.cuda.synchronize()
            finally:
                da._SM90_LIB = stock
            errs[parts] = (got - ref).abs().max().item()
        rows.append({"case": name, "b": b, "n": n, "t": t, "d": d, "L": L, "limit": limit,
                     **errs, "gate": GATE, "one_part_within_gate": errs["one_part"] <= GATE})
        print(f"{name}: two parts {errs['two_parts']:.3e}, one part {errs['one_part']:.3e} "
              f"(gate {GATE:g})", flush=True)
    result = {"q8_prefill_precision": rows}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
