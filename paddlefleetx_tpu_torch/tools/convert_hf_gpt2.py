"""Import a HuggingFace GPT-2 checkpoint into the port's params-only format.

    python -m paddlefleetx_tpu_torch.tools.convert_hf_gpt2 --model HF_DIR -o OUT \\
        [--pad-vocab-to 50304]

Counterpart of ``tools/convert_hf_gpt2.py``, without ``transformers``:
``HF_DIR`` is a local directory with ``config.json`` and either
``model.safetensors`` (read by :func:`read_safetensors`: an 8-byte
little-endian header length, a JSON header, then F32 / F16 / BF16
payloads) or ``pytorch_model.bin`` (``torch.load(weights_only=True)``).
Output (``utils/checkpoint.save_params_checkpoint``)::

    OUT/params.pt      the named float32 params
    OUT/meta.json      {"format": "params-only", "source": "hf-gpt2:HF_DIR"}
    OUT/model.yaml     the matching Model config block

Serve it with ``-o Engine.save_load.ckpt_dir=OUT``, or warm-start training
with ``-o Engine.save_load.pretrained_params=OUT``; ``--pad-vocab-to``
must then equal the config's ``Model.vocab_size`` (50304 for GPT-2's
50257 rows in the repo's GPT configs).
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
from typing import Dict

import numpy as np

from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.models.gpt.convert import (
    convert_hf_gpt2_state_dict,
    hf_gpt2_config,
)
from paddlefleetx_tpu_torch.utils.checkpoint import save_params_checkpoint

_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """The tensors of a ``.safetensors`` file as numpy arrays (BF16 widened
    to float32 exactly), memory-mapped until converted.  Raises
    ``ValueError`` on a malformed header or another dtype."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    if raw.size < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", bytes(raw[:8]))
    if 8 + n > raw.size:
        raise ValueError(f"{path}: header length {n} past the end of the file")
    header = json.loads(bytes(raw[8:8 + n]).decode("utf-8"))
    data = raw[8 + n:]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"readable: {sorted(_ST_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * np.dtype(dtype).itemsize or end > data.size:
            raise ValueError(f"{path}: {name}: offsets {begin}..{end} do not hold {shape} "
                             f"{info['dtype']}")
        arr = data[begin:end].view(dtype).reshape(shape)
        if info["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write float32 / float16 numpy arrays as a ``.safetensors`` file (the
    header padded with spaces to a multiple of 8, payloads in order)."""
    names = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16"}
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in names:
            raise ValueError(f"{name}: dtype {arr.dtype}; writable: float32, float16")
        blob = arr.tobytes()
        header[name] = {"dtype": names[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def read_state_dict(model_dir: str):
    """The checkpoint tensors of a local HF directory: ``model.safetensors``
    first, else ``pytorch_model.bin``."""
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.isfile(st):
        return read_safetensors(st)
    binf = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.isfile(binf):
        import torch

        return torch.load(binf, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{model_dir}: neither model.safetensors nor pytorch_model.bin")


def convert(model_dir: str, out_dir: str, pad_vocab_to=None) -> str:
    """Convert ``model_dir`` into a params-only directory; returns its path."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = hf_gpt2_config(hf_cfg, **({"vocab_size": pad_vocab_to} if pad_vocab_to else {}))
    tree = convert_hf_gpt2_state_dict(read_state_dict(model_dir), cfg,
                                      pad_vocab_to=pad_vocab_to)
    model = params_from_jax(cfg, tree, trainable=True)
    return save_params_checkpoint(
        out_dir, dict(model.named_parameters()), f"hf-gpt2:{model_dir}",
        {
            "module": "GPTModule",
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
        },
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.convert_hf_gpt2")
    ap.add_argument("--model", required=True, help="local HF GPT-2 directory")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--pad-vocab-to", type=int, default=None)
    args = ap.parse_args(argv)
    out = convert(args.model, args.out, args.pad_vocab_to)
    print(f"converted -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
