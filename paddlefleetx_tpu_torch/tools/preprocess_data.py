"""Tokenize and pack a jsonl corpus into the port's training format.

    python -m paddlefleetx_tpu_torch.tools.preprocess_data --input corpus.jsonl \\
        --output_prefix data/corpus --tokenizer gpt --vocab_file vocab.json \\
        --merges_file merges.txt [--workers 8]

Counterpart of the GPT branch of ``tools/preprocess_data.py``
(``_init_worker`` :66, ``_encode`` :84, ``main`` :114): each line's
``{"text": ...}`` is encoded with the port's ``GPTTokenizer``, an EOS is
appended to every document that does not end in one, and the stream is
written as ``<prefix>_ids.npy`` (uint16 when every id fits, else uint32)
and ``<prefix>_idx.npz`` (``lens``: int32 per-document lengths), the files
``data/indexed.py`` and ``data/gpt_dataset.py`` read.  The files are the
JAX tool's byte for byte.  The ERNIE (sentence-split) and T5 (unigram)
branches are not ported and raise.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys

import numpy as np

_TOK = None


def _init_worker(kind, vocab_file, merges_file):
    global _TOK
    if kind != "gpt":
        raise NotImplementedError(
            f"--tokenizer {kind}: only the GPT tokenizer is ported; the ERNIE and T5 "
            "preprocessing paths are not"
        )
    from paddlefleetx_tpu_torch.data.tokenizers.gpt_tokenizer import GPTTokenizer

    _TOK = GPTTokenizer(vocab_file, merges_file)
    _TOK._eos = _TOK.eos_token_id


def _encode(line):
    line = line.strip()
    if not line:
        return None
    text = json.loads(line).get("text", "")
    if not text:
        return None
    ids = _TOK.encode(text)
    if not ids or ids[-1] != _TOK._eos:
        ids = list(ids) + [_TOK._eos]
    return ids


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddlefleetx_tpu_torch.tools.preprocess_data")
    ap.add_argument("--input", required=True, help="jsonl with {'text': ...}")
    ap.add_argument("--output_prefix", required=True)
    ap.add_argument("--tokenizer", choices=["gpt", "t5", "ernie"], default="gpt")
    ap.add_argument("--vocab_file", required=True)
    ap.add_argument("--merges_file", default=None)
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args(argv)

    init_args = (args.tokenizer, args.vocab_file, args.merges_file)
    if args.tokenizer != "gpt":
        _init_worker(*init_args)  # raises NotImplementedError

    # stream line -> tokens -> compact uint32 chunks (never hold the whole
    # corpus as Python lists: ~4 bytes/token peak instead of ~36)
    def doc_arrays():
        with open(args.input) as f:
            if args.workers > 1:
                ctx = mp.get_context("spawn")
                with ctx.Pool(args.workers, initializer=_init_worker, initargs=init_args) as pool:
                    for d in pool.imap(_encode, f, chunksize=64):
                        if d:
                            yield np.asarray(d, np.uint32)
            else:
                _init_worker(*init_args)
                for line in f:
                    d = _encode(line)
                    if d:
                        yield np.asarray(d, np.uint32)

    chunks, lens, max_id = [], [], 0
    for arr in doc_arrays():
        chunks.append(arr)
        lens.append(len(arr))
        max_id = max(max_id, int(arr.max()))
    if not chunks:
        print("no documents with text found — nothing written", file=sys.stderr)
        return 1

    dtype = np.uint16 if max_id < 2**16 else np.uint32
    stream = np.concatenate(chunks).astype(dtype)
    lens = np.asarray(lens, np.int32)

    os.makedirs(os.path.dirname(os.path.abspath(args.output_prefix)) or ".", exist_ok=True)
    np.save(args.output_prefix + "_ids.npy", stream)
    np.savez(args.output_prefix + "_idx.npz", lens=lens)
    print(f"packed {len(lens)} docs, {stream.size} tokens ({dtype.__name__}) -> "
          f"{args.output_prefix}_ids.npy / _idx.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
