"""GPT byte-level BPE tokenizer of the PyTorch port.

Counterpart of ``paddlefleetx_tpu/data/tokenizers/gpt_tokenizer.py``
(``bytes_to_unicode`` :30, ``_NativeBpe`` :52, ``GPTTokenizer`` :122,
``encode`` :195, ``decode`` :219, ``from_pretrained`` :224): the
reversible byte->unicode map, greedy pair merging by learned rank, the
GPT-2 word pattern, and the usual ``vocab.json`` + ``merges.txt`` files.

Two differences of means, none of result:

  - The word pattern is built with the standard library's ``re`` from the
    code-point table in ``unicode_classes.py`` (``regex``'s ``\\p{L}``,
    ``\\p{N}`` and ``\\s``, derived by ``tools/gen_unicode_classes.py``),
    with the JAX pattern's alternation order and its ``\\s+(?!\\S)``
    backtrack; the port does not import ``regex``.
  - The native merge engine (``csrc/bpe.cpp``, built by ``data/_build.py``)
    is required: a failed build raises instead of falling back to the
    Python loop for every word.  The Python loop :meth:`GPTTokenizer._bpe`
    serves only the words the engine returns nothing for (over 4096
    bytes, or a symbol outside the byte vocab), as in the JAX tokenizer.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import re
import struct
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from paddlefleetx_tpu_torch.data.tokenizers import unicode_classes
from paddlefleetx_tpu_torch.utils.registry import TOKENIZERS

# word-level memoization caps: natural-language traffic saturates well under
# this (Zipf), while high-entropy input stays memory-bounded
_ENCODE_CACHE_MAX = 1 << 18
# the native engine's word limit (bytes)
_NATIVE_MAX_WORD = 4096


def _class_body(table: Sequence[Tuple[int, int]]) -> str:
    """A character-class body (no brackets) for ``re`` from inclusive ranges."""
    return "".join(f"\\U{a:08X}" if a == b else f"\\U{a:08X}-\\U{b:08X}" for a, b in table)


def word_pattern() -> "re.Pattern[str]":
    """The GPT-2 word pattern of the JAX tokenizer,
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``,
    over the committed code-point table."""
    L = _class_body(unicode_classes.LETTER)
    N = _class_body(unicode_classes.NUMBER)
    S = _class_body(unicode_classes.SPACE)
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+|[{S}]+(?![^{S}])|[{S}]+"
    )


_WORD_PAT = word_pattern()


def pre_tokenize(text: str) -> List[str]:
    """The words the merge loop sees, in order."""
    return _WORD_PAT.findall(text)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte->printable-unicode map (the standard GPT-2
    construction: printable ASCII/latin bytes map to themselves, the rest
    to 256+n)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class _NativeBpe:
    """ctypes wrapper over ``csrc/bpe.cpp``: raw-byte vocab and merge ranks
    (tokens that are not byte-mappable, the special tokens, are left out;
    the caller takes them through Python)."""

    def __init__(self, encoder: Dict[str, int], bpe_ranks, byte_decoder):
        from paddlefleetx_tpu_torch.data import _build

        self._lib = _build.load_bpe()

        def to_bytes(mapped: str) -> Optional[bytes]:
            try:
                return bytes(byte_decoder[c] for c in mapped)
            except KeyError:
                return None

        # vocab blob: ids must be the token's real id, so a dense list.
        # Non-mappable tokens (specials) get a placeholder longer than the
        # word limit, so no queryable symbol can ever collide with it
        placeholder = b"\x00" * 5000
        n = max(encoder.values()) + 1
        toks = [placeholder] * n
        for t, i in encoder.items():
            raw = to_bytes(t)
            if raw is not None:
                toks[i] = raw
        parts = [struct.pack("<i", n)]
        parts += [struct.pack("<i", len(t)) + t for t in toks]
        vocab_blob = b"".join(parts)

        merges = sorted(bpe_ranks.items(), key=lambda kv: kv[1])
        mparts = [struct.pack("<i", len(merges))]
        for (a, b), _rank in merges:
            ra, rb = to_bytes(a), to_bytes(b)
            if ra is None or rb is None:  # keep rank indices aligned
                ra, rb = placeholder, placeholder
            mparts.append(struct.pack("<i", len(ra)) + ra)
            mparts.append(struct.pack("<i", len(rb)) + rb)
        merge_blob = b"".join(mparts)

        self._handle = self._lib.bpe_new(vocab_blob, len(vocab_blob), merge_blob,
                                         len(merge_blob))
        if not self._handle:
            raise RuntimeError("bpe_new rejected the vocab or merge blob")

    def encode_word(self, raw: bytes) -> Optional[List[int]]:
        """The ids of one pre-tokenized word's UTF-8 bytes, or None when the
        engine cannot take it (over the word limit, or an unknown symbol).

        The output buffer is the call's own: ctypes drops the GIL during the
        foreign call, and the serve CLI encodes on its request threads.  A
        word of n bytes merges into at most n ids."""
        if len(raw) > _NATIVE_MAX_WORD:
            return None
        out = (ctypes.c_int32 * max(len(raw), 1))()
        n = self._lib.bpe_encode_word(self._handle, raw, len(raw), out, len(out))
        if n < 0:
            return None
        return list(out[:n])

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bpe_free(handle)
            self._handle = None


@TOKENIZERS.register("GPTTokenizer")
class GPTTokenizer:
    """Byte-level BPE over ``vocab.json`` (token -> id) and ``merges.txt``
    (one ``a b`` pair a line, in rank order, an optional ``#version``
    line first).  ``eos_token`` is also the pad token."""

    def __init__(self, vocab_file: str, merges_file: str, eos_token: str = "<|endoftext|>"):
        with open(vocab_file) as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            merges = [
                tuple(line.split())
                for line in f.read().split("\n")
                if line and not line.startswith("#version")
            ]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: Dict[str, str] = {}
        # guards the two caches' insert-and-evict: encode() runs on the
        # serve CLI's request threads
        self._cache_lock = threading.Lock()
        self.eos_token = eos_token
        self.eos_token_id = self.encoder.get(eos_token)
        self.pad_token_id = self.eos_token_id
        # byte-level BPE is isomorphic under the byte->unicode map, so the
        # engine works on raw bytes; a failed build raises here
        self._native = _NativeBpe(self.encoder, self.bpe_ranks, self.byte_decoder)
        self._id_cache: Dict[bytes, List[int]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> str:
        """The Python merge loop over one byte-mapped word: its symbols,
        space-separated."""
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            pair = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if pair not in self.bpe_ranks:
                break
            a, b = pair
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        with self._cache_lock:
            if len(self.cache) >= _ENCODE_CACHE_MAX:
                self.cache.pop(next(iter(self.cache)))
            self.cache[token] = out
        return out

    def _python_ids(self, raw: bytes) -> List[int]:
        mapped = "".join(self.byte_encoder[b] for b in raw)
        return [self.encoder[t] for t in self._bpe(mapped).split(" ")]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in pre_tokenize(text):
            raw = tok.encode("utf-8")
            got = self._id_cache.get(raw)
            if got is None:
                got = self._native.encode_word(raw)
                if got is None:  # over the word limit, or outside the byte vocab
                    got = self._python_ids(raw)
                # bounded FIFO eviction: encode() sits on the serving path,
                # and high-entropy client text would otherwise grow the
                # cache without limit over a long-lived server
                with self._cache_lock:
                    if len(self._id_cache) >= _ENCODE_CACHE_MAX:
                        self._id_cache.pop(next(iter(self._id_cache)))
                    self._id_cache[raw] = got
            ids.extend(got)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids if int(i) in self.decoder)
        return bytearray(self.byte_decoder[c] for c in text).decode("utf-8", errors="replace")

    @classmethod
    def from_pretrained(cls, path: str) -> "GPTTokenizer":
        """Load from a directory with vocab.json + merges.txt."""
        return cls(os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"))
