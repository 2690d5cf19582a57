"""Megatron-style GPT pretraining dataset over numpy token files.

Counterpart of ``paddlefleetx_tpu/data/gpt_dataset.py`` (``GPTDataset:67``,
``BlendedGPTDataset:240``, ``write_synthetic_corpus:395``).  Data format:
``{prefix}_ids.npy``, every document's tokens concatenated (uint16 or
uint32), and ``{prefix}_idx.npz`` with the document lengths (key
``lens``).  Samples are windows of ``seq_len + 1`` tokens walked across
shuffled documents; each item holds ``tokens``, ``labels``, ``loss_mask``
and ``position_ids``.

The maps are keyed by epoch, as in the JAX package: epoch e's document
order, window walk and shuffle come from ``np.random.default_rng([seed,
e])`` alone, and sample i lives in epoch ``i // samples_per_epoch``, so a
longer run appends epochs without reshuffling what came before and a
resumed or rewound stream serves the same tokens.  The maps are built by
the C++ helpers and cached beside the corpus (``data/index_cache.py``);
the cache key is the JAX package's, so both packages read each other's
caches.  The same corpus, split, seed and seq_len give the JAX package's
samples bit for bit.

``LM_Eval_Dataset`` and ``Lambada_Eval_Dataset`` come with the eval
module (not ported).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from paddlefleetx_tpu_torch.data.index_cache import (
    index_map_lock,
    load_index_cache,
    save_index_cache,
)
from paddlefleetx_tpu_torch.data.indexed import build_blending_indices, build_sample_idx
from paddlefleetx_tpu_torch.utils.log import logger
from paddlefleetx_tpu_torch.utils.registry import DATASETS

MODES = {"Train": 0, "Eval": 1, "Test": 2}


def _split_docs(num_docs: int, split: Sequence[float]):
    """Train/valid/test doc ranges from fractions."""
    split = np.asarray(split, dtype=np.float64)
    split = split / split.sum()
    bounds = np.concatenate([[0], np.cumsum(split)])
    edges = (bounds * num_docs).astype(np.int64)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(len(split))]


def _mode_doc_range(num_docs: int, split: Sequence[float], mode: str):
    """The doc range of ``mode``; all docs when the split leaves it empty."""
    lo, hi = _split_docs(num_docs, split)[MODES[mode]]
    if hi <= lo:
        lo, hi = 0, num_docs
    return lo, hi


def _corpus_prefixes(input_dir: str) -> List[str]:
    files = sorted(f[: -len("_ids.npy")] for f in os.listdir(input_dir)
                   if f.endswith("_ids.npy"))
    if not files:
        raise FileNotFoundError(f"no *_ids.npy under {input_dir}")
    return [os.path.join(input_dir, f) for f in files]


@DATASETS.register("GPTDataset")
class GPTDataset:
    def __init__(self, input_dir: str = None, data_prefix: str = None,
                 split: Sequence[float] = (949, 50, 1), max_seq_len: int = 1024,
                 num_samples: int = None, mode: str = "Train", seed: int = 1234,
                 build_cache: bool = True, **_unused):
        if data_prefix is None:
            prefixes = _corpus_prefixes(input_dir)
            if len(prefixes) > 1:
                logger.warning(f"{input_dir} holds {len(prefixes)} corpora; GPTDataset uses "
                               f"'{prefixes[0]}' only: use BlendedGPTDataset to mix them")
            data_prefix = prefixes[0]
        self.prefix = data_prefix
        self.seq_len = int(max_seq_len)
        self.mode = mode

        self.tokens = np.load(data_prefix + "_ids.npy", mmap_mode="r")
        lens = np.load(data_prefix + "_idx.npz")["lens"].astype(np.int32)
        self.doc_offsets = np.concatenate([[0], np.cumsum(lens.astype(np.int64))])

        lo, hi = _mode_doc_range(len(lens), split, mode)
        self.doc_lo = lo
        self.sizes = lens[lo:hi]
        self.seed = int(seed)
        self.tokens_per_epoch = int(self.sizes.sum())
        # windows are cut within one epoch's token stream (each needs
        # seq_len + 1 tokens, the label overlapping the next window)
        spe = (self.tokens_per_epoch - 1) // self.seq_len
        if spe < 1:
            raise ValueError(
                f"GPTDataset[{mode}]: split holds {self.tokens_per_epoch} tokens, not one "
                f"seq_len={self.seq_len}+1 window; shrink max_seq_len or feed a bigger "
                "corpus/split"
            )
        self.samples_per_epoch = spe
        self.num_samples = int(spe if num_samples is None else num_samples)
        num_epochs = max(1, -(-self.num_samples // spe))
        self.num_epochs = num_epochs

        # the JAX package's cache key: mode, seq_len, epoch count, seed,
        # split and the doc lengths, never num_samples
        hasher = hashlib.md5(json.dumps(
            [mode, self.seq_len, "epochs", num_epochs, self.seed, list(map(float, split))]
        ).encode())
        hasher.update(self.sizes.tobytes())
        cache = f"{data_prefix}_{mode.lower()}_{hasher.hexdigest()[:10]}"
        expect = {
            "doc_idx": ((num_epochs, len(self.sizes)), np.int32),
            "sample_idx": ((num_epochs, spe + 1, 2), np.int32),
            "shuffle_idx": ((num_epochs, spe), np.int32),
        }
        maps = load_index_cache(cache, expect) if build_cache else None
        if maps is None:
            if build_cache:
                with index_map_lock(cache):
                    maps = load_index_cache(cache, expect)
                    if maps is None:
                        maps = self._build_epoch_maps(num_epochs)
                        save_index_cache(cache, maps)
            else:
                maps = self._build_epoch_maps(num_epochs)
        self.doc_idx = maps["doc_idx"]
        self.sample_idx = maps["sample_idx"]
        self.shuffle_idx = maps["shuffle_idx"]
        logger.info(f"GPTDataset[{mode}] docs={len(self.sizes)} epochs={num_epochs} "
                    f"samples={self.num_samples} ({spe}/epoch) seq={self.seq_len}")

    def _build_epoch_maps(self, num_epochs: int) -> Dict[str, np.ndarray]:
        """doc/sample/shuffle maps for ``num_epochs`` epochs, epoch e drawn
        from ``default_rng([seed, e])`` alone."""
        n_docs = len(self.sizes)
        spe = self.samples_per_epoch
        doc_idx = np.empty((num_epochs, n_docs), dtype=np.int32)
        sample_idx = np.empty((num_epochs, spe + 1, 2), dtype=np.int32)
        shuffle_idx = np.empty((num_epochs, spe), dtype=np.int32)
        for e in range(num_epochs):
            rng = np.random.default_rng([self.seed, e])
            doc_idx[e] = rng.permutation(n_docs).astype(np.int32)
            sample_idx[e] = build_sample_idx(self.sizes, doc_idx[e], self.seq_len, 1,
                                             self.tokens_per_epoch)
            shuffle_idx[e] = rng.permutation(spe).astype(np.int32)
        return {"doc_idx": doc_idx, "sample_idx": sample_idx, "shuffle_idx": shuffle_idx}

    def __len__(self) -> int:
        return self.num_samples

    def _doc_tokens(self, doc: int, start: int, end: Optional[int] = None) -> np.ndarray:
        g = self.doc_lo + doc
        a = self.doc_offsets[g] + start
        b = self.doc_offsets[g + 1] if end is None else self.doc_offsets[g] + end
        return self.tokens[a:b]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        epoch, j = divmod(int(idx) % self.num_samples, self.samples_per_epoch)
        j = int(self.shuffle_idx[epoch, j])
        doc_row, sample_row = self.doc_idx[epoch], self.sample_idx[epoch]
        di_first, off_first = sample_row[j]
        di_last, off_last = sample_row[j + 1]
        if di_first == di_last:
            parts = [self._doc_tokens(doc_row[di_first], off_first, off_last + 1)]
        else:
            parts = [self._doc_tokens(doc_row[di_first], off_first)]
            parts += [self._doc_tokens(doc_row[di], 0) for di in range(di_first + 1, di_last)]
            parts.append(self._doc_tokens(doc_row[di_last], 0, off_last + 1))
        seq = np.concatenate(parts).astype(np.int64)
        if len(seq) != self.seq_len + 1:
            raise RuntimeError(f"GPTDataset[{self.mode}] sample {idx}: {len(seq)} tokens, "
                               f"expected {self.seq_len + 1} (corrupt index maps?)")
        return {
            "tokens": seq[:-1],
            "labels": seq[1:],
            "loss_mask": np.ones(self.seq_len, dtype=np.float32),
            "position_ids": np.arange(self.seq_len, dtype=np.int64),
        }


def _natural_samples(prefix: str, split: Sequence[float], mode: str, seq_len: int) -> int:
    """One epoch's sample count of a corpus split, from its lens file."""
    lens = np.load(prefix + "_idx.npz")["lens"].astype(np.int64)
    lo, hi = _mode_doc_range(len(lens), split, mode)
    return max((int(lens[lo:hi].sum()) - 1) // seq_len, 1)


@DATASETS.register("BlendedGPTDataset")
class BlendedGPTDataset:
    """A weighted mixture of GPT corpora: sample i comes from the corpus
    whose emitted share lags its weight most (``build_blending_indices``).
    ``data_prefixes`` or ``input_dir`` (every ``*_ids.npy`` in it);
    ``weights`` default to the corpora's one-epoch sample counts.  Corpus
    i draws its maps from seed ``seed + 31 * i``."""

    def __init__(self, input_dir: str = None, data_prefixes: Optional[Sequence[str]] = None,
                 weights: Optional[Sequence[float]] = None,
                 split: Sequence[float] = (949, 50, 1), max_seq_len: int = 1024,
                 num_samples: int = None, mode: str = "Train", seed: int = 1234,
                 build_cache: bool = True, **_unused):
        if data_prefixes is None:
            data_prefixes = _corpus_prefixes(input_dir)
        if len(data_prefixes) < 1:
            raise ValueError("BlendedGPTDataset needs >=1 data_prefixes")
        naturals = None
        if weights is None or num_samples is None:
            naturals = [_natural_samples(p, split, mode, int(max_seq_len))
                        for p in data_prefixes]
        if weights is None:
            weights = [float(n) for n in naturals]
        if len(weights) != len(data_prefixes):
            raise ValueError(f"{len(weights)} weights for {len(data_prefixes)} datasets")
        w = np.asarray(weights, dtype=np.float64)
        if (w <= 0).any():
            raise ValueError(f"weights must be positive, got {weights}")
        w = w / w.sum()
        self.num_samples = int(sum(naturals) if num_samples is None else num_samples)
        # each corpus must serve its share, with the JAX package's 0.5% slack
        self.children = [
            GPTDataset(data_prefix=p, split=split, max_seq_len=max_seq_len,
                       num_samples=int(np.ceil(self.num_samples * wi * 1.005)) + 1,
                       mode=mode, seed=seed + 31 * i, build_cache=build_cache)
            for i, (p, wi) in enumerate(zip(data_prefixes, w))
        ]
        self.ds_index, self.ds_sample = build_blending_indices(w, self.num_samples)
        logger.info(f"BlendedGPTDataset[{mode}] {len(self.children)} corpora, "
                    f"weights={np.round(w, 4).tolist()}, samples={self.num_samples}")

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        i = idx % self.num_samples
        return self.children[int(self.ds_index[i])][int(self.ds_sample[i])]


def write_synthetic_corpus(prefix: str, vocab_size: int = 50304, num_docs: int = 64,
                           mean_len: int = 600, seed: int = 0) -> str:
    """Write a corpus in the numpy token format: document lengths uniform
    in [mean_len / 2, 2 mean_len), tokens from a Zipf-like unigram
    distribution (learnable structure, unlike uniform tokens), all from
    ``default_rng(seed)``; the JAX package's writer, so the same seed
    gives the same files."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    rng = np.random.default_rng(seed)
    lens = rng.integers(mean_len // 2, mean_len * 2, num_docs).astype(np.int32)
    probs = 1.0 / (np.arange(vocab_size) + 5.0)
    probs /= probs.sum()
    tokens = rng.choice(vocab_size, size=int(lens.sum()), p=probs).astype(
        np.uint16 if vocab_size < 2**16 else np.uint32
    )
    np.save(prefix + "_ids.npy", tokens)
    np.savez(prefix + "_idx.npz", lens=lens)
    return prefix
