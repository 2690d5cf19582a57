"""PyTorch port, the GPT data path against the JAX package's on the CPU:
the synthetic corpus writer, the index helpers (C++ and numpy), the
datasets' index maps and samples, the sampler and loaders across a
resume and a rewind, the index-map cache's quarantine, and the config
builders.  Everything here is integer or bitwise: no tolerance.
"""

import os

import numpy as np
import pytest
import torch

from paddlefleetx_tpu.data import batch_sampler as jax_bs
from paddlefleetx_tpu.data import gpt_dataset as jax_gd
from paddlefleetx_tpu.data import indexed as jax_indexed
from paddlefleetx_tpu_torch.data import batch_sampler as bs
from paddlefleetx_tpu_torch.data import gpt_dataset as gd
from paddlefleetx_tpu_torch.data import indexed
from paddlefleetx_tpu_torch.data.builders import build_dataloader, data_seed
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

SEQ = 32
KEYS = ("tokens", "labels", "loss_mask", "position_ids")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two small corpora written by the port's writer (vocab 96 and one
    above 2**16, for both token types)."""
    root = tmp_path_factory.mktemp("corpus")
    a = gd.write_synthetic_corpus(str(root / "a"), vocab_size=96, num_docs=60, mean_len=40,
                                  seed=3)
    b = gd.write_synthetic_corpus(str(root / "b"), vocab_size=70000, num_docs=40,
                                  mean_len=50, seed=4)
    return root, a, b


def test_synthetic_corpus_equals_jax(corpora, tmp_path):
    root, a, b = corpora
    for prefix, vocab, docs, mean, seed in ((a, 96, 60, 40, 3), (b, 70000, 40, 50, 4)):
        want = jax_gd.write_synthetic_corpus(str(tmp_path / os.path.basename(prefix)),
                                             vocab_size=vocab, num_docs=docs, mean_len=mean,
                                             seed=seed)
        for suffix in ("_ids.npy",):
            got_arr, want_arr = np.load(prefix + suffix), np.load(want + suffix)
            assert got_arr.dtype == want_arr.dtype and np.array_equal(got_arr, want_arr)
        assert np.array_equal(np.load(prefix + "_idx.npz")["lens"],
                              np.load(want + "_idx.npz")["lens"])


# ---------------------------------------------------------------------------
# the index helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq", [7, 32, 100])
def test_sample_idx_cpp_equals_numpy_and_jax(seq):
    rng = np.random.default_rng(seq)
    sizes = rng.integers(1, 60, 50).astype(np.int32)
    doc_idx = rng.permutation(50).astype(np.int32)
    tokens = int(sizes.sum())
    cpp = indexed.build_sample_idx(sizes, doc_idx, seq, 1, tokens, use_cpp=True)
    plain = indexed.build_sample_idx(sizes, doc_idx, seq, 1, tokens, use_cpp=False)
    want = jax_indexed.build_sample_idx(sizes, doc_idx, seq, 1, tokens, use_cpp=False)
    want_cpp = jax_indexed.build_sample_idx(sizes, doc_idx, seq, 1, tokens, use_cpp=True)
    assert cpp.dtype == plain.dtype == np.int32
    assert np.array_equal(cpp, plain) and np.array_equal(cpp, want)
    assert np.array_equal(cpp, want_cpp)


@pytest.mark.parametrize("weights", [[1.0, 1.0], [0.7, 0.2, 0.1], [3, 1, 1, 5]])
def test_blending_indices_cpp_equals_numpy_and_jax(weights):
    cpp = indexed.build_blending_indices(weights, 257, use_cpp=True)
    plain = indexed.build_blending_indices(weights, 257, use_cpp=False)
    want = jax_indexed.build_blending_indices(weights, 257, use_cpp=False)
    for got in (cpp, plain):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[0].dtype == np.int8 and got[1].dtype == np.int64


def test_shuffles_equal_jax():
    for fn, args in ((indexed.build_shuffle_idx, (40, 55)),
                     (indexed.build_doc_idx, (12, 3)), (indexed.build_doc_idx, (12, 1))):
        got = fn(*args, np.random.default_rng(9))
        want = getattr(jax_indexed, fn.__name__)(*args, np.random.default_rng(9))
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------


def _assert_items_equal(got, want):
    assert set(got) == set(KEYS) == set(want)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", ["Train", "Eval"])
def test_gpt_dataset_equals_jax(corpora, mode):
    """Maps and every sample, across three epochs (num_samples above one
    epoch), bit for bit; the JAX dataset reads the port's cache files."""
    _, a, _ = corpora
    kw = dict(data_prefix=a, split=[8, 2, 0], max_seq_len=SEQ, mode=mode, seed=11)
    first = gd.GPTDataset(**kw)
    kw["num_samples"] = first.samples_per_epoch * 2 + 3
    ours = gd.GPTDataset(**kw)
    theirs = jax_gd.GPTDataset(**dict(kw, build_cache=False))
    assert ours.num_epochs == theirs.num_epochs == 3
    for name in ("doc_idx", "sample_idx", "shuffle_idx"):
        assert np.array_equal(getattr(ours, name), getattr(theirs, name)), name
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        _assert_items_equal(ours[i], theirs[i])


def test_blended_dataset_equals_jax(corpora):
    _, a, b = corpora
    kw = dict(data_prefixes=[a, b], weights=[0.3, 0.7], split=[1, 0, 0], max_seq_len=SEQ,
              seed=5)
    ours, theirs = gd.BlendedGPTDataset(**kw), jax_gd.BlendedGPTDataset(**kw)
    assert len(ours) == len(theirs)
    assert np.array_equal(ours.ds_index, theirs.ds_index)
    assert np.array_equal(ours.ds_sample, theirs.ds_sample)
    for i in range(len(ours)):
        _assert_items_equal(ours[i], theirs[i])


def test_corrupt_cached_map_is_quarantined_and_rebuilt(corpora, tmp_path):
    _, a, _ = corpora
    prefix = str(tmp_path / "c")
    for suffix in ("_ids.npy", "_idx.npz"):
        os.link(a + suffix, prefix + suffix)
    kw = dict(data_prefix=prefix, split=[1, 0, 0], max_seq_len=SEQ, seed=2)
    clean = gd.GPTDataset(**kw)
    (shuffle_file,) = [f for f in os.listdir(tmp_path) if f.endswith("_shuffle_idx.npy")]
    with open(tmp_path / shuffle_file, "r+b") as f:
        f.truncate(40)  # a torn write
    rebuilt = gd.GPTDataset(**kw)
    names = os.listdir(tmp_path)
    assert any(n.endswith("_shuffle_idx.npy.corrupt") for n in names), names
    assert any(n.endswith("_doc_idx.npy.corrupt") for n in names), names
    assert np.array_equal(rebuilt.shuffle_idx, clean.shuffle_idx)
    assert np.array_equal(rebuilt.sample_idx, clean.sample_idx)
    # the rebuilt set is cached again and loads without a rebuild
    assert (tmp_path / shuffle_file).exists()
    assert np.array_equal(gd.GPTDataset(**kw).shuffle_idx, clean.shuffle_idx)


# ---------------------------------------------------------------------------
# the sampler and the loaders
# ---------------------------------------------------------------------------


def _take(it, n):
    return [next(it) for _ in range(n)]


def _loaders(prefix, seed=77, consumed=0, prefetch=False):
    """The port's and the JAX package's loaders over the same dataset
    arguments and one explicit sampler seed."""
    kw = dict(data_prefix=prefix, split=[1, 0, 0], max_seq_len=SEQ, seed=13, num_samples=50)
    out = []
    for mod_gd, mod_bs in ((gd, bs), (jax_gd, jax_bs)):
        ds = mod_gd.GPTDataset(**kw)
        sampler = mod_bs.DistributedBatchSampler(len(ds), 4, shuffle=True, drop_last=True,
                                                 seed=seed, consumed_samples=consumed)
        loader = mod_bs.DataLoader(ds, sampler, mod_bs.collate_stack)
        out.append(mod_bs.PrefetchLoader(loader, depth=2) if prefetch else loader)
    return out


@pytest.mark.parametrize("prefetch", [False, True])
def test_sampler_stream_equals_jax_across_resume_and_rewind(corpora, prefetch):
    """30 batches (2.4 epochs of 50 samples), then a loader resumed at
    consumed_samples 36 and a rewind to 20: the same batches as JAX's."""
    _, a, _ = corpora
    ours, theirs = _loaders(a, prefetch=prefetch)
    got, want = _take(iter(ours), 30), _take(iter(theirs), 30)
    for g, w in zip(got, want):
        _assert_items_equal(g, w)
    if not prefetch:
        assert ours.state_dict() == theirs.state_dict() == {"consumed_samples": 120, "skips": 0}
    ours_r, theirs_r = _loaders(a, consumed=36, prefetch=prefetch)
    resumed = _take(iter(ours_r), 5)
    for g, w in zip(resumed, _take(iter(theirs_r), 5)):
        _assert_items_equal(g, w)
    for g, w in zip(resumed, got[9:14]):
        _assert_items_equal(g, w)
    ours.rewind(20)
    theirs.rewind(20)
    for g, w, first in zip(_take(iter(ours), 4), _take(iter(theirs), 4), got[5:9]):
        _assert_items_equal(g, w)
        _assert_items_equal(g, first)
    ours.close()
    theirs.close()


def test_loader_skip_budget_substitutes_like_jax(corpora):
    """A sample that raises is replaced by the next index under max_skips,
    as JAX's loader does, and an exhausted budget raises."""
    _, a, _ = corpora

    class Rotten:
        def __init__(self, ds):
            self.ds = ds

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            if i in (3, 17):
                raise ValueError(f"bad record {i}")
            return self.ds[i]

    kw = dict(data_prefix=a, split=[1, 0, 0], max_seq_len=SEQ, seed=13, num_samples=50)
    streams = []
    for mod_gd, mod_bs in ((gd, bs), (jax_gd, jax_bs)):
        sampler = mod_bs.DistributedBatchSampler(50, 5, shuffle=False, seed=1)
        loader = mod_bs.DataLoader(Rotten(mod_gd.GPTDataset(**kw)), sampler,
                                   mod_bs.collate_stack, max_skips=2)
        streams.append((loader, _take(iter(loader), 4)))
    (ours, got), (theirs, want) = streams
    for g, w in zip(got, want):
        _assert_items_equal(g, w)
    assert ours.skips == theirs.skips == 2
    assert [e["substitute"] for e in ours.skip_events] == [4, 18]
    assert ours.skips_at(5) == 1 and ours.skips_at(20) == 2
    with pytest.raises(RuntimeError, match="max_skips budget exhausted"):
        _take(iter(bs.DataLoader(Rotten(gd.GPTDataset(**kw)),
                                 bs.DistributedBatchSampler(50, 5, seed=1), max_skips=0)), 1)


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------


def _cfg(input_dir, **loader):
    raw = {"Global": {"global_batch_size": 4, "seed": 1024},
           "Engine": {"max_steps": 6},
           "Model": {},
           "Data": {"Train": {"dataset": {"name": "GPTDataset", "input_dir": input_dir,
                                          "split": [9, 1, 0], "max_seq_len": SEQ},
                              "sampler": {"shuffle": True}, "loader": loader},
                    "Eval": {"dataset": {"name": "GPTDataset", "input_dir": input_dir,
                                         "split": [9, 1, 0], "max_seq_len": SEQ},
                             "sampler": {"shuffle": False}}}}
    return process_configs(AttrDict.from_nested(raw))


def test_build_dataloader(corpora, tmp_path):
    _, a, _ = corpora
    for suffix in ("_ids.npy", "_idx.npz"):
        os.link(a + suffix, str(tmp_path / "a") + suffix)
    cfg = _cfg(str(tmp_path))
    loader = build_dataloader(cfg, "Train", consumed_samples=8)
    assert len(loader.dataset) == 6 * 4 and loader.sampler.consumed_samples == 8
    assert loader.sampler.seed == data_seed(1024)
    assert 0 <= data_seed(1024) < 2**31 - 1 and data_seed(1024) != data_seed(1025)
    batch = next(iter(loader))
    assert batch["tokens"].shape == (4, SEQ) and loader.sampler.consumed_samples == 12
    ev = build_dataloader(cfg, "Eval")
    assert not ev.sampler.shuffle and ev.dataset.mode == "Eval"
    pre = build_dataloader(_cfg(str(tmp_path), prefetch=2), "Train")
    assert isinstance(pre, bs.PrefetchLoader)
    pre.close()
    with pytest.raises(NotImplementedError, match="WorkerLoader"):
        build_dataloader(_cfg(str(tmp_path), num_workers=2), "Train")
