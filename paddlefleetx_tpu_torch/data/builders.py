"""Dataset and loader builders from the config.

Counterpart of ``paddlefleetx_tpu/data/builders.py`` (``build_dataset``,
``build_dataloader``).  One difference: the JAX sampler's seed is
``SeedTracker.data_seed()``, a threefry draw the port cannot reproduce
without JAX; the port derives it from ``Global.seed`` with
:func:`data_seed` (documented below).  So with the same ``Global.seed``
the two packages shuffle their sample order differently; the datasets
themselves (``GPTDataset``'s seeded maps) are equal bit for bit, and a
test that compares the two streams gives both samplers one explicit
seed.
"""

from __future__ import annotations

from paddlefleetx_tpu_torch.data import gpt_dataset  # noqa: F401 (registers the datasets)
from paddlefleetx_tpu_torch.data.batch_sampler import (
    DataLoader,
    DistributedBatchSampler,
    PrefetchLoader,
    WorkerLoader,
    collate_stack,
)
from paddlefleetx_tpu_torch.models.common import fold_in
from paddlefleetx_tpu_torch.utils.log import logger
from paddlefleetx_tpu_torch.utils.registry import DATASETS

# the JAX SeedTracker's id of the data stream (parallel/seed.py _STREAM_IDS)
DATA_STREAM = 3


def data_seed(seed: int) -> int:
    """The sampler seed for ``Global.seed``: ``fold_in(seed, 3)``
    (splitmix64, ``models/common.fold_in``; 3 is the data stream's id)
    reduced to [0, 2**31 - 1), the range of the JAX draw."""
    return fold_in(int(seed), DATA_STREAM) % (2**31 - 1)


def build_dataset(cfg, mode: str, **extra):
    ds_cfg = dict(cfg.Data[mode].dataset)
    name = ds_cfg.pop("name")
    ds_cfg.setdefault("mode", mode)
    ds_cfg.update(extra)
    return DATASETS.get(name)(**ds_cfg)


def build_dataloader(cfg, mode: str, dataset=None, consumed_samples: int = 0):
    """Dataset, sampler and loader for a config mode (Train/Eval/Test).
    The Train dataset holds ``max_steps x global_batch_size`` samples;
    ``consumed_samples`` (from a restored checkpoint's meta) resumes the
    data order mid-epoch.  ``loader.num_workers > 0`` fetches the samples
    in worker processes (``WorkerLoader``); ``loader.prefetch > 0`` wraps
    the loader in a ``PrefetchLoader``."""
    loader_cfg = cfg.Data[mode].get("loader", {}) or {}
    num_workers = int(loader_cfg.get("num_workers", 0) or 0)
    max_skips = int(loader_cfg.get("max_skips", 0) or 0)
    if dataset is None:
        extra = {}
        if mode == "Train":
            extra["num_samples"] = int(cfg.Engine.max_steps) * int(cfg.Global.global_batch_size)
        dataset = build_dataset(cfg, mode, **extra)
    sampler_cfg = dict(cfg.Data[mode].get("sampler", {}) or {})
    batch_size = (int(cfg.Global.global_batch_size) if mode == "Train"
                  else int(cfg.Global.get("eval_batch_size") or cfg.Global.global_batch_size))
    sampler = DistributedBatchSampler(
        dataset_len=len(dataset), batch_size=batch_size,
        shuffle=bool(sampler_cfg.get("shuffle", mode == "Train")),
        drop_last=bool(sampler_cfg.get("drop_last", True)),
        seed=data_seed(cfg.Global.get("seed", 1024)), consumed_samples=consumed_samples,
    )
    if num_workers > 0:
        if max_skips:
            logger.warning(
                "Data.%s.loader.max_skips is an inline-loader feature; "
                "WorkerLoader (num_workers>0) propagates sample errors "
                "loudly instead of substituting", mode
            )
        loader = WorkerLoader(dataset, sampler, collate_stack, num_workers)
    else:
        loader = DataLoader(dataset, sampler, collate_stack, max_skips=max_skips)
    prefetch = int(loader_cfg.get("prefetch", 0) or 0)
    if prefetch > 0:
        loader = PrefetchLoader(loader, depth=prefetch,
                                stall_warn_s=float(loader_cfg.get("stall_warn_s", 30.0)))
    return loader
