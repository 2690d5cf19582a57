"""PyTorch port, evaluation and the worker loader, against the JAX package
on the CPU: the eval datasets (``LM_Eval_Dataset``,
``Lambada_Eval_Dataset``) sample for sample, ``LMEvalMetric`` and
``format_metric``, ``GPTEvalModule.predict_fn``'s rows with bridged
weights, ``Engine.evaluate``'s metric stream and the eval CLI against the
JAX engine's ``evaluate``, and ``WorkerLoader`` against the inline loaders
of both packages across a resume.

The TINY GPT (vocab 96, 2 layers, hidden 32, 4 heads), float32, dropout
0, on a synthetic corpus.  Tolerances: datasets and batches bitwise; the
metric exact on the same rows; prediction rows and eval losses 1e-5
relative (float32, summation order).
"""

import copy
import json
import pickle

import jax
import numpy as np
import pytest
import torch
import yaml

from paddlefleetx_tpu.core.engine import Engine as JaxEngine
from paddlefleetx_tpu.core.module import build_module as jax_build_module
from paddlefleetx_tpu.data import batch_sampler as jax_bs
from paddlefleetx_tpu.data import gpt_dataset as jax_gd
from paddlefleetx_tpu.data.builders import build_dataloader as jax_build_dataloader
from paddlefleetx_tpu.models.gpt.evaluation import LMEvalMetric as JaxLMEvalMetric
from paddlefleetx_tpu.models.metrics import format_metric as jax_format_metric
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import GPTModule, build_module
from paddlefleetx_tpu_torch.data import batch_sampler as bs
from paddlefleetx_tpu_torch.data import gpt_dataset as gd
from paddlefleetx_tpu_torch.data.builders import build_dataloader
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.models.gpt.evaluation import GPTEvalModule, LMEvalMetric
from paddlefleetx_tpu_torch.models.metrics import METRICS, format_metric
from paddlefleetx_tpu_torch.tools import eval as eval_cli
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs
from paddlefleetx_tpu_torch.utils.registry import DATASETS

torch.set_num_threads(2)

SEQ = 32
MODEL = {"module": "GPTEvalModule", "vocab_size": 96, "hidden_size": 32, "num_layers": 2,
         "num_attention_heads": 4, "max_position_embeddings": 64, "dtype": "float32",
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
         "attn_impl": "flash", "flash_bwd": "fused", "use_fused_ln": True}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_corpus")
    gd.write_synthetic_corpus(str(root / "tiny"), vocab_size=96, num_docs=80, mean_len=60,
                              seed=1)
    return root


def _raw(corpus, out):
    ds = {"name": "GPTDataset", "input_dir": str(corpus), "split": [9, 1, 0],
          "max_seq_len": SEQ}
    return {
        "Global": {"global_batch_size": 4, "local_batch_size": 4, "micro_batch_size": 4,
                   "seed": 7},
        "Engine": {"max_steps": 4, "eval_iters": 3, "mix_precision": {"enable": False},
                   "save_load": {"save_steps": 0, "output_dir": str(out)}},
        "Model": dict(MODEL),
        "Distributed": {},
        "Data": {"Train": {"dataset": dict(ds)},
                 "Eval": {"dataset": dict(ds, mode="Eval"), "sampler": {"shuffle": False}}},
        "Optimizer": {"name": "FusedAdamW", "lr": {"name": "Constant", "learning_rate": 1e-3}},
    }


# ---------------------------------------------------------------------------
# datasets and the metric
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,seq,stride", [(200, 32, 8), (31, 32, 8), (100, 16, 16)])
def test_lm_eval_dataset_matches_jax(total, seq, stride):
    tokens = np.random.default_rng(total).integers(0, 96, total)
    ours = DATASETS.get("LM_Eval_Dataset")(tokens=tokens, seq_len=seq, overlapping_eval=stride)
    theirs = jax_gd.LMEvalDataset(tokens=tokens, seq_len=seq, overlapping_eval=stride)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), (i, key)


def test_lambada_eval_dataset_matches_jax():
    rng = np.random.default_rng(4)
    examples = [(rng.integers(0, 96, n), rng.integers(0, 96, m))
                for n, m in ((10, 2), (30, 3), (1, 1), (40, 5))]
    ours = DATASETS.get("Lambada_Eval_Dataset")(examples, seq_len=32)
    theirs = jax_gd.LambadaEvalDataset(examples, seq_len=32)
    assert len(ours) == len(theirs) == 4
    for i in range(4):
        for key, val in ours[i].items():
            assert np.array_equal(val, theirs[i][key]) and val.dtype == theirs[i][key].dtype
    assert ours[0]["loss_mask"].sum() == 2 and ours[3]["loss_mask"].sum() == 0


def test_lm_eval_metric_matches_jax():
    rng = np.random.default_rng(5)
    ours, theirs = LMEvalMetric(), JaxLMEvalMetric()
    for _ in range(3):
        rows = np.stack([rng.random(4) * 40, rng.integers(1, 32, 4).astype(np.float32),
                         rng.integers(0, 2, 4).astype(np.float32)], axis=-1)
        ours.update(rows)
        theirs.update(rows)
    assert format_metric(ours) == jax_format_metric(theirs)
    assert METRICS.get("LMEval") is LMEvalMetric
    ours.reset()
    assert ours.seqs == 0 and ours.accumulate()["tokens"] == 0.0


# ---------------------------------------------------------------------------
# the module, Engine.evaluate and the eval CLI against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_eval(corpus, tmp_path_factory):
    """The JAX engine with GPTEvalModule: its initial params, its evaluate
    loss over the Eval split, and the prediction rows of those batches."""
    raw = _raw(corpus, tmp_path_factory.mktemp("jax_out"))
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(raw)), num_devices=1)
    mesh = init_dist_env(cfg, devices=jax.devices()[:1])
    module = jax_build_module(cfg)
    with mesh:
        engine = JaxEngine(cfg, module, mesh)
        loss = engine.evaluate(jax_build_dataloader(cfg, "Eval"), iters=3)
        batches, rows = [], []
        for i, batch in enumerate(jax_build_dataloader(cfg, "Eval")):
            if i == 3:
                break
            batches.append(batch)
            rows.append(np.asarray(engine._get_predict_step()(engine.state,
                                                              engine._put_batch(batch))))
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), engine.state.params)
    return raw, params, loss, batches, rows


def _port_engine(raw, params):
    cfg = process_configs(AttrDict.from_nested(copy.deepcopy(raw)))
    module = build_module(cfg)
    assert isinstance(module, GPTEvalModule)
    return Engine(cfg, module, device="cpu",
                  model=params_from_jax(module.config, params, trainable=True))


def test_predict_rows_match_jax(jax_eval):
    raw, params, _, batches, rows = jax_eval
    engine = _port_engine(raw, params)
    for batch, want in zip(batches, rows):
        got = engine.module.predict_fn(engine.model, engine._device_batch(batch))
        assert got.shape == (4, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_engine_evaluate_streams_the_metric_as_jax(jax_eval):
    raw, params, want_loss, batches, rows = jax_eval
    engine = _port_engine(raw, params)
    cfg = process_configs(AttrDict.from_nested(copy.deepcopy(raw)))
    loss = engine.evaluate(build_dataloader(cfg, "Eval"), iters=3)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    want = JaxLMEvalMetric()
    for r in rows:
        want.update(r)
    got = format_metric(engine.last_metric)
    for key, val in jax_format_metric(want).items():
        assert got[key] == pytest.approx(val, rel=1e-5), key
    # a module without a metric keeps the plain loss stream
    plain_raw = copy.deepcopy(raw)
    plain_raw["Model"]["module"] = "GPTModule"
    plain_cfg = process_configs(AttrDict.from_nested(plain_raw))
    plain = Engine(plain_cfg, GPTModule(plain_cfg), device="cpu",
                   model=params_from_jax(GPTModule(plain_cfg).config, params, trainable=True))
    assert plain.evaluate(build_dataloader(plain_cfg, "Eval"), iters=3) == pytest.approx(
        want_loss, rel=1e-5)
    assert plain.last_metric is None


def test_eval_cli_loss_matches_jax(jax_eval, tmp_path, capsys):
    """tools/eval.py --device cpu over a checkpoint of the JAX engine's
    params: the loss of JAX ``Engine.evaluate`` and the metric of its rows."""
    raw, params, want_loss, _, rows = jax_eval
    path = _port_engine(raw, params).save(str(tmp_path / "step_0"))
    conf = tmp_path / "eval.yaml"
    conf.write_text(yaml.safe_dump(raw))
    capsys.readouterr()
    assert eval_cli.main(["-c", str(conf), "-o", f"Engine.save_load.ckpt_dir={path}",
                          "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["eval_loss"] == pytest.approx(want_loss, rel=1e-5) and out["batches"] == 3
    want = JaxLMEvalMetric()
    for r in rows:
        want.update(r)
    for key, val in jax_format_metric(want).items():
        assert out["metric"][key] == pytest.approx(val, rel=1e-5), key


# ---------------------------------------------------------------------------
# WorkerLoader
# ---------------------------------------------------------------------------


def _datasets(corpus):
    kw = dict(data_prefix=str(corpus / "tiny"), split=[9, 1, 0], max_seq_len=SEQ,
              mode="Train", seed=21, num_samples=64, build_cache=False)
    return gd.GPTDataset(**kw), jax_gd.GPTDataset(**kw)


def _take(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            assert x[key].dtype == y[key].dtype and np.array_equal(x[key], y[key]), key


def test_worker_loader_matches_inline_and_jax_across_a_resume(corpus):
    ours, theirs = _datasets(corpus)

    def sampler(mod, consumed=0):
        return mod.DistributedBatchSampler(len(ours), 4, shuffle=True, seed=99,
                                           consumed_samples=consumed)

    inline = _take(bs.DataLoader(ours, sampler(bs), bs.collate_stack), 6)
    _same(inline, _take(jax_bs.DataLoader(theirs, sampler(jax_bs), jax_bs.collate_stack), 6))
    workers = bs.WorkerLoader(ours, sampler(bs), bs.collate_stack, num_workers=2)
    try:
        _same(_take(workers, 3), inline[:3])
        state = workers.state_dict()
        assert state == {"consumed_samples": 12}
    finally:
        workers.close()
    resumed = bs.WorkerLoader(ours, sampler(bs), bs.collate_stack, num_workers=2)
    try:
        resumed.load_state(state)
        _same(_take(resumed, 3), inline[3:])
        resumed.rewind(4)  # a rollback: the pool is torn down, the order replays
        _same(_take(resumed, 2), inline[1:3])
    finally:
        resumed.close()
    assert resumed._gen is None


def test_gpt_dataset_pickles_without_its_tokens(corpus):
    """A worker gets the dataset by pickle: the token file travels as its
    path and is mapped again, so every sample is the same."""
    ours, _ = _datasets(corpus)
    blob = pickle.dumps(ours)
    assert len(blob) < ours.tokens.nbytes
    again = pickle.loads(blob)
    assert isinstance(again.tokens, np.memmap)
    _same([again[i] for i in range(5)], [ours[i] for i in range(5)])


def test_build_dataloader_takes_workers_and_warns_on_max_skips(corpus, tmp_path, monkeypatch):
    from paddlefleetx_tpu_torch.data import builders

    warned = []
    monkeypatch.setattr(builders.logger, "warning", lambda msg, *args: warned.append(msg % args))
    raw = _raw(corpus, tmp_path / "out")
    raw["Data"]["Train"]["loader"] = {"num_workers": 2, "max_skips": 3}
    loader = build_dataloader(process_configs(AttrDict.from_nested(raw)), "Train")
    try:
        assert isinstance(loader, bs.WorkerLoader) and loader.num_workers == 2
        assert any("max_skips is an inline-loader feature" in w for w in warned), warned
        raw["Data"]["Train"]["loader"] = {"num_workers": 0}
        inline = build_dataloader(process_configs(AttrDict.from_nested(raw)), "Train")
        _same(_take(loader, 2), _take(inline, 2))
    finally:
        loader.close()
