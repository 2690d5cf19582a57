"""PyTorch port, ``Engine.fit`` / ``evaluate`` / ``save`` / ``load`` and the
train CLI on the CPU: a 20-step fit and its evaluation against the JAX
engine's, checkpoint resume against an uninterrupted run, the anomaly
rollback against the JAX engine's, the train CLI (metrics, checkpoints,
SIGTERM, auto-resume, no card), and the refusals of what is not ported.

The TINY GPT (vocab 96, 2 layers, hidden 32, 4 heads) at the slice's
settings (flash attention with the fused backward, fused LayerNorm,
selective recompute, two micro-batches), float32, on a synthetic corpus.
Against JAX: dropout 0, weights through the bridge, both loaders over
their own package's dataset with one explicit sampler seed; losses and
eval within 1e-5 relative.  Resume: dropout on, bitwise.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from paddlefleetx_tpu.core.engine import Engine as JaxEngine
from paddlefleetx_tpu.core.module import build_module
from paddlefleetx_tpu.data import batch_sampler as jax_bs
from paddlefleetx_tpu.data import gpt_dataset as jax_gd
from paddlefleetx_tpu.parallel.env import init_dist_env
from paddlefleetx_tpu.utils.config import AttrDict as JaxAttrDict
from paddlefleetx_tpu.utils.config import process_configs as jax_process_configs
from paddlefleetx_tpu_torch.core.engine import Engine
from paddlefleetx_tpu_torch.core.module import GPTModule
from paddlefleetx_tpu_torch.data import batch_sampler as bs
from paddlefleetx_tpu_torch.data import gpt_dataset as gd
from paddlefleetx_tpu_torch.models.gpt.bridge import params_from_jax
from paddlefleetx_tpu_torch.ops import fused_layernorm as fl
from paddlefleetx_tpu_torch.utils.checkpoint import latest_checkpoint, resume_with_fallback
from paddlefleetx_tpu_torch.utils.config import AttrDict, process_configs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 32
SAMPLER_SEED = 4242
MODEL = {"module": "GPTModule", "vocab_size": 96, "hidden_size": 32, "num_layers": 2,
         "num_attention_heads": 4, "max_position_embeddings": 64, "dtype": "float32",
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
         "attn_impl": "flash", "flash_bwd": "fused", "use_fused_ln": True,
         "use_recompute": True, "recompute_granularity": "selective"}
RAW = {
    "Global": {"global_batch_size": 4, "micro_batch_size": 2, "seed": 7},
    "Engine": {"max_steps": 20, "logging_freq": 1, "eval_freq": 10, "eval_iters": 2,
               "mix_precision": {"enable": False}, "save_load": {"save_steps": 0}},
    "Model": MODEL,
    "Distributed": {},
    "Optimizer": {"name": "FusedAdamW", "weight_decay": 0.01, "beta1": 0.9, "beta2": 0.95,
                  "lr": {"name": "CosineAnnealingWithWarmupDecay", "max_lr": 5e-3,
                         "min_lr": 5e-4, "warmup_steps": 3, "decay_steps": 20},
                  "grad_clip": {"name": "ClipGradByGlobalNorm", "clip_norm": 1.0}},
}


def _raw(tmp, **sections):
    raw = copy.deepcopy(RAW)
    raw["Engine"]["save_load"]["output_dir"] = str(tmp / "out")
    raw["Engine"]["metrics_file"] = str(tmp / "metrics.jsonl")
    for section, values in sections.items():
        for key, val in values.items():
            if isinstance(val, dict) and isinstance(raw[section].get(key), dict):
                raw[section][key].update(val)
            else:
                raw[section][key] = val
    return raw


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit_corpus")
    return gd.write_synthetic_corpus(str(root / "tiny"), vocab_size=96, num_docs=80,
                                     mean_len=60, seed=1)


def _loader(mod_gd, mod_bs, prefix, mode, n, batch=4, shuffle=True):
    ds = mod_gd.GPTDataset(data_prefix=prefix, split=[9, 1, 0], max_seq_len=SEQ, mode=mode,
                           seed=21, num_samples=n, build_cache=False)
    sampler = mod_bs.DistributedBatchSampler(len(ds), batch, shuffle=shuffle,
                                             seed=SAMPLER_SEED)
    return mod_bs.DataLoader(ds, sampler, mod_bs.collate_stack)


class Poisoned:
    """A loader whose fetches ``first .. first + count - 1`` (counted over
    its life, so a replay after a rollback is clean) carry a NaN loss
    mask, as the JAX ``nan_grads`` fault does; everything else is the
    wrapped loader's."""

    def __init__(self, inner, first, count):
        self.inner, self.first, self.count, self.fetches = inner, first, count, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __iter__(self):
        for batch in self.inner:
            self.fetches += 1
            if self.first <= self.fetches < self.first + self.count:
                batch = dict(batch, loss_mask=np.full_like(batch["loss_mask"], np.nan))
            yield batch


def _jax_engine(raw):
    cfg = jax_process_configs(JaxAttrDict.from_nested(copy.deepcopy(raw)), num_devices=1)
    mesh = init_dist_env(cfg, devices=jax.devices()[:1])
    with mesh:
        engine = JaxEngine(cfg, build_module(cfg), mesh)
    return engine, mesh


def _port_engine(raw, jengine=None):
    cfg = process_configs(AttrDict.from_nested(copy.deepcopy(raw)))
    module = GPTModule(cfg)
    model = None
    if jengine is not None:
        tree = jax.tree.map(np.asarray, jengine.state.params)
        model = params_from_jax(module.config, tree, trainable=True)
    return Engine(cfg, module, device="cpu", model=model)


# ---------------------------------------------------------------------------
# fit and evaluate against the JAX engine
# ---------------------------------------------------------------------------


def test_fit_and_evaluate_match_jax(corpus, tmp_path):
    jraw, praw = _raw(tmp_path / "jax"), _raw(tmp_path / "port")
    jengine, mesh = _jax_engine(jraw)
    engine = _port_engine(praw, jengine)
    with mesh:
        jengine.fit(_loader(jax_gd, jax_bs, corpus, "Train", 80),
                    _loader(jax_gd, jax_bs, corpus, "Eval", None, shuffle=False))
        jeval = jengine.evaluate(_loader(jax_gd, jax_bs, corpus, "Eval", None, shuffle=False),
                                 iters=3)
    before = dict(fl.COUNTS)
    engine.fit(_loader(gd, bs, corpus, "Train", 80),
               _loader(gd, bs, corpus, "Eval", None, shuffle=False))
    peval = engine.evaluate(_loader(gd, bs, corpus, "Eval", None, shuffle=False), iters=3)
    want = [r for r in _records(jraw["Engine"]["metrics_file"]) if "loss" in r]
    got = _records(praw["Engine"]["metrics_file"])
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(1, 21))
    for g, w in zip(got, want):
        assert g["consumed_samples"] == w["consumed_samples"] == 4 * g["step"]
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5), g["step"]
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6), g["step"]
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4), g["step"]
        for key in ("ips", "tokens_per_sec", "data_wait_s", "host_s", "step_s", "model_flops",
                    "mem", "tokens_digest", "kernels"):
            assert key in g, key
        assert "mfu" not in g  # no peak on the CPU
    assert "compile_s" in got[0] and got[-1]["loss"] < got[0]["loss"]
    assert peval == pytest.approx(jeval, rel=1e-5)
    # 20 steps + 2 periodic evals of 2 batches + 3 eval batches; K1 on every
    # forward (selective recompute re-runs a layer's two), K2 per backward
    used = {k: fl.COUNTS[k] - before[k] for k in fl.COUNTS}
    assert used["fused_ln_fwd_plain"] == 20 * 2 * 9 + 7 * 5
    assert used["fused_ln_bwd_plain"] == 20 * 2 * 5
    assert got[3]["kernels"]["fused_ln_fwd_plain"] == 18
    assert got[3]["kernels"]["flash_plain"] == 8


def test_anomaly_rollback_lands_where_jax_does(corpus, tmp_path):
    """Steps 7-9 non-finite with max_skip_streak 3 and saves every 5:
    both engines roll back to step_5 at the same step, rewind the stream
    to its position and replay to step 14."""
    sections = {"Engine": {"max_steps": 14, "eval_freq": 0, "save_load": {"save_steps": 5},
                           "resilience": {"max_skip_streak": 3}}}
    jraw, praw = _raw(tmp_path / "jax", **sections), _raw(tmp_path / "port", **sections)
    jengine, mesh = _jax_engine(jraw)
    engine = _port_engine(praw, jengine)
    with mesh:
        jengine.fit(Poisoned(_loader(jax_gd, jax_bs, corpus, "Train", 56), 7, 3))
    engine.fit(Poisoned(_loader(gd, bs, corpus, "Train", 56), 7, 3))
    want = _records(jraw["Engine"]["metrics_file"])
    got = _records(praw["Engine"]["metrics_file"])
    assert [r.get("event", "step") for r in got] == [r.get("event", "step") for r in want]
    (jroll,) = [r for r in want if r.get("event") == "rollback"]
    (proll,) = [r for r in got if r.get("event") == "rollback"]
    assert proll["step"] == jroll["step"] == 9 and proll["rewound"] and jroll["rewound"]
    assert os.path.basename(proll["ckpt"]) == os.path.basename(jroll["ckpt"]) == "step_5"
    steps = [r for r in got if "loss" in r]
    assert [r["step"] for r in steps] == list(range(1, 10)) + list(range(6, 15))
    for g, w in zip(steps, [r for r in want if "loss" in r]):
        assert g["consumed_samples"] == w["consumed_samples"]
        if np.isfinite(w["loss"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5), g["step"]
        else:
            assert not np.isfinite(g["loss"])
    # the replayed window is the clean run's: steps 6-9 again, finite
    assert all(np.isfinite(r["loss"]) for r in steps[9:])
    assert engine.step == 14 and engine._consumed_samples == 56


# ---------------------------------------------------------------------------
# save / load / resume
# ---------------------------------------------------------------------------


def _dropout_raw(tmp, max_steps, save_steps):
    return _raw(tmp, Engine={"max_steps": max_steps, "eval_freq": 0,
                             "save_load": {"save_steps": save_steps}},
                Model={"hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1})


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(corpus, tmp_path):
    """Dropout on: 12 steps straight, against 6 steps, save, a fresh engine
    that loads step_6 and a loader resumed from its consumed_samples."""
    full = _port_engine(_dropout_raw(tmp_path / "full", 12, 0))
    full.fit(_loader(gd, bs, corpus, "Train", 48))
    first = _port_engine(_dropout_raw(tmp_path / "part", 6, 6))
    first.fit(_loader(gd, bs, corpus, "Train", 48))
    ckpt = tmp_path / "part" / "out" / "step_6"
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta == {"step": 6, "consumed_samples": 24,
                    "loader": {"consumed_samples": 24, "skips": 0}}
    second = _port_engine(_dropout_raw(tmp_path / "part", 12, 0))
    second.load(str(ckpt))
    assert second.step == 6 and second._consumed_samples == 24
    loader = _loader(gd, bs, corpus, "Train", 48)
    loader.sampler.rewind(second._consumed_samples)
    second.fit(loader)
    got = _records(tmp_path / "part" / "metrics.jsonl")
    want = _records(tmp_path / "full" / "metrics.jsonl")
    assert [r["step"] for r in got] == list(range(1, 13))
    assert [r["loss"] for r in got] == [r["loss"] for r in want]
    assert [r["tokens_digest"] for r in got] == [r["tokens_digest"] for r in want]
    for (name, p), q in zip(second.params.items(), full.params.values()):
        assert torch.equal(p, q), name
    assert second.opt_state[1]["count"] == full.opt_state[1]["count"] == 12


def test_corrupt_checkpoint_is_quarantined_and_resume_falls_back(corpus, tmp_path):
    engine = _port_engine(_dropout_raw(tmp_path, 8, 4))
    engine.fit(_loader(gd, bs, corpus, "Train", 32))
    out = tmp_path / "out"
    with open(out / "step_8" / "state.pt", "r+b") as f:
        f.truncate(100)  # bit rot the structural check cannot see
    fresh = _port_engine(_dropout_raw(tmp_path, 8, 4))
    assert resume_with_fallback(fresh, str(out)) == str(out / "step_4")
    assert fresh.step == 4 and (out / "step_8.corrupt").is_dir()
    assert latest_checkpoint(str(out)) == str(out / "step_4")
    with pytest.raises(ValueError, match="other parameters"):
        raw = _dropout_raw(tmp_path, 8, 4)
        raw["Model"]["hidden_size"] = 64
        _port_engine(raw).load(str(out / "step_4"))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

CONFIG = os.path.join(REPO, "configs", "gpt", "pretrain_gpt_345M_single.yaml")


def _cli_args(data_dir, out_dir, max_steps, extra=()):
    args = ["-c", CONFIG]
    for o in ("Model.num_layers=2", "Model.hidden_size=32", "Model.num_attention_heads=4",
              "Model.vocab_size=96", "Model.max_position_embeddings=32",
              "Model.use_fused_ln=True", "Model.use_recompute=True",
              "Model.recompute_granularity=selective", "Model.flash_bwd=fused",
              "Global.global_batch_size=4", "Global.local_batch_size=4",
              "Global.micro_batch_size=2", f"Data.Train.dataset.input_dir={data_dir}",
              f"Data.Eval.dataset.input_dir={data_dir}", f"Data.Train.dataset.max_seq_len={SEQ}",
              f"Data.Eval.dataset.max_seq_len={SEQ}", f"Engine.max_steps={max_steps}",
              "Engine.logging_freq=1", "Engine.eval_freq=3", "Engine.eval_iters=1",
              "Engine.save_load.save_steps=3", f"Engine.save_load.output_dir={out_dir}",
              f"Engine.metrics_file={out_dir}/metrics.jsonl", *extra):
        args += ["-o", o]
    return args


def _spawn(args, **env):
    """The train CLI in a subprocess on the CPU, its output drained by a
    thread (a full pipe would block it)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlefleetx_tpu_torch.tools.train", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="",
                 **env),
    )
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    return proc, lines, reader


def _finish(proc, lines, reader, timeout=240):
    rc = proc.wait(timeout=timeout)
    reader.join(timeout=30)
    assert not reader.is_alive()
    return rc, "".join(lines)


@pytest.fixture
def data_dir(corpus, tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    for suffix in ("_ids.npy", "_idx.npz"):
        os.link(corpus + suffix, str(d / "tiny") + suffix)
    return d


def test_train_cli_runs_saves_and_resumes_on_cpu(data_dir, tmp_path):
    out = tmp_path / "out"
    rc, log = _finish(*_spawn(_cli_args(data_dir, out, 6) + ["--device", "cpu"]))
    assert rc == 0, log[-3000:]
    records = _records(out / "metrics.jsonl")
    assert [r["step"] for r in records] == [1, 2, 3, 4, 5, 6]
    assert "eval loss" in log and "saved checkpoint" in log
    assert sorted(os.listdir(out)) == ["metrics.jsonl", "step_3", "step_6"]
    assert json.loads((out / "step_6" / "meta.json").read_text())["consumed_samples"] == 24
    assert all(r["kernels"]["fused_ln_fwd_plain"] > 0 and r["kernels"]["flash_plain"] > 0
               for r in records)
    # auto_resume continues from step_6 to 9, appending to the metrics
    rc, log = _finish(*_spawn(_cli_args(data_dir, out, 9, ["Engine.save_load.auto_resume=True"])
                              + ["--device", "cpu"]))
    assert rc == 0, log[-3000:]
    records = _records(out / "metrics.jsonl")
    assert [r["step"] for r in records] == list(range(1, 10))
    assert records[6]["consumed_samples"] == 28 and "loaded checkpoint" in log


def test_train_cli_sigterm_saves_a_preempted_checkpoint(data_dir, tmp_path):
    out = tmp_path / "out"
    proc, lines, reader = _spawn(_cli_args(data_dir, out, 100000) + ["--device", "cpu"])
    t0 = time.time()
    while not (out / "metrics.jsonl").exists() or len(_records(out / "metrics.jsonl")) < 2:
        assert proc.poll() is None and time.time() - t0 < 180, "".join(lines)[-3000:]
        time.sleep(0.1)
    proc.send_signal(signal.SIGTERM)
    rc, log = _finish(proc, lines, reader)
    assert rc == 0, log[-3000:]
    assert "clean early exit" in log
    path = latest_checkpoint(str(out))
    meta = json.loads(open(os.path.join(path, "meta.json")).read())
    assert meta["preempted"] is True and meta["step"] >= 2
    assert meta["consumed_samples"] == 4 * meta["step"]


def test_train_cli_without_card_raises(data_dir, tmp_path):
    rc, log = _finish(*_spawn(_cli_args(data_dir, tmp_path / "out", 2)))
    assert rc != 0
    assert "no CUDA device" in log, log[-2000:]


# ---------------------------------------------------------------------------
# what fit refuses
# ---------------------------------------------------------------------------

REFUSED = {
    "profiler": ({"Profiler": {"enable": True}}, {}),
    "consistency_check": ({"Engine": {"consistency_check_freq": 5}}, {}),
    "fault_injection": ({}, {"PFX_FAULT": "nan_grads:3"}),
    "tracing": ({}, {"PFX_TRACE_SAMPLE": "1"}),
    "flight_recorder": ({}, {"PFX_FLIGHT_RECORDER": "flight.jsonl"}),
}


# refused until their port landed, each case now holds the ported feature:
# "async_save", "pretrained_params", "worker_loader"
@pytest.mark.parametrize("name", sorted(REFUSED) + ["async_save", "pretrained_params",
                                                    "worker_loader"])
def test_fit_refuses_what_is_not_ported(name, tmp_path, monkeypatch, data_dir, corpus):
    if name == "async_save":
        # a fit saving asynchronously writes the synchronous fit's checkpoints
        paths = {}
        for mode in (False, True):
            raw = _raw(tmp_path / str(mode), Engine={
                "max_steps": 4, "save_load": {"save_steps": 2, "async_save": mode}})
            engine = _port_engine(raw)
            engine.fit(_loader(gd, bs, corpus, "Train", 16))
            engine.wait_for_save()
            paths[mode] = latest_checkpoint(str(tmp_path / str(mode) / "out"))
        assert os.path.basename(paths[True]) == "step_4" and engine.async_save
        a, b = (torch.load(os.path.join(paths[m], "state.pt"), weights_only=True)
                for m in (False, True))
        for n, p in a["params"].items():
            assert torch.equal(p, b["params"][n]), n
        return
    if name == "pretrained_params":
        # ported: a warm start from a saved step's params, optimizer state
        # fresh (the JAX engine's params-only restore)
        donor = _port_engine(_raw(tmp_path / "donor", Global={"seed": 11}))
        path = donor.save(str(tmp_path / "donor" / "step_0"))
        engine = _port_engine(_raw(tmp_path, Engine={"save_load": {"pretrained_params": path}}))
        seeded = _port_engine(_raw(tmp_path))
        assert any(not torch.equal(p, seeded.params[n]) for n, p in donor.params.items())
        for n, p in engine.params.items():
            assert torch.equal(p, donor.params[n]), n
        assert engine.step == 0 and engine.opt_state[1]["count"] == 0
        assert all(not m.any() for m in engine.opt_state[1]["mu"].values())
        return
    if name == "worker_loader":
        # num_workers > 0: the worker-process loader, serving the inline
        # loader's batches
        from paddlefleetx_tpu_torch.data.builders import build_dataloader
        from paddlefleetx_tpu_torch.utils.config import get_config

        overrides = _cli_args(data_dir, tmp_path, 2)[3::2]
        loaders = [build_dataloader(get_config(CONFIG, overrides + [f"Data.Train.loader."
                                                                    f"num_workers={n}"]),
                                    "Train") for n in (2, 0)]
        assert isinstance(loaders[0], bs.WorkerLoader)
        try:
            got, want = ([next(it) for _ in range(2)] for it in map(iter, loaders))
            for x, y in zip(got, want):
                assert all(np.array_equal(x[k], y[k]) for k in y)
        finally:
            loaders[0].close()
        return
    sections, env = REFUSED[name]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    raw = _raw(tmp_path)
    for section, values in sections.items():
        raw.setdefault(section, {})
        for key, val in values.items():
            if isinstance(val, dict):
                raw[section].setdefault(key, {}).update(val)
            else:
                raw[section][key] = val
    with pytest.raises(NotImplementedError):
        _port_engine(raw)
