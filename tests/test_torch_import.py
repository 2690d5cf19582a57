"""PyTorch port: every module imports without JAX, without the JAX
package and without ``regex``, ``transformers`` or ``safetensors``, and
the serve entry point refuses to start without a card unless the CPU is
asked for."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import paddlefleetx_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "paddlefleetx_tpu.")))
bad += [m for m in sys.modules if m == "paddlefleetx_tpu"]
bad += sorted(m for m in sys.modules if m.split(".")[0] in ("regex", "transformers", "safetensors"))
print(len(names), bad)
print(" ".join(names))
"""

# the training slices' modules, each imported above without JAX
TRAINING = ("paddlefleetx_tpu_torch.core.engine", "paddlefleetx_tpu_torch.models.common",
            "paddlefleetx_tpu_torch.ops.attention", "paddlefleetx_tpu_torch.ops.flash_attention",
            "paddlefleetx_tpu_torch.optims.lr_scheduler", "paddlefleetx_tpu_torch.optims.optimizer",
            "paddlefleetx_tpu_torch.ops.fused_layernorm", "paddlefleetx_tpu_torch.data._build",
            "paddlefleetx_tpu_torch.data.batch_sampler", "paddlefleetx_tpu_torch.data.builders",
            "paddlefleetx_tpu_torch.data.gpt_dataset", "paddlefleetx_tpu_torch.data.index_cache",
            "paddlefleetx_tpu_torch.data.indexed", "paddlefleetx_tpu_torch.utils.checkpoint",
            "paddlefleetx_tpu_torch.utils.registry", "paddlefleetx_tpu_torch.utils.resilience",
            "paddlefleetx_tpu_torch.utils.telemetry", "paddlefleetx_tpu_torch.tools.train")
# the serving modules speculative decoding runs through, each imported above
# without JAX
SPECULATIVE = ("paddlefleetx_tpu_torch.ops.speculative", "paddlefleetx_tpu_torch.ops.sampling",
               "paddlefleetx_tpu_torch.ops.decode_attention",
               "paddlefleetx_tpu_torch.models.gpt.generation",
               "paddlefleetx_tpu_torch.core.serving",
               "paddlefleetx_tpu_torch.core.continuous_batching",
               "paddlefleetx_tpu_torch.tools.serve")
# the multi-tenant serving modules (the tenancy vocabulary, the metrics
# registry, the fault harness), each imported above without JAX
TENANCY = ("paddlefleetx_tpu_torch.core.tenancy", "paddlefleetx_tpu_torch.utils.telemetry",
           "paddlefleetx_tpu_torch.utils.resilience", "paddlefleetx_tpu_torch.core.request_queue")
# serving a trained or converted model with text: the tokenizer and its
# code-point table, the converters and their CLI, preprocessing, params
# loading; each imported above without JAX and without regex,
# transformers or safetensors
TEXT_SERVING = ("paddlefleetx_tpu_torch.data.tokenizers.gpt_tokenizer",
                "paddlefleetx_tpu_torch.data.tokenizers.unicode_classes",
                "paddlefleetx_tpu_torch.models.convert_common",
                "paddlefleetx_tpu_torch.models.gpt.convert",
                "paddlefleetx_tpu_torch.tools.convert_hf_gpt2",
                "paddlefleetx_tpu_torch.tools.preprocess_data",
                "paddlefleetx_tpu_torch.tools.gen_unicode_classes",
                "paddlefleetx_tpu_torch.utils.checkpoint")

# the rest of the training surface: chunked CE, evaluation (metrics, the
# eval module, the eval CLI); each imported above without JAX
TRAINING_REST = ("paddlefleetx_tpu_torch.ops.chunked_ce", "paddlefleetx_tpu_torch.models.metrics",
                 "paddlefleetx_tpu_torch.models.gpt.evaluation",
                 "paddlefleetx_tpu_torch.tools.eval")

# serving a float16 model: the decode kernels' float16 routes, the servers,
# the paged arena and its spill tier, generation, params loading and the
# serve CLI; each imported above without JAX
F16_SERVING = ("paddlefleetx_tpu_torch.ops.decode_attention",
               "paddlefleetx_tpu_torch.core.serving", "paddlefleetx_tpu_torch.core.paged_cache",
               "paddlefleetx_tpu_torch.core.continuous_batching",
               "paddlefleetx_tpu_torch.models.gpt.generation",
               "paddlefleetx_tpu_torch.utils.checkpoint", "paddlefleetx_tpu_torch.tools.serve")

# the serving step's dispatch path: dispatch-ahead and the CUDA graph cache;
# each imported above without JAX
DISPATCH = ("paddlefleetx_tpu_torch.core.step_graphs",
            "paddlefleetx_tpu_torch.core.continuous_batching",
            "paddlefleetx_tpu_torch.ops.decode_attention")

# serving observability and control: traces and the decision-log replay,
# the on-demand profiler, the admin rule; each imported above without JAX
OBSERVABILITY = ("paddlefleetx_tpu_torch.utils.tracing", "paddlefleetx_tpu_torch.utils.profiler",
                 "paddlefleetx_tpu_torch.core.router", "paddlefleetx_tpu_torch.utils.telemetry")


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=120, **kw)


def test_port_imports_no_jax():
    out = _run(["-c", _IMPORT_ALL])
    assert out.returncode == 0, out.stderr[-2000:]
    first, listed = out.stdout.strip().split("\n")
    count, bad = first.split(" ", 1)
    assert int(count) >= 25, out.stdout
    assert bad == "[]", out.stdout
    assert set(TRAINING) <= set(listed.split()), listed
    assert set(SPECULATIVE) <= set(listed.split()), listed
    assert set(TENANCY) <= set(listed.split()), listed
    assert set(TEXT_SERVING) <= set(listed.split()), listed
    assert set(TRAINING_REST) <= set(listed.split()), listed
    assert set(F16_SERVING) <= set(listed.split()), listed
    assert set(DISPATCH) <= set(listed.split()), listed
    assert set(OBSERVABILITY) <= set(listed.split()), listed


def test_eval_without_card_raises():
    cfg = os.path.join(REPO, "configs", "gpt", "pretrain_gpt_345M_single.yaml")
    out = _run(["-m", "paddlefleetx_tpu_torch.tools.eval", "-c", cfg])
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr[-2000:]


def test_serve_without_card_raises():
    cfg = os.path.join(REPO, "configs", "gpt", "pretrain_gpt_345M_single.yaml")
    out = _run(["-m", "paddlefleetx_tpu_torch.tools.serve", "-c", cfg, "--port", "0"])
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr[-2000:]
