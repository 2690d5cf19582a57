"""PyTorch port: every module imports without JAX and without the JAX
package, and the serve entry point refuses to start without a card
unless the CPU is asked for."""

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


def test_serve_without_card_raises():
    cfg = os.path.join(REPO, "configs", "gpt", "pretrain_gpt_345M_single.yaml")
    out = _run(["-m", "paddlefleetx_tpu_torch.tools.serve", "-c", cfg, "--port", "0"])
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr[-2000:]
