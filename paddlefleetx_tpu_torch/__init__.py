"""PaddleFleetX on PyTorch and CUDA: the GPU port of ``paddlefleetx_tpu``.

The JAX package beside this one is the reference: every module here is
held against its counterpart there by the ``tests/test_torch_*.py`` suite.
This package imports ``torch`` and never ``jax``, nor anything of
``paddlefleetx_tpu``.  Its entry points run on ``cuda`` unless the caller
asks for ``cpu``; without a card and without that request they raise.

Layout mirrors the JAX package: ``utils/`` (config, logging, device,
registry, checkpoints, resilience, telemetry), ``data/`` (GPT token
datasets, index maps and their C++ helpers, sampler and loaders),
``models/`` (dropout and recompute tags; GPT config, parameters, cached
and training forward, loss, generation), ``ops/`` (decode, paged and
flash attention and the fused LayerNorm with their CUDA kernels,
sampling), ``optims/`` (LR schedules, optimizers), ``core/`` (module,
serving, request queue, continuous batching, the training engine) and
``tools/`` (serve and train CLIs, profilers).
"""
