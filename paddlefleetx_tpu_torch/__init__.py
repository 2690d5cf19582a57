"""PaddleFleetX on PyTorch and CUDA: the GPU port of ``paddlefleetx_tpu``.

The JAX package beside this one is the reference: every module here is
held against its counterpart there by the ``tests/test_torch_*.py`` suite.
This package imports ``torch`` and never ``jax``, nor anything of
``paddlefleetx_tpu``.  Its entry points run on ``cuda`` unless the caller
asks for ``cpu``; without a card and without that request they raise.

Layout mirrors the JAX package: ``utils/`` (config, logging, device),
``models/gpt/`` (config, parameters, cached forward, generation),
``ops/`` (flash-decode attention and its CUDA kernel, sampling),
``core/`` (module, serving, request queue) and ``tools/serve.py``.
"""
