"""Ops of the PyTorch port: flash-decode and paged attention, causal
flash attention and the fused LayerNorm for training (CUDA kernels +
plain versions), the attention dispatch, sampling, and the
speculative-decoding config parse."""
