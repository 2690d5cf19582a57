"""Ops of the PyTorch port: flash-decode attention (CUDA kernel + plain
version), sampling, and the speculative-decoding config parse."""
