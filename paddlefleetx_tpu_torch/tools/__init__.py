"""Command-line entry points of the PyTorch port (``python -m
paddlefleetx_tpu_torch.tools.serve``)."""
