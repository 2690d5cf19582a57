"""Device resolution: the port runs on the card unless told otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device, and a
    ``RuntimeError`` when there is none; ``"cpu"`` -> the CPU, only when
    asked for.  There is no silent fallback from the card to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' (--device cpu) to run the plain "
                "PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; valid: cuda, cpu")
    return dev
