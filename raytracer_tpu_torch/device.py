"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a card raises: the
    plain PyTorch versions run only where the caller asks for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        if dev.index is None:   # compare equal to tensors' "cuda:N"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
