"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU: with no
explicit device, a machine without CUDA is an error, never a quiet fall back
to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising if there is no CUDA device); otherwise
    the device asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gear_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:  # tensors report "cuda:<n>"; compare like that
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
