"""Device resolution for the port's entry points.

Entry points default to the card (`"cuda"`). Asking for the card where
PyTorch sees no CUDA device raises: nothing silently carries on on the
CPU. Tests pass `device="cpu"` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
