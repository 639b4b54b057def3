"""PyTorch / CUDA port of the LITune reproduction.

The package mirrors `repro` (the JAX reference) module for module:
`repro_torch/index/alex.py` is the twin of `repro/index/alex.py`.  It
imports torch and numpy only.  Entry points run on CUDA unless the
caller names another device; without CUDA and without a device they
raise instead of dropping to the CPU on their own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device.  Raises when neither is available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
