"""Kernel-mode resolution: the one seam that decides, per call, whether an
op launches its hand-written CUDA kernel or runs its plain PyTorch version.

Modes:
  * ``auto``   — decided by the device of the tensor the op was given: a
                 CUDA tensor launches the kernel, a CPU tensor runs the
                 plain version (what the CPU tests run);
  * ``kernel`` — always the kernel; a CPU tensor raises;
  * ``ref``    — always the plain version, on any device.  Only an
                 explicit caller asks for it on CUDA (the comparison
                 phase of `chip_smoke.py`).

No environment variable changes the resolution: what an op runs follows
from its arguments alone.  `KernelConfig` is the frozen, hashable
carrier threaded through `EnvConfig`, validated like the reference's
(`repro/kernels/dispatch.py`).
"""
from __future__ import annotations

import dataclasses

import torch

MODES = ("auto", "kernel", "ref")


def _validate(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    return mode


def resolve(mode: str | None, device: torch.device) -> str:
    """Resolve a requested mode for a tensor on ``device`` to ``kernel`` or
    ``ref`` (never ``auto``)."""
    mode = _validate(mode or "auto")
    if mode == "auto":
        return "kernel" if device.type == "cuda" else "ref"
    if mode == "kernel" and device.type != "cuda":
        raise ValueError(f"kernel mode needs a CUDA tensor, got {device}")
    return mode


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Frozen kernel posture threaded through `EnvConfig`: ``mode`` picks
    the execution mode of every routed kernel (``auto`` decides by
    device).  The reference's ``probe_reads``, ``probe_tile`` and
    ``fused_tick`` knobs come with the first port caller that sets them.
    """

    mode: str = "auto"

    def __post_init__(self):
        _validate(self.mode)

    def resolved(self, device: torch.device) -> str:
        """This config's concrete mode for a tensor on ``device``."""
        return resolve(self.mode, device)
