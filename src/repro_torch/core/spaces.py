"""Mixed parameter spaces: [-1,1]^d agent actions <-> raw index parameters
(twin of `repro/core/spaces.py`).

Handles the paper's Table-2 heterogeneity: continuous ranges, booleans,
integers (linear in log2 space where declared as *_log2), discrete
choices, and CARMI's hybrid continuous/discrete lambda.  `decode` keeps
params as float32 0-d tensors on the action's device; the index
simulators consume them with soft thresholds for booleans/choices.
``torch.round`` rounds half to even, like ``jnp.round``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    names: tuple
    kinds: tuple           # cont | bool | int | choice | hybrid
    lows: np.ndarray
    highs: np.ndarray

    @property
    def dim(self) -> int:
        return len(self.names)

    # ---------- action <-> raw ----------
    def decode(self, action: torch.Tensor) -> dict:
        """action in [-1,1]^d -> dict of raw float32 0-d tensors."""
        a01 = (torch.clamp(action, -1.0, 1.0) + 1.0) * 0.5
        out = {}
        for i, (name, kind) in enumerate(zip(self.names, self.kinds)):
            lo, hi = float(self.lows[i]), float(self.highs[i])
            x = a01[i] * (hi - lo) + lo
            if kind == "bool":
                x = (a01[i] > 0.5).to(torch.float32)
            elif kind in ("int", "choice"):
                x = torch.round(x)
            out[name] = x.to(torch.float32)
        return out

    def decode_np(self, action) -> dict:
        """Host-side mirror of `decode` (same float32 arithmetic, numpy)."""
        a = np.asarray(action, np.float32)
        a01 = (np.clip(a, np.float32(-1.0), np.float32(1.0))
               + np.float32(1.0)) * np.float32(0.5)
        out = {}
        for i, (name, kind) in enumerate(zip(self.names, self.kinds)):
            lo, hi = float(self.lows[i]), float(self.highs[i])
            x = a01[i] * np.float32(hi - lo) + np.float32(lo)
            if kind == "bool":
                x = np.float32(a01[i] > 0.5)
            elif kind in ("int", "choice"):
                x = np.round(x)
            out[name] = float(np.float32(x))
        return out

    def encode(self, raw: dict) -> np.ndarray:
        """dict of raw params -> action in [-1,1]^d (for warm starts)."""
        a = np.zeros(self.dim, np.float32)
        for i, name in enumerate(self.names):
            lo, hi = float(self.lows[i]), float(self.highs[i])
            x = float(raw[name])
            a[i] = 2.0 * (x - lo) / max(hi - lo, 1e-9) - 1.0
        return np.clip(a, -1.0, 1.0)

    def random_raw(self, rng: np.random.Generator) -> dict:
        out = {}
        for i, (name, kind) in enumerate(zip(self.names, self.kinds)):
            lo, hi = float(self.lows[i]), float(self.highs[i])
            if kind == "bool":
                out[name] = float(rng.integers(0, 2))
            elif kind in ("int", "choice"):
                out[name] = float(rng.integers(int(lo), int(hi) + 1))
            else:
                out[name] = float(rng.uniform(lo, hi))
        return out

    def grid_axes(self, points_per_dim: int = 3):
        """Per-dimension grids (for grid search)."""
        axes = []
        for i, kind in enumerate(self.kinds):
            lo, hi = float(self.lows[i]), float(self.highs[i])
            if kind == "bool":
                axes.append([0.0, 1.0])
            elif kind in ("int", "choice"):
                n = min(points_per_dim, int(hi - lo) + 1)
                axes.append(list(np.round(np.linspace(lo, hi, n))))
            else:
                axes.append(list(np.linspace(lo, hi, points_per_dim)))
        return axes


def from_table(table) -> ParamSpace:
    names = tuple(t[0] for t in table)
    kinds = tuple(t[1] for t in table)
    lows = np.array([t[2][0] for t in table], np.float64)
    highs = np.array([t[2][1] for t in table], np.float64)
    return ParamSpace(names, kinds, lows, highs)


def alex_space() -> ParamSpace:
    from repro_torch.index.alex import PARAM_SPACE
    return from_table(PARAM_SPACE)


def carmi_space() -> ParamSpace:
    from repro_torch.index.carmi import PARAM_SPACE
    return from_table(PARAM_SPACE)
