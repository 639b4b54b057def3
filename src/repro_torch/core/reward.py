"""The paper's tuning-oriented reward (§4.1), twin of `repro/core/reward.py`.

Delta_{t->0}   = (-R_t + R_0) / R_0
Delta_{t->t-1} = (-R_t + R_{t-1}) / R_{t-1}

r = ((1+D_t0)^2 - 1)^omega * (1+D_tt1)^kappa      if D_t0 > 0
  = -((1-D_t0)^2 - 1)^omega * (1-D_tt1)^kappa     if D_t0 <= 0

with omega odd (default 1) and kappa even (default 2).
"""
from __future__ import annotations

import torch


def deltas(r_t, r_0, r_prev):
    d_t0 = (-r_t + r_0) / torch.clamp(r_0, min=1e-9)
    d_tt1 = (-r_t + r_prev) / torch.clamp(r_prev, min=1e-9)
    return d_t0, d_tt1


def reward(r_t, r_0, r_prev, omega: int = 1, kappa: int = 2):
    if omega % 2 != 1 or kappa % 2 != 0:
        raise ValueError("omega must be odd and kappa even (paper)")
    d_t0, d_tt1 = deltas(r_t, r_0, r_prev)
    pos = ((1.0 + d_t0) ** 2 - 1.0) ** omega * (1.0 + d_tt1) ** kappa
    neg = -(((1.0 - d_t0) ** 2 - 1.0) ** omega) * (1.0 - d_tt1) ** kappa
    return torch.where(d_t0 > 0, pos, neg)
