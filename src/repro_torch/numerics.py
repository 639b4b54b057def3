"""Two array functions whose float32 results the port must reproduce from
the reference's numpy-style library: ``clip`` and ``percentile``."""
from __future__ import annotations

import numpy as np
import torch


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """minimum(maximum(x, lo), hi), where either bound may be a number or
    a tensor (``jnp.clip``'s order; ``torch.clamp`` refuses a mix)."""
    x = torch.maximum(x, lo) if torch.is_tensor(lo) else x.clamp(min=lo)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else x.clamp(max=hi)


def percentile(x: torch.Tensor, pct: float) -> torch.Tensor:
    """Linear-interpolation percentile of a flat float32 tensor, with
    ``jnp.percentile``'s float32 arithmetic: q = pct/100 * (n-1),
    a[floor q] * (1 - w) + a[ceil q] * w with w = q - floor q, and NaN
    when any input is NaN.  Sorts instead of calling ``torch.quantile``,
    which refuses inputs above 2^24 elements."""
    a = torch.sort(x.reshape(-1)).values
    n = a.shape[0]
    q = np.float32(pct) / np.float32(100.0) * np.float32(n - 1)
    low, high = np.floor(q), np.ceil(q)
    high_w = np.float32(q - low)
    low_w = np.float32(1.0) - high_w
    lo_i = int(min(max(low, 0), n - 1))
    hi_i = int(min(max(high, 0), n - 1))
    out = a[lo_i] * float(low_w) + a[hi_i] * float(high_w)
    return torch.where(torch.isnan(x).any(), torch.nan, out)
