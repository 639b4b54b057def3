"""Per-segment linear models (key -> position) with error bounds (twin of
`repro/index/linear_model.py`).

Segment ids are non-decreasing in every caller (ALEX and CARMI cut the
sorted keys into consecutive runs), so the per-segment sums are taken
with `torch.segment_reduce` over run lengths: a fixed summation order on
every run, where an atomic ``index_add_`` would change its float order
from run to run.  The float32 arithmetic is the reference's, including
its cancellation ``var = sxx - sx*sx/c``; only the order of the sums
differs.
"""
from __future__ import annotations

import torch


def _seg(x: torch.Tensor, lengths: torch.Tensor, reduce: str,
         initial: float | None = None) -> torch.Tensor:
    """Per-segment reduction of consecutive runs of ``lengths``."""
    return torch.segment_reduce(x, reduce, lengths=lengths, initial=initial)


def _local_ranks(keys, seg_id, cnt):
    """Rank of each key within its segment (exact in float32 below 2^24)."""
    starts = torch.cumsum(cnt, 0) - cnt
    return torch.arange(keys.shape[0], dtype=keys.dtype,
                        device=keys.device) - starts[seg_id]


def fit_segments_exact(keys: torch.Tensor, seg_id: torch.Tensor, n_segs: int):
    """Least-squares fit per segment of (key -> local rank).

    keys [n] sorted; seg_id [n] non-decreasing in [0, n_segs); returns
    (slope, intercept, count), each float32 [n_segs].
    """
    lengths = torch.bincount(seg_id, minlength=n_segs)
    cnt = lengths.to(torch.float32)
    pos = _local_ranks(keys, seg_id, cnt)
    sx = _seg(keys, lengths, "sum")
    sy = _seg(pos, lengths, "sum")
    sxx = _seg(keys * keys, lengths, "sum")
    sxy = _seg(keys * pos, lengths, "sum")
    c = cnt.clamp(min=1.0)
    var = sxx - sx * sx / c
    cov = sxy - sx * sy / c
    slope = torch.where(var > 1e-18, cov / var.clamp(min=1e-18), 0.0)
    intercept = (sy - slope * sx) / c
    return slope, intercept, cnt


def fit_segments_approx(keys: torch.Tensor, seg_id: torch.Tensor,
                        n_segs: int):
    """2-point (min/max) fit per segment — ALEX's approximate model path."""
    lengths = torch.bincount(seg_id, minlength=n_segs)
    kmin = _seg(keys, lengths, "min", initial=torch.inf)
    kmax = _seg(keys, lengths, "max", initial=-torch.inf)
    cnt = lengths.to(torch.float32)
    rng = (kmax - kmin).clamp(min=1e-18)
    slope = torch.where(cnt > 1, (cnt - 1) / rng, 0.0)
    intercept = -slope * torch.where(torch.isfinite(kmin), kmin, 0.0)
    return slope, intercept, cnt


def segment_errors(keys, seg_id, n_segs, slope, intercept):
    """Max |prediction - actual local rank| per segment (the probe bound)."""
    lengths = torch.bincount(seg_id, minlength=n_segs)
    pos = _local_ranks(keys, seg_id, lengths.to(torch.float32))
    pred = slope[seg_id] * keys + intercept[seg_id]
    err = torch.abs(pred - pos)
    return _seg(err, lengths, "max", initial=0.0)
