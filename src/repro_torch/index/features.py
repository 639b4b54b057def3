"""Universal state features (paper §4.1), twin of `repro/index/features.py`:
structural + operational metrics shared across index types, so one agent
architecture tunes both ALEX and CARMI.  26-dim float32 vector, roughly
normalized to O(1)."""
from __future__ import annotations

import torch

STATE_DIM = 26


def _log1p(x):
    return torch.log1p(torch.clamp(x, min=0.0))


def state_vector(idx: dict, read_m: dict, ins_m: dict, runtime_ns,
                 r_prev_ns, r0_ns, workload_stats: dict) -> torch.Tensor:
    """Assemble the state. All inputs are 0-d tensors from one step."""
    cnt = idx["cnt"]
    slots = torch.clamp(idx["slots"], min=1.0)
    active = cnt > 0
    occ = torch.where(active, cnt / slots, 0.0)
    n_active = active.sum().to(torch.float32)
    c = idx["counters"]

    feats = torch.stack([
        # ---- structural ----
        _log1p(n_active) / 7.0,
        _log1p(torch.sum(slots)) / 16.0,                 # memory footprint
        torch.sum(occ) / torch.clamp(n_active, min=1.0),  # avg occupancy
        torch.max(occ),                                  # max occupancy
        _log1p(torch.max(cnt)) / 14.0,                   # biggest node
        _log1p(torch.max(idx["err"])) / 10.0,            # worst model error
        _log1p(torch.sum(idx["err"] * active)
               / torch.clamp(n_active, min=1.0)) / 8.0,  # avg model error
        _log1p(idx["ood_buffer"]) / 12.0,
        _log1p(c["n_expands"]) / 8.0,
        _log1p(c["n_splits"]) / 8.0,
        _log1p(c["n_retrains"]) / 5.0,
        _log1p(c["mega_leaf"]) / 8.0,
        # ---- operational ----
        _log1p(read_m["avg_search_dist"]) / 8.0,
        _log1p(read_m["p99_search_dist"]) / 10.0,
        _log1p(read_m["avg_root_err"]) / 6.0,
        _log1p(read_m["read_ns_avg"]) / 10.0,
        _log1p(ins_m["insert_ns_avg"]) / 10.0,
        _log1p(ins_m["avg_displacement"]) / 6.0,
        ins_m["ood_frac"],
        ins_m["retrained"],
        # ---- runtime trajectory ----
        _log1p(runtime_ns * 1e-6) / 10.0,
        _log1p(r_prev_ns * 1e-6) / 10.0,
        _log1p(r0_ns * 1e-6) / 10.0,
        # ---- workload ----
        workload_stats["wr_ratio"] / 4.0,
        workload_stats["key_mean"],
        workload_stats["key_std"],
    ]).to(torch.float32)
    return feats


def workload_stats(data_keys: torch.Tensor, wr_ratio) -> dict:
    """Mean and population std (``jnp.std``: correction 0) of the keys."""
    return {
        "wr_ratio": torch.as_tensor(wr_ratio, dtype=torch.float32,
                                    device=data_keys.device),
        "key_mean": torch.mean(data_keys).to(torch.float32),
        "key_std": torch.std(data_keys, correction=0).to(torch.float32),
    }
