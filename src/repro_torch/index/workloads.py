"""SOSD-style datasets and query workloads on a `torch.Generator` (twin of
`repro/index/workloads.py`).

Synthetic key sets that match the published datasets' shapes (books /
OSM / Facebook / MIX), float32 in [0, 1).  Every draw comes from the
generator passed in, on that generator's device.  The streams differ from
the reference's `jax.random` ones; the tests hold these samplers to the
same properties instead.
"""
from __future__ import annotations

import dataclasses

import torch

DATASETS = ("uniform", "books", "osm", "fb", "mix")


def _normalize(keys: torch.Tensor) -> torch.Tensor:
    lo, hi = torch.min(keys), torch.max(keys)
    return (keys - lo) / torch.clamp(hi - lo, min=1e-12)


def _uniform(gen: torch.Generator, n: int, lo: float = 0.0, hi: float = 1.0):
    return torch.rand(n, generator=gen, device=gen.device) * (hi - lo) + lo


def sample_keys(gen: torch.Generator, n: int, dist: str = "mix",
                shift: float = 0.0) -> torch.Tensor:
    """n sorted unique-ish keys in [0,1). `shift` in [0,1] drifts the
    distribution (for data-shifting streams)."""
    dev = gen.device
    if dist == "uniform":
        x = _uniform(gen, n)
    elif dist == "books":  # lognormal-ish popularity
        x = torch.exp(torch.randn(n, generator=gen, device=dev)
                      * (1.0 + shift))
    elif dist == "osm":    # multi-modal clusters (geographic)
        n_clusters = 8
        centers = _uniform(gen, n_clusters)
        widths = _uniform(gen, n_clusters, 0.001, 0.05 + 0.1 * shift)
        assign = torch.randint(0, n_clusters, (n,), generator=gen, device=dev)
        x = centers[assign] + torch.randn(n, generator=gen, device=dev) \
            * widths[assign]
    elif dist == "fb":     # heavy-tailed ids
        u = _uniform(gen, n, 1e-6, 1.0)
        x = u ** (-1.0 / (1.5 + shift))  # pareto tail
    elif dist == "mix":
        parts = [sample_keys(gen, n, d, shift)
                 for d in ("uniform", "books", "osm", "fb")]
        assign = torch.randint(0, 4, (n,), generator=gen, device=dev)
        x = torch.stack(parts, 0)[assign, torch.arange(n, device=dev)]
    else:
        raise ValueError(f"unknown dataset {dist}")
    # dedupe-ish: add tiny deterministic jitter, normalize, sort
    x = _normalize(x) + torch.arange(n, device=dev) * 1e-12
    return torch.sort(_normalize(x)).values


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_reads: int = 2048
    n_inserts: int = 2048
    read_hit_frac: float = 0.9      # fraction of reads that hit existing keys
    insert_in_domain_frac: float = 0.9  # rest are out-of-domain (beyond max)
    insert_drift: float = 0.0       # distribution drift of inserted keys

    @property
    def wr_ratio(self) -> float:
        return self.n_inserts / max(self.n_reads, 1)


def make_workload(gen: torch.Generator, data_keys: torch.Tensor,
                  cfg: WorkloadConfig, dist: str = "mix"):
    """Returns dict of query arrays: reads [n_reads], inserts [n_inserts]."""
    dev = gen.device
    n = data_keys.shape[0]
    # reads: mostly existing keys, some misses
    idx = torch.randint(0, n, (cfg.n_reads,), generator=gen, device=dev)
    hits = data_keys[idx]
    misses = _uniform(gen, cfg.n_reads)
    is_hit = _uniform(gen, cfg.n_reads) < cfg.read_hit_frac
    reads = torch.where(is_hit, hits, misses)
    # inserts: in-domain from (possibly drifted) distribution; rest beyond
    # max.  One uniform draw picks both the out-of-domain offset and the
    # in-domain mask, as the reference draws both from one key.
    fresh = sample_keys(gen, cfg.n_inserts, dist, shift=cfg.insert_drift)
    dmax = torch.max(data_keys)
    u = _uniform(gen, cfg.n_inserts)
    out_of_domain = dmax + u * 0.2 + 1e-6
    in_dom = u < cfg.insert_in_domain_frac
    inserts = torch.where(in_dom, fresh * dmax, out_of_domain)
    return {"reads": reads, "inserts": inserts}


def wr_workload(gen: torch.Generator, data_keys: torch.Tensor,
                wr_ratio: float, total: int = 4096, dist: str = "mix",
                drift: float = 0.0):
    """Workload from a write/read ratio (paper: Balanced=1, RH=1/3, WH=3)."""
    n_ins = int(total * wr_ratio / (1.0 + wr_ratio))
    cfg = WorkloadConfig(n_reads=total - n_ins, n_inserts=n_ins,
                         insert_drift=drift)
    return make_workload(gen, data_keys, cfg, dist), cfg
