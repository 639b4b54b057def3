"""Plain PyTorch version of the grouped index probe (the `probe_tiles`
kernel's oracle; twin of `repro/kernels/index_probe/ref.py`).

Keys are sorted and partitioned into tiles.  Queries arrive grouped per
tile and capacity-padded: ``queries [n_tiles, qcap]`` with
``valid [n_tiles, qcap]``.  For each valid query the result is the count
of keys in its tile that are <= q; invalid slots return -1.  The
broadcast compare materializes ``[n_tiles, qcap, tile]``, so it is meant
for small shapes.
"""
from __future__ import annotations

import torch


def probe_ref(key_tiles: torch.Tensor, queries: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """key_tiles [T, tile]; queries [T, qcap]; valid [T, qcap] bool ->
    positions [T, qcap] int32."""
    le = key_tiles[:, None, :] <= queries[:, :, None]   # [T, Q, tile]
    pos = le.sum(dim=-1, dtype=torch.int32)
    return torch.where(valid, pos, torch.full_like(pos, -1))
