"""The index-probe ops (twin of `repro/kernels/index_probe/ops.py`).

`batched_lookup` is the end-to-end grouped op: (sorted keys, queries) ->
global predecessor ranks, through boundary-key routing, capacity-grouped
dispatch and the in-tile probe (`probe_tiles` kernel on CUDA, `probe_ref`
on CPU).  It keeps the reference's ``dropped`` contract: queries beyond a
tile's capacity come back flagged with rank -1.

`predecessor_positions` is the probe at the bottom of every `run_reads`:
clip(#(keys <= q) - 1, 0, n-1).  On CUDA it launches the
`predecessor_ranks` kernel, which routes and bisects per query, instead
of the reference's ``batched_lookup(qcap=m)`` — at n = 2^20 and
m = 65,536 that grouped layout would be [2048, 65536] buffers, mostly
padding.  The ranks are bitwise equal either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.index_probe.kernel import (predecessor_ranks,
                                                    probe_tiles)
from repro_torch.kernels.index_probe.ref import probe_ref


def batched_lookup(keys: torch.Tensor, queries: torch.Tensor, tile: int = 512,
                   qcap: int = 0, mode: str | None = None):
    """keys [n] sorted (n % tile == 0); queries [m].

    Returns (ranks [m] int32, dropped [m] bool).  ``mode`` is a
    `kernels.dispatch` mode (None/"auto" -> decided by the keys' device).
    """
    mode = dispatch.resolve(mode, keys.device)
    n, m = keys.shape[0], queries.shape[0]
    if n % tile != 0:
        raise ValueError(f"n={n} is not a multiple of tile={tile}")
    dev = keys.device
    n_tiles = n // tile
    qcap = qcap or max(2 * m // n_tiles, 8)
    key_tiles = keys.to(torch.float32).reshape(n_tiles, tile)

    # root routing: tile of the predecessor via boundary keys
    boundaries = key_tiles[:, 0].contiguous()
    tile_of = torch.clamp(
        torch.searchsorted(boundaries, queries.to(torch.float32), right=True)
        - 1, 0, n_tiles - 1)

    # capacity-grouped dispatch: a query's slot is its rank among the
    # queries routed to the same tile
    order = torch.argsort(tile_of, stable=True)
    t_sorted = tile_of[order]
    starts = torch.searchsorted(t_sorted,
                                torch.arange(n_tiles, device=dev))
    pos_in_tile = torch.arange(m, device=dev) - starts[t_sorted]
    keep = pos_in_tile < qcap
    # overflow queries are left out of the grouped buffers (the
    # reference's out-of-bounds drop): they never clobber a kept slot
    q_grouped = torch.full((n_tiles, qcap), -torch.inf, dtype=torch.float32,
                           device=dev)
    v_grouped = torch.zeros((n_tiles, qcap), dtype=torch.int32, device=dev)
    kt, kp = t_sorted[keep], pos_in_tile[keep]
    q_grouped[kt, kp] = queries[order][keep].to(torch.float32)
    v_grouped[kt, kp] = 1

    if mode == "ref":
        pos = probe_ref(key_tiles, q_grouped, v_grouped > 0)
    else:
        pos = probe_tiles(key_tiles.contiguous(), q_grouped, v_grouped)

    # gather back to query order: global rank = tile_start + local rank
    # (dropped entries read a clamped slot; `keep` masks them to -1)
    local = pos[t_sorted, torch.clamp(pos_in_tile, max=qcap - 1)]
    global_rank = (t_sorted * tile + local).to(torch.int32)
    ranks = torch.zeros((m,), dtype=torch.int32, device=dev)
    ranks[order] = torch.where(keep, global_rank, -1).to(torch.int32)
    dropped = torch.zeros((m,), dtype=torch.bool, device=dev)
    dropped[order] = ~keep
    return ranks, dropped


def _auto_tile(n: int, cap: int = 512) -> int | None:
    """Largest power-of-two divisor of n, capped at `cap` — the reference's
    key-tile size.  None when n has no pow2 divisor >= 8 (there the
    reference falls back to searchsorted)."""
    t = min(n & -n, cap)
    return t if t >= 8 else None


def predecessor_positions(keys: torch.Tensor, queries: torch.Tensor,
                          kernel: dispatch.KernelConfig | None = None
                          ) -> torch.Tensor:
    """Predecessor positions clip(#(keys <= q) - 1, 0, n-1), int32.

    ``kernel`` is a `dispatch.KernelConfig` (None -> ``auto``).  The kernel
    mode launches `predecessor_ranks` for every n, routing over the
    reference's tile where n has one and over 512-key tiles with a short
    last tile where it has none; "ref" mode runs ``torch.searchsorted``.
    """
    n = keys.shape[0]
    mode = (kernel or dispatch.KernelConfig()).resolved(keys.device)
    if mode == "ref":
        rank = torch.searchsorted(keys, queries, right=True, out_int32=True)
    else:
        rank = predecessor_ranks(keys, queries, _auto_tile(n) or 512)
    return torch.clamp(rank - 1, 0, n - 1)
