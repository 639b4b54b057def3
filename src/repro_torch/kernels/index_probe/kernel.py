"""Build, bind and launch the Hopper index-probe kernel
(`csrc/index_probe.cu`).

The CUDA source is compiled at first use with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface under ``build/`` next to this
file (git-ignored), and bound with ``ctypes``.  The library's name carries
a hash of the source, so an edited source is rebuilt.  Nothing is built
or loaded when this module is imported.

Each wrapper checks device, dtype, contiguity and shape, launches on
PyTorch's current stream, raises when the launch is refused, and counts
its launches in `launch_counts`.  There is no fallback: on a failed build
or launch the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_SRC = Path(__file__).parent / "csrc" / "index_probe.cu"
_BUILD_DIR = Path(__file__).parent / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dynamic shared memory a block may take without an opt-in attribute
_MAX_TILE = 48 * 1024 // 4

# launches per entry since the last `reset_launch_counts()`
launch_counts = {"probe_tiles": 0, "predecessor_ranks": 0}
build_log = {"ptxas": ""}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the index-probe kernel is built "
                       "from source at first use and needs the CUDA toolkit")


@functools.cache
def _library() -> ctypes.CDLL:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"libindex_probe_{tag}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
        build_log["ptxas"] = proc.stderr
        os.replace(tmp, lib_path)      # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_tiles.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.probe_tiles.restype = i32
    lib.predecessor_ranks.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.predecessor_ranks.restype = i32
    return lib


def build() -> str:
    """Compile (if needed) and load the library; returns ptxas's report of
    registers and shared memory per kernel (empty when already built)."""
    _library()
    return build_log["ptxas"]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tile(tile: int) -> None:
    if tile < 1 or tile & (tile - 1) or tile > _MAX_TILE:
        raise ValueError(f"tile={tile} must be a power of two <= {_MAX_TILE}")


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


def probe_tiles(key_tiles: torch.Tensor, queries: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """key_tiles [T, tile] f32 sorted per tile; queries [T, qcap] f32;
    valid [T, qcap] int32 -> in-tile counts of keys <= q, int32 [T, qcap]
    (-1 where valid is 0)."""
    dev = key_tiles.device
    _check("key_tiles", key_tiles, torch.float32, 2, dev)
    _check("queries", queries, torch.float32, 2, dev)
    _check("valid", valid, torch.int32, 2, dev)
    n_tiles, tile = key_tiles.shape
    _check_tile(tile)
    if queries.shape[0] != n_tiles or valid.shape != queries.shape:
        raise ValueError(f"shapes {tuple(key_tiles.shape)}, "
                         f"{tuple(queries.shape)}, {tuple(valid.shape)} "
                         f"do not agree")
    qcap = queries.shape[1]
    out = torch.empty((n_tiles, qcap), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.probe_tiles(key_tiles.data_ptr(), queries.data_ptr(),
                              valid.data_ptr(), out.data_ptr(), n_tiles, tile,
                              tile.bit_length() - 1, qcap,
                              torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_tiles")
    launch_counts["probe_tiles"] += 1
    return out


def predecessor_ranks(keys: torch.Tensor, queries: torch.Tensor,
                      tile: int = 512) -> torch.Tensor:
    """keys [n] f32 sorted, any n >= 1; queries [m] f32 -> int32 [m]
    counts of keys <= q (``torch.searchsorted(keys, q, right=True)``).
    ``tile`` (a power of two) is the routing granularity: the last tile
    is short when it does not divide n."""
    dev = keys.device
    _check("keys", keys, torch.float32, 1, dev)
    _check("queries", queries, torch.float32, 1, dev)
    _check_tile(tile)
    n, m = keys.shape[0], queries.shape[0]
    if n == 0 or n >= 2 ** 31:
        raise ValueError(f"n={n} must be positive and below 2**31")
    ranks = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return ranks
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.predecessor_ranks(keys.data_ptr(), queries.data_ptr(),
                                    ranks.data_ptr(), n, tile,
                                    tile.bit_length() - 1, m,
                                    torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "predecessor_ranks")
    launch_counts["predecessor_ranks"] += 1
    return ranks
