"""The hand-written CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc (the kernels have no CPU mode) and
skip without them.  They import neither JAX nor the JAX package, so they
run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.index_probe import kernel as K
from repro_torch.kernels.index_probe import ops
from repro_torch.kernels.index_probe.ref import probe_ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _dup_keys(rng, n):
    """Sorted float32 keys with runs of duplicates (some spanning tiles)."""
    return np.sort(rng.integers(0, max(n // 4, 1), n)).astype(np.float32)


def _queries(rng, n, m):
    """Queries stretched past both ends of the key range, plus exact hits."""
    q = (rng.uniform(size=m) * (n // 4) * 1.5 - (n // 8)).astype(np.float32)
    q[: m // 4] = np.floor(q[: m // 4])
    return q


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,tile", [
    (512, 1000, 512), (768, 333, 256), (2 ** 16, 4096, 512),
    (2 ** 16 + 1, 4096, 512), (1001, 777, 64), (5, 64, 512)])
def test_predecessor_ranks_kernel_bitwise(cuda_device, n, m, tile):
    """Bitwise equal to searchsorted, with a short last tile (and a tile
    longer than n) where the tile does not divide n."""
    rng = np.random.default_rng(n + m)
    keys = torch.from_numpy(_dup_keys(rng, n)).to(cuda_device)
    q = torch.from_numpy(_queries(rng, max(n, 8), m)).to(cuda_device)
    q[:2] = torch.tensor([-np.inf, np.inf])
    keys[-1] = np.inf
    want = torch.searchsorted(keys, q, right=True, out_int32=True)
    before = K.launch_counts["predecessor_ranks"]
    assert torch.equal(K.predecessor_ranks(keys, q, tile), want)
    # predecessor_positions launches the kernel for every n, odd ones too
    pos = ops.predecessor_positions(keys, q)
    assert K.launch_counts["predecessor_ranks"] == before + 2
    assert torch.equal(pos, torch.clamp(want - 1, 0, n - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles,tile,qcap", [(4, 128, 32), (16, 512, 300)])
def test_probe_tiles_kernel_bitwise(cuda_device, n_tiles, tile, qcap):
    rng = np.random.default_rng(tile)
    keys = _dup_keys(rng, n_tiles * tile).reshape(n_tiles, tile)
    q = _queries(rng, n_tiles * tile, n_tiles * qcap).reshape(n_tiles, qcap)
    valid = rng.uniform(size=(n_tiles, qcap)) < 0.8
    args = [torch.from_numpy(x).to(cuda_device) for x in (keys, q, valid)]
    got = K.probe_tiles(args[0], args[1], args[2].to(torch.int32))
    assert torch.equal(got, probe_ref(*args))


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda_device):
    keys = torch.zeros(512, device=cuda_device)
    with pytest.raises(ValueError):
        K.predecessor_ranks(keys.double(), keys[:4].double(), 512)
    with pytest.raises(ValueError):
        K.predecessor_ranks(keys, keys[:4], 384)
    with pytest.raises(ValueError):
        K.predecessor_ranks(keys[:0], keys[:4])
    with pytest.raises(ValueError):
        K.probe_tiles(keys.reshape(2, 256), keys[:8].reshape(1, 8),
                      torch.ones(1, 8, dtype=torch.int32, device=cuda_device))
