"""The port's index probe against the JAX reference, on the CPU.

Same numpy inputs through both packages: `probe_ref` against the Pallas
kernel (interpret mode) and the jnp oracle, `batched_lookup` ranks and
`dropped` masks (capacity overflow included) and `predecessor_positions`
(ragged fallback included).  All bitwise.  The hand-written CUDA kernel
itself runs only on the card: its tests are in `test_torch_cuda.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dispatch import KernelConfig as JKernelConfig
from repro.kernels.index_probe import ops as jops
from repro.kernels.index_probe.kernel import probe_pallas
from repro.kernels.index_probe.ref import probe_ref as jprobe_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.dispatch import KernelConfig
from repro_torch.kernels.index_probe import kernel as K
from repro_torch.kernels.index_probe import ops
from repro_torch.kernels.index_probe.ref import probe_ref


def _dup_keys(rng, n):
    """Sorted float32 keys with runs of duplicates (some spanning tiles)."""
    return np.sort(rng.integers(0, max(n // 4, 1), n)).astype(np.float32)


def _queries(rng, n, m):
    """Queries stretched past both ends of the key range, plus exact hits."""
    q = (rng.uniform(size=m) * (n // 4) * 1.5 - (n // 8)).astype(np.float32)
    q[: m // 4] = np.floor(q[: m // 4])
    return q


@pytest.mark.parametrize("n_tiles,tile,qcap", [
    (4, 128, 32), (8, 256, 16), (2, 512, 64), (16, 64, 8)])
def test_probe_ref_matches_reference(n_tiles, tile, qcap):
    rng = np.random.default_rng(n_tiles * tile + qcap)
    keys = _dup_keys(rng, n_tiles * tile).reshape(n_tiles, tile)
    queries = _queries(rng, n_tiles * tile, n_tiles * qcap).reshape(
        n_tiles, qcap)
    queries[0, :3] = [-np.inf, np.inf, keys[0, 0]]
    valid = rng.uniform(size=(n_tiles, qcap)) < 0.8
    got = probe_ref(torch.from_numpy(keys), torch.from_numpy(queries),
                    torch.from_numpy(valid)).numpy()
    want = np.asarray(jprobe_ref(jnp.asarray(keys), jnp.asarray(queries),
                                 jnp.asarray(valid)))
    pallas = np.asarray(probe_pallas(jnp.asarray(keys), jnp.asarray(queries),
                                     jnp.asarray(valid.astype(np.int32))))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("jmode", ["ref", "interpret"])
@pytest.mark.parametrize("tile,qcap", [(64, 96), (128, 96), (256, 0),
                                       (128, 4)])
def test_batched_lookup_matches_reference(jmode, tile, qcap):
    """Ranks and `dropped` bitwise, drop-free (qcap=m), default capacity
    and overflowing capacity alike."""
    rng = np.random.default_rng(tile + qcap)
    n = 8 * tile
    keys = _dup_keys(rng, n)
    q = _queries(rng, n, 96)
    ranks, dropped = ops.batched_lookup(torch.from_numpy(keys),
                                        torch.from_numpy(q), tile=tile,
                                        qcap=qcap)
    jr, jd = jops.batched_lookup(jnp.asarray(keys), jnp.asarray(q), tile=tile,
                                 qcap=qcap, mode=jmode)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jd))
    kept = ~dropped.numpy()
    want = np.searchsorted(keys, q, side="right")
    np.testing.assert_array_equal(ranks.numpy()[kept], want[kept])


def test_batched_lookup_capacity_overflow_flags_dropped():
    """Queries beyond a tile's `qcap` come back flagged `dropped` with rank
    -1, and the kept slots keep their true ranks."""
    rng = np.random.default_rng(7)
    tile = 128
    keys = np.sort(rng.uniform(size=8 * tile).astype(np.float32))
    queries = np.linspace(keys[1], keys[tile - 2], 32).astype(np.float32)
    ranks, dropped = ops.batched_lookup(torch.from_numpy(keys),
                                        torch.from_numpy(queries), tile=tile,
                                        qcap=4)
    ranks, dropped = ranks.numpy(), dropped.numpy()
    jr, jd = jops.batched_lookup(jnp.asarray(keys), jnp.asarray(queries),
                                 tile=tile, qcap=4, mode="interpret")
    assert dropped.sum() == 32 - 4
    assert np.all(ranks[dropped] == -1)
    np.testing.assert_array_equal(ranks, np.asarray(jr))
    np.testing.assert_array_equal(dropped, np.asarray(jd))
    want = np.searchsorted(keys, queries, side="right")
    np.testing.assert_array_equal(ranks[~dropped], want[~dropped])


@pytest.mark.parametrize("n", [512, 768, 2048, 1001, 4])
def test_predecessor_positions_matches_reference(n):
    """clip(searchsorted - 1) bitwise against the reference's Pallas path
    (interpret) and its jnp path — n=768 gives the reference a 256 tile,
    n=1001 and n=4 take its searchsorted fallback (the port's kernel
    routes them over a short last tile, `test_torch_cuda.py`)."""
    rng = np.random.default_rng(n)
    keys = _dup_keys(rng, n) if n > 4 else np.array([0, 1, 1, 2], np.float32)
    q = _queries(rng, max(n, 8), 64)
    got = ops.predecessor_positions(torch.from_numpy(keys),
                                    torch.from_numpy(q)).numpy()
    for jmode in ("interpret", "ref"):
        want = np.asarray(jops.predecessor_positions(
            jnp.asarray(keys), jnp.asarray(q),
            kernel=JKernelConfig(mode=jmode)))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.clip(np.searchsorted(keys, q, side="right") - 1, 0, n - 1))


def test_auto_tile_matches_reference():
    for n in [1, 4, 7, 8, 24, 96, 768, 1000, 1001, 2048, 3 * 2 ** 12, 2 ** 20]:
        assert ops._auto_tile(n) == jops._auto_tile(n), n


def test_kernel_config_validation_and_resolution():
    """Same mode validation as the reference's KernelConfig; `auto`
    resolves by the tensor's device and `kernel` refuses a CPU tensor."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    with pytest.raises(ValueError):
        KernelConfig(mode="fast")
    with pytest.raises(ValueError):
        JKernelConfig(mode="fast")
    with pytest.raises(ValueError):     # a Pallas mode, not a port mode
        KernelConfig(mode="interpret")
    assert KernelConfig() == KernelConfig() and hash(KernelConfig(
        mode="ref")) == hash(KernelConfig(mode="ref"))
    assert KernelConfig(mode="ref") != KernelConfig()
    assert KernelConfig().resolved(cpu) == "ref"
    assert KernelConfig().resolved(gpu) == "kernel"
    assert dispatch.resolve(None, cpu) == "ref"
    assert dispatch.resolve("auto", gpu) == "kernel"
    assert dispatch.resolve("ref", gpu) == "ref"
    with pytest.raises(ValueError):
        dispatch.resolve("kernel", cpu)
    with pytest.raises(ValueError):
        ops.predecessor_positions(torch.zeros(512), torch.zeros(4),
                                  kernel=KernelConfig(mode="kernel"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel on a CUDA tensor or raises; it never
    computes on the CPU in the kernel's place."""
    keys = torch.zeros(512)
    before = dict(K.launch_counts)
    with pytest.raises(ValueError):
        K.predecessor_ranks(keys, torch.zeros(4), 512)
    with pytest.raises(ValueError):
        K.probe_tiles(keys.reshape(1, 512), torch.zeros(1, 4),
                      torch.ones(1, 4, dtype=torch.int32))
    assert K.launch_counts == before
