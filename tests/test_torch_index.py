"""The port's index leaves against the JAX reference, on the CPU.

Same numpy inputs through both packages.  Tolerances:
  * cost constants, ParamSpace tables, decode / decode_np / encode: equal
    (decode is held to the reference's op-by-op float32 arithmetic);
  * segment fits: rtol 1e-5 / atol 1e-6 (sums may be taken in another
    order);
  * ALEX / CARMI build, reads, inserts, memory: integer-valued fields
    bitwise, float metrics rtol 1e-4 (sum order, libm ulps);
  * workload stats: rtol 1e-6 (pins the population std);
  * the torch samplers: properties only (jax.random streams cannot be
    reproduced).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reward as jrw
from repro.core import spaces as jspaces
from repro.index import alex as jalex
from repro.index import carmi as jcarmi
from repro.index import cost as jcost
from repro.index import features as jfeatures
from repro.index import linear_model as jlm
from repro_torch import numerics
from repro_torch.core import reward as rw
from repro_torch.core import spaces
from repro_torch.index import alex, carmi, cost, features
from repro_torch.index import linear_model as lm
from repro_torch.index import workloads

SPACES = [("alex", jspaces.alex_space, spaces.alex_space),
          ("carmi", jspaces.carmi_space, spaces.carmi_space)]


def _keys(seed, n=2048):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(size=n // 2),
                        rng.normal(0.4, 0.02, n - n // 2)])
    x = (x - x.min()) / (x.max() - x.min())
    return np.sort(x.astype(np.float32) * np.float32(0.999))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_cost_constants_match_reference():
    names = [k for k in vars(jcost) if k.isupper()]
    assert names and names == [k for k in vars(cost) if k.isupper()]
    for k in names:
        assert getattr(cost, k) == getattr(jcost, k), k


@pytest.mark.parametrize("name,jspace,tspace", SPACES)
def test_param_space_decode_encode_bitwise(name, jspace, tspace):
    js, ts = jspace(), tspace()
    assert (js.names, js.kinds) == (ts.names, ts.kinds)
    np.testing.assert_array_equal(js.lows, ts.lows)
    np.testing.assert_array_equal(js.highs, ts.highs)
    rng = np.random.default_rng(1)
    actions = rng.uniform(-1.3, 1.3, (64, js.dim)).astype(np.float32)
    actions[0], actions[1], actions[2] = -1.0, 1.0, 0.0
    for a in actions:
        jd = js.decode(jnp.asarray(a))
        td = ts.decode(_t(a))
        for k in js.names:
            assert td[k].dtype == torch.float32
            assert np.float32(jd[k]) == td[k].numpy(), (k, a)
        assert ts.decode_np(a) == js.decode_np(a)
        np.testing.assert_array_equal(ts.encode(ts.decode_np(a)),
                                      js.encode(js.decode_np(a)))
    assert ts.random_raw(np.random.default_rng(3)) == \
        js.random_raw(np.random.default_rng(3))
    assert ts.grid_axes(4) == js.grid_axes(4)


@pytest.mark.parametrize("n_leaves", [512, 300, 37, 1])
def test_segment_fits_match_reference(n_leaves):
    keys = _keys(n_leaves)
    seg = np.minimum(np.arange(keys.size, dtype=np.float32)
                     * np.float32(n_leaves) / np.float32(keys.size),
                     n_leaves - 1).astype(np.int32)
    tol = dict(rtol=1e-5, atol=1e-6)
    for fit in ("fit_segments_exact", "fit_segments_approx"):
        want = getattr(jlm, fit)(jnp.asarray(keys), jnp.asarray(seg), 512)
        got = getattr(lm, fit)(_t(keys), _t(seg), 512)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    slope, icpt, _ = jlm.fit_segments_exact(jnp.asarray(keys),
                                            jnp.asarray(seg), 512)
    want = jlm.segment_errors(jnp.asarray(keys), jnp.asarray(seg), 512,
                              slope, icpt)
    got = lm.segment_errors(_t(keys), _t(seg), 512, _t(slope), _t(icpt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _param_sets(jspace, defaults, seed):
    rng = np.random.default_rng(seed)
    sets = [dict(defaults)] + [jspace().random_raw(rng) for _ in range(5)]
    return [{k: np.float32(v) for k, v in p.items()} for p in sets]


def _workload(seed, keys, m=1024):
    rng = np.random.default_rng(seed)
    reads = np.where(rng.uniform(size=m) < 0.9,
                     keys[rng.integers(0, keys.size, m)],
                     rng.uniform(size=m)).astype(np.float32)
    inserts = np.where(rng.uniform(size=m) < 0.9,
                       rng.uniform(size=m) * keys[-1],
                       keys[-1] + 0.1 + rng.uniform(size=m) * 0.1
                       ).astype(np.float32)
    return reads, inserts


INT_FIELDS = ("seg_of_key", "cnt", "n_leaves", "ood_buffer")
FLOAT_FIELDS = ("slope", "intercept", "err", "slots", "root_slope",
                "root_icpt")


def _assert_index_close(got: dict, want: dict):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in FLOAT_FIELDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k, v in want["counters"].items():
        np.testing.assert_allclose(got["counters"][k].numpy(), np.asarray(v),
                                   rtol=1e-4 if k == "build_cost_ns" else 0,
                                   err_msg=k)


def _assert_metrics_close(got: dict, want: dict):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["alex", "carmi"])
def test_index_build_reads_inserts_memory_match_reference(name):
    jmod, tmod = (jalex, alex) if name == "alex" else (jcarmi, carmi)
    jspace = dict((s[0], s[1]) for s in SPACES)[name]
    keys = _keys(11)
    reads, inserts = _workload(12, keys)
    for p in _param_sets(jspace, jmod.DEFAULTS, 13):
        jp = {k: jnp.float32(v) for k, v in p.items()}
        tp = {k: torch.tensor(v) for k, v in p.items()}
        jidx = jmod.build(jnp.asarray(keys), jp)
        tidx = tmod.build(_t(keys), tp)
        _assert_index_close(tidx, jidx)
        if name == "alex":
            jr = jmod.run_reads(jidx, jnp.asarray(reads))
            tr = tmod.run_reads(tidx, _t(reads))
        else:
            jr = jmod.run_reads(jidx, jnp.asarray(reads), jp)
            tr = tmod.run_reads(tidx, _t(reads), tp)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                   rtol=1e-4)
        _assert_metrics_close(tr[1], jr[1])
        jidx2, jns, jm = jmod.run_inserts(jidx, jnp.asarray(inserts), jp)
        tidx2, tns, tm = tmod.run_inserts(tidx, _t(inserts), tp)
        _assert_index_close(tidx2, jidx2)
        np.testing.assert_allclose(tns.numpy(), np.asarray(jns), rtol=1e-4)
        _assert_metrics_close(tm, jm)
        if name == "alex":
            jmem, tmem = jmod.memory_bytes(jidx2, jp), tmod.memory_bytes(
                tidx2, tp)
        else:
            jmem, tmem = jmod.memory_bytes(jidx2), tmod.memory_bytes(tidx2)
        np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), rtol=1e-4)


def test_workload_stats_match_reference():
    """Population std (correction=0), as jnp.std."""
    for seed in range(3):
        keys = _keys(seed, 2048 + 17 * seed)
        want = jfeatures.workload_stats(jnp.asarray(keys), 1.5)
        got = features.workload_stats(_t(keys), 1.5)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, err_msg=k)


def test_reward_matches_reference():
    rng = np.random.default_rng(5)
    r = rng.uniform(10.0, 200.0, (3, 256)).astype(np.float32)
    for omega, kappa in [(1, 2), (3, 4)]:
        want = jrw.reward(*(jnp.asarray(x) for x in r), omega, kappa)
        got = rw.reward(*(_t(x) for x in r), omega, kappa)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError):
        rw.reward(*(_t(x) for x in r), omega=2)


@pytest.mark.parametrize("dist", workloads.DATASETS)
def test_sample_keys_properties(dist):
    gen = torch.Generator().manual_seed(0)
    keys = workloads.sample_keys(gen, 2048, dist)
    k = keys.numpy()
    assert keys.dtype == torch.float32 and k.shape == (2048,)
    assert np.all(np.diff(k) >= 0)
    assert k.min() >= 0.0 and k.max() <= 1.0
    assert np.unique(k).size > 1024   # mostly distinct
    again = workloads.sample_keys(torch.Generator().manual_seed(0), 2048, dist)
    assert torch.equal(keys, again)   # a seed fixes the draw
    with pytest.raises(ValueError):
        workloads.sample_keys(gen, 16, "zipf")


@pytest.mark.parametrize("wr,total", [(1.0, 2048), (3.0, 4096), (1 / 3, 999)])
def test_wr_workload_properties(wr, total):
    gen = torch.Generator().manual_seed(1)
    keys = workloads.sample_keys(gen, 2048, "osm")
    wl, cfg = workloads.wr_workload(gen, keys, wr, total=total, dist="osm")
    n_ins = int(total * wr / (1.0 + wr))
    assert (cfg.n_inserts, cfg.n_reads) == (n_ins, total - n_ins)
    assert wl["inserts"].shape == (n_ins,) and wl["reads"].shape == (
        total - n_ins,)
    assert wl["reads"].dtype == wl["inserts"].dtype == torch.float32
    kmax = float(keys.max())
    ood = wl["inserts"].numpy() > kmax
    assert 0.02 < ood.mean() < 0.2        # ~10% beyond the key range
    hits = np.isin(wl["reads"].numpy(), keys.numpy())
    assert 0.8 < hits.mean() <= 1.0       # ~90% of reads hit stored keys


@pytest.mark.parametrize("n", [1, 2, 7, 100, 4097])
def test_percentile_and_clip_match_reference(n):
    """Linear-interpolation percentile as jnp.percentile (rtol 1e-5: XLA
    may fold the division by 100 into a reciprocal), NaN-propagating, and
    jnp.clip with tensor bounds."""
    rng = np.random.default_rng(n)
    x = rng.exponential(size=n).astype(np.float32)
    for pct in (0, 37.5, 50, 99, 100):
        np.testing.assert_allclose(
            numerics.percentile(_t(x), pct).numpy(),
            np.asarray(jnp.percentile(jnp.asarray(x), pct)), rtol=1e-5)
    x[n // 2] = np.nan
    assert np.isnan(numerics.percentile(_t(x), 99).numpy())
    lo, hi = np.float32(0.5), rng.uniform(1, 2, n).astype(np.float32)
    np.testing.assert_array_equal(
        numerics.clip(_t(x), float(lo), _t(hi)).numpy(),
        np.asarray(jnp.clip(jnp.asarray(x), lo, jnp.asarray(hi))))
