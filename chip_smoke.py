#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. build  — compile the index-probe kernel (`csrc/index_probe.cu`, sm_90a)
              from this checkout and print the build time and ptxas report;
  2. parity — hold both kernel entries bitwise against their plain versions
              on the card: random shapes, ties, keys and queries at +-inf,
              queries below and above the keys, n with a short last tile
              (odd n included, through `predecessor_positions` too), and
              `predecessor_ranks` at the slice's size (2^20 keys, 65,536
              queries);
  3. small  — the env on the card against the same env on the CPU at 2048
              keys, teacher-forced with the same actions, ALEX and CARMI;
  4. main   — one `LITune.tune` request per index type at default width
              (LSTM 128, MLP 2x256) on 2^20 `osm` keys and 2^17 operations
              (W/R = 1), 25 steps, deterministic; launch counts are zeroed
              just before each request and read just after it;
  5. times  — each kernel entry against its plain version and the library
              call, at the main path's shapes: device time by CUDA-graph
              replay between CUDA events, and eager per-call wall time;
  6. profile — one warm episode step per index type under torch.profiler:
              device busy share, launches, syncs, top kernels and ops.
Then the card's name and power limit, one JSON line of kernel records, and
the result line.  Matmuls and convolutions run in full float32:
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_KEYS = 2 ** 20          # largest ALEX reservoir under the 64 MB budget
N_OPS = 2 ** 17           # operations per step at W/R = 1
BUDGET_STEPS = 25
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
PROBE_SOURCE = "src/repro_torch/kernels/index_probe/csrc/index_probe.cu"
PROBE_REPLACES = "src/repro/kernels/index_probe/kernel.py:24"


def _log(*args) -> None:
    print(*args, flush=True)


def _bitwise(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain version "
                             f"(max abs err {err})")
    return err


def _edge_keys(rng: np.random.Generator, n: int) -> np.ndarray:
    """Sorted float32 keys with heavy ties (runs across tile boundaries)
    and +-inf pad slots at both ends."""
    keys = np.sort(np.floor(rng.uniform(size=n) * max(n // 16, 2)))
    keys = keys.astype(np.float32)
    keys[:3] = -np.inf
    keys[-3:] = np.inf
    return keys


def _edge_queries(rng: np.random.Generator, keys: np.ndarray,
                  m: int) -> np.ndarray:
    """Exact hits, neighbours one ulp off, values below and above the keys,
    and +-inf."""
    finite = keys[np.isfinite(keys)]
    hits = rng.choice(finite, m // 3)
    toward = np.where(rng.uniform(size=m // 3) < 0.5, -np.inf, np.inf)
    off = np.nextafter(rng.choice(finite, m // 3), toward.astype(np.float32))
    wide = rng.uniform(finite.min() - 10, finite.max() + 10,
                       m - 2 * (m // 3) - 2).astype(np.float32)
    q = np.concatenate([hits, off, wide, [-np.inf, np.inf]])
    return rng.permutation(q).astype(np.float32)


def phase_parity(dev, K, ops, probe_ref, KernelConfig, data,
                 workload) -> dict:
    rng = np.random.default_rng(SEED)
    err = {"predecessor_ranks": 0, "probe_tiles": 0}
    # the last three cases have a short last tile (n is not a multiple of
    # the tile; in the last one the tile is longer than n)
    cases = [(8, 8, 5), (768, 256, 1000), (3 * 4096, 512, 777),
             (2 ** 16, 64, 10_000), (2 ** 16, 512, 4096),
             (2 ** 16 + 1, 512, 4096), (3 * 4096 + 7, 64, 777), (7, 512, 5)]
    ref_cfg = KernelConfig(mode="ref")
    for n, tile, m in cases:
        keys = torch.from_numpy(_edge_keys(rng, n)).to(dev)
        q = torch.from_numpy(_edge_queries(rng, keys.cpu().numpy(), m)).to(dev)
        got = K.predecessor_ranks(keys, q, tile)
        want = torch.searchsorted(keys, q, right=True, out_int32=True)
        err["predecessor_ranks"] = max(err["predecessor_ranks"], _bitwise(
            f"predecessor_ranks n={n} tile={tile} m={m}", got, want))
        # the env-facing op launches the kernel for every n
        before = K.launch_counts["predecessor_ranks"]
        got = ops.predecessor_positions(keys, q)
        if K.launch_counts["predecessor_ranks"] != before + 1:
            raise AssertionError(f"predecessor_positions n={n} did not "
                                 f"launch the kernel")
        _bitwise(f"predecessor_positions n={n}", got,
                 ops.predecessor_positions(keys, q, kernel=ref_cfg))
    # the slice's size: the main path's keys, reads and inserts
    tile = ops._auto_tile(N_KEYS)
    for name, q in workload.items():
        got = K.predecessor_ranks(data, q, tile)
        want = torch.searchsorted(data, q, right=True, out_int32=True)
        err["predecessor_ranks"] = max(err["predecessor_ranks"], _bitwise(
            f"predecessor_ranks slice-size {name}", got, want))
    for n_tiles, tile, qcap in [(1, 8, 6), (4, 128, 32), (16, 512, 300),
                                (N_KEYS // 512, 512, 64)]:
        keys = torch.from_numpy(
            _edge_keys(rng, n_tiles * tile).reshape(n_tiles, tile)).to(dev)
        q = torch.from_numpy(_edge_queries(
            rng, keys.cpu().numpy().ravel(), n_tiles * qcap).reshape(
                n_tiles, qcap)).to(dev)
        valid = torch.from_numpy(rng.uniform(size=(n_tiles, qcap)) < 0.8
                                 ).to(dev)
        got = K.probe_tiles(keys, q, valid.to(torch.int32))
        err["probe_tiles"] = max(err["probe_tiles"], _bitwise(
            f"probe_tiles T={n_tiles} tile={tile} qcap={qcap}", got,
            probe_ref(keys, q, valid)))
    # end to end through the grouped op, kernel against plain mode
    for qcap in (0, 4):
        q = workload["reads"][:8192]
        got = ops.batched_lookup(data, q, qcap=qcap)
        want = ops.batched_lookup(data, q, qcap=qcap, mode="ref")
        for g, w in zip(got, want):
            _bitwise(f"batched_lookup qcap={qcap}", g, w)
    torch.cuda.synchronize()
    _log(f"parity: both entries bitwise equal to their plain versions "
         f"({len(cases) + 2} rank cases, {len(cases)} predecessor_positions "
         f"cases, 4 tile cases, 2 grouped runs)")
    return err


def phase_small(dev, E) -> None:
    """The env on the card against the env on the CPU at a small size,
    teacher-forced with the same actions.  Tolerance rtol 1e-3 on runtime,
    atol 1e-3 on obs: the two devices sum in other orders and the
    segment fits' float32 cancellation amplifies that."""
    rng = np.random.default_rng(SEED + 1)
    keys = np.sort(rng.uniform(size=2048)).astype(np.float32)
    wl = {"reads": keys[rng.integers(0, 2048, 1024)],
          "inserts": (rng.uniform(size=1024) * 1.1).astype(np.float32)}
    for index_type, dim in (("alex", 14), ("carmi", 13)):
        cfg = E.EnvConfig(index_type=index_type, episode_len=6)
        actions = rng.uniform(-1, 1, (6, dim)).astype(np.float32)
        s_gpu, o_gpu = E.reset(cfg, keys, wl, 1.0, device=dev)
        s_cpu, o_cpu = E.reset(cfg, keys, wl, 1.0, device="cpu")
        worst = 0.0
        for a in actions:
            s_gpu, o_gpu, _, d_gpu, i_gpu = E.step_core(
                cfg, s_gpu, torch.from_numpy(a).to(dev))
            s_cpu, o_cpu, _, d_cpu, i_cpu = E.step_core(
                cfg, s_cpu, torch.from_numpy(a))
            rt_g, rt_c = float(i_gpu["runtime_ns"]), float(i_cpu["runtime_ns"])
            worst = max(worst, abs(rt_g - rt_c) / abs(rt_c))
            if not (math.isfinite(rt_g) and abs(rt_g - rt_c) <= 1e-3 * abs(
                    rt_c)):
                raise AssertionError(f"{index_type}: runtime {rt_g} on the "
                                     f"card vs {rt_c} on the CPU")
            np.testing.assert_allclose(o_gpu.cpu().numpy(), o_cpu.numpy(),
                                       atol=1e-3)
            if float(i_gpu["cost"]) != float(i_cpu["cost"]) or bool(
                    d_gpu) != bool(d_cpu):
                raise AssertionError(f"{index_type}: cost/done differ")
        _log(f"small {index_type}: 6 teacher-forced steps agree with the "
             f"CPU (max runtime rel diff {worst:.3g})")


def _check_summary(s: dict, dim: int) -> None:
    assert 1 <= s["steps"] <= BUDGET_STEPS, s["steps"]
    assert len(s["runtimes"]) == len(s["actions"]) == s["steps"]
    assert all(math.isfinite(r) and r > 0 for r in s["runtimes"])
    assert math.isfinite(s["r0_ns"]) and s["r0_ns"] > 0
    assert math.isfinite(s["episode_return"])
    for a in s["actions"]:
        assert a.shape == (dim,) and np.all(np.abs(a) <= 1.0)
    assert s["best_runtime_ns"] == min([s["r0_ns"]] + s["runtimes"])
    assert len(s["best_params"]) == dim


def phase_main(dev, K, E, LITune, LITuneConfig, data, workload) -> dict:
    out = {}
    for index_type, dim in (("alex", 14), ("carmi", 13)):
        cfg = LITuneConfig(index_type=index_type)
        tuner = LITune(cfg, seed=SEED, device=dev)
        env_cfg = cfg.env_cfg()
        _, _, viol = E.evaluate_params(env_cfg, E.defaults_raw(env_cfg, dev),
                                       data, workload, 1.0)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        s = tuner.tune(data, workload, 1.0, budget_steps=BUDGET_STEPS,
                       deterministic=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        _check_summary(s, dim)
        if counts["predecessor_ranks"] == 0:
            raise AssertionError(f"{index_type}: the main path launched no "
                                 f"predecessor_ranks kernel")
        _log(f"main {index_type}: r0_ns={s['r0_ns']!r} "
             f"best_runtime_ns={s['best_runtime_ns']!r} steps={s['steps']} "
             f"terminated_early={s['terminated_early']} "
             f"violations={s['violations']} reset c_m={float(viol['c_m'])} "
             f"c_r={float(viol['c_r'])} "
             f"memory_bytes={float(viol['memory_bytes'])!r} "
             f"launches={counts} wall_s={wall!r} "
             f"s_per_env_step={wall / s['steps']!r}")
        out[index_type] = {"summary": s, "launches": counts, "wall_s": wall,
                           "tuner": tuner}
    return out


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def phase_profile(E, etmdp, main_runs, data, workload) -> None:
    """Where one episode step's time goes: a warm step of each request
    type under torch.profiler.  Prints the step's wall time under the
    profiler, the device's busy and idle share, kernel launches and host
    syncs, and the top kernels by device time and ops by host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for index_type, run in main_runs.items():
        tuner = run["tuner"]
        env_cfg = tuner.cfg.env_cfg()
        state, obs = E.reset(env_cfg, data, workload, 1.0,
                             device=tuner.device)
        carry = etmdp.init_episode_carry(tuner.generator, state, obs,
                                         tuner.cfg.net_cfg())
        params = tuner.state["params"]

        def step(c):
            c, out = etmdp.episode_step(params, c, 0.0, env_cfg,
                                        tuner.cfg.et_cfg(),
                                        deterministic=True)
            float(out["reward"])      # the rollout's host read
            return c

        carry = step(carry)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(carry)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        host = [e for e in events if e.device_type == DeviceType.CPU]
        busy_us = sum(_device_us(e) for e in kernels)
        syncs = sum(e.count for e in host if "Synchronize" in e.key
                    or e.key in ("cudaMemcpyAsync", "aten::item",
                                 "aten::_local_scalar_dense"))
        _log(f"profile {index_type} step: wall_us={wall_us:.0f} (profiled) "
             f"device_busy_us={busy_us:.0f} idle_share="
             f"{1 - busy_us / wall_us:.3f} kernels="
             f"{sum(e.count for e in kernels)} host_syncs~{syncs}")
        for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
            _log(f"  device {_device_us(e):9.1f} us x{e.count:<4d} "
                 f"{e.key[:100]}")
        ops = [e for e in host if e.key.startswith("aten::")]
        for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:8]:
            _log(f"  host   {e.self_cpu_time_total:9.1f} us x{e.count:<4d} "
                 f"{e.key[:100]}")


def _graph_ms(fn, reps: int = 100, replays: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events, so host dispatch does
    not enter.  The inputs stay resident in L2 across calls, as on the
    main path, where the build has just read the keys."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _call_ms(fn, iters: int = 200) -> float:
    """Wall time of one eager call in a back-to-back loop: what a caller
    pays per call when host dispatch is slower than the device."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _in_turns(plain, kernel) -> tuple[float, float]:
    """Device times, in turns: plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (_graph_ms(f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(K, ops, probe_ref, data, workload) -> list:
    tile = ops._auto_tile(N_KEYS)
    n_tiles = N_KEYS // tile
    q = workload["reads"]
    m = q.shape[0]
    def library():
        return torch.searchsorted(data, q, right=True, out_int32=True)

    def kernel():
        return K.predecessor_ranks(data, q, tile)

    # the plain version is the library call itself: timed in the turns and
    # once more on its own
    ms, plain_ms = _in_turns(library, kernel)
    library_ms = _graph_ms(library)
    call_ms = {"kernel": _call_ms(kernel), "library": _call_ms(library)}
    # each query: a bisection over the n/tile boundaries, log2(tile) steps
    # and one correction, one compare each
    steps = math.ceil(math.log2(n_tiles + 1)) + int(math.log2(tile)) + 1
    bound, by = _bound_ms(4 * N_KEYS + 4 * m + 4 * m, m * steps)
    ranks = {"name": "index_probe.predecessor_ranks", "route": "cuda",
             "source": PROBE_SOURCE, "replaces": PROBE_REPLACES,
             "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
             "shape": f"keys [{N_KEYS}] f32, queries [{m}] f32",
             "call_ms": call_ms}

    # the grouped entry at batched_lookup's default capacity on these keys
    qcap = max(2 * m // n_tiles, 8)
    key_tiles = data.reshape(n_tiles, tile)
    g = torch.Generator(device=data.device).manual_seed(SEED)
    qg = torch.rand((n_tiles, qcap), generator=g, device=data.device)
    valid = torch.ones((n_tiles, qcap), dtype=torch.int32, device=data.device)
    vbool = valid > 0
    def t_kernel():
        return K.probe_tiles(key_tiles, qg, valid)

    def t_library():
        # every slot is valid, so the per-row searchsorted is the same
        # function
        return torch.searchsorted(key_tiles, qg, right=True, out_int32=True)

    _bitwise("probe_tiles vs row-wise searchsorted", t_kernel(), t_library())
    t_ms, t_plain = _in_turns(lambda: probe_ref(key_tiles, qg, vbool),
                              t_kernel)
    t_library_ms = _graph_ms(t_library)
    n_q = n_tiles * qcap
    t_bound, t_by = _bound_ms(4 * N_KEYS + 12 * n_q,
                              n_q * (int(math.log2(tile)) + 1))
    tiles = {"name": "index_probe.probe_tiles", "route": "cuda",
             "source": PROBE_SOURCE, "replaces": PROBE_REPLACES,
             "max_abs_err": 0, "ms": t_ms, "plain_ms": t_plain,
             "bound_ms": t_bound, "bound_by": t_by,
             "library_ms": t_library_ms,
             "shape": f"key_tiles [{n_tiles}, {tile}], queries "
                      f"[{n_tiles}, {qcap}]",
             "call_ms": {"kernel": _call_ms(t_kernel),
                         "library": _call_ms(t_library)}}
    return [ranks, tiles]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import etmdp
    from repro_torch.core.litune import LITune, LITuneConfig
    from repro_torch.index import env as E
    from repro_torch.index.workloads import sample_keys, wr_workload
    from repro_torch.kernels.dispatch import KernelConfig
    from repro_torch.kernels.index_probe import kernel as K
    from repro_torch.kernels.index_probe import ops
    from repro_torch.kernels.index_probe.ref import probe_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
         f"{torch.cuda.get_device_name(0)}; allow_tf32: matmul "
         f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
         f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    ptxas = K.build()
    _log(f"build: index_probe.cu for sm_90a in "
         f"{time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "Used" in line or "Compiling entry" in line:
            _log(f"  {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = sample_keys(gen, N_KEYS, "osm")
    workload, wcfg = wr_workload(gen, data, 1.0, total=N_OPS, dist="osm")
    _log(f"instance: {N_KEYS} osm keys, {wcfg.n_reads} reads + "
         f"{wcfg.n_inserts} inserts per step")

    err = phase_parity(dev, K, ops, probe_ref, KernelConfig, data,
                       workload)
    phase_small(dev, E)
    main_runs = phase_main(dev, K, E, LITune, LITuneConfig, data, workload)
    records = phase_times(K, ops, probe_ref, data, workload)
    phase_profile(E, etmdp, main_runs, data, workload)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    ranks, tiles = records
    ranks["max_abs_err"] = err["predecessor_ranks"]
    tiles["max_abs_err"] = err["probe_tiles"]
    # each request's counts were zeroed just before it and read just after
    for rec, entry in ((ranks, "predecessor_ranks"), (tiles, "probe_tiles")):
        rec["launches_by_path"] = {run: main_runs[run]["launches"][entry]
                                   for run in main_runs}
        rec["launches"] = sum(rec["launches_by_path"].values())
    for run in ("alex", "carmi"):
        steps = main_runs[run]["summary"]["steps"]
        _log(f"times [{smi}]: {run} s_per_env_step="
             f"{main_runs[run]['wall_s'] / steps!r} "
             f"probe_launches={main_runs[run]['launches']['predecessor_ranks']}"
             f" over {steps} steps + reset")
    for r in records:
        _log(f"times [{smi}]: {r['name']} at {r['shape']}: device ms="
             f"{r['ms']!r} plain_ms={r['plain_ms']!r} "
             f"library_ms={r['library_ms']!r} bound_ms={r['bound_ms']!r} "
             f"({r['bound_by']}); eager call ms {r['call_ms']}")
    extra = ("shape", "call_ms")
    # probe_tiles serves batched_lookup, which the tuning request does not
    # call: it is held and timed above, and listed apart from the path's
    # kernels
    _log(json.dumps({"off_path_kernels": [
        {k: v for k, v in tiles.items() if k not in extra}]}))
    _log(smi)
    _log(json.dumps({"kernels": [
        {k: v for k, v in ranks.items() if k not in extra}]}))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
