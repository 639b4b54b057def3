"""One tuning request through the port against the JAX reference, on the
CPU, at a small size (2048 keys, 2048 ops, 8 steps).

  (a) env.reset + 8 step_core's teacher-forced with the reference agent's
      actions, for ALEX and CARMI: per-step runtime rtol 1e-4, reward
      rtol 1e-4 (atol 1e-5: a reward near 0 is a difference of two
      runtimes), obs atol 1e-4, cost / done / early bitwise.  Teacher
      forcing keeps ulp drift in the actions from being amplified by
      CARMI's action-continuous cost.
  (b) LITune.tune(deterministic=True) on ALEX, closed loop, with the
      agent moved over by `params_from_jax`: actions atol 1e-4, runtimes
      rtol 1e-4, steps / terminated_early / the best step and its discrete
      params equal, its continuous params rtol 1e-4 (as the actions).
  (c) an ET-MDP episode that breaks the memory budget ends early at the
      same step with the same violations in both packages.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import etmdp as jetmdp
from repro.core.litune import LITune as JLITune
from repro.core.litune import LITuneConfig as JLITuneConfig
from repro.index import env as JE
from repro_torch.core import etmdp
from repro_torch.core.litune import LITune, LITuneConfig, params_from_jax
from repro_torch.index import env as E

STEPS = 8


@pytest.fixture(scope="module")
def instance(small_index_instance):
    data, workload = small_index_instance
    return np.asarray(data), {k: np.asarray(v) for k, v in workload.items()}


@pytest.fixture(scope="module")
def reference(instance):
    """The reference agent (seed 0) and its deterministic request, per
    index type."""
    data, workload = instance
    out = {}
    for index_type in ("alex", "carmi"):
        agent = JLITune(JLITuneConfig(index_type=index_type), seed=0)
        summary = agent.tune(data, workload, 1.0, budget_steps=STEPS,
                             deterministic=True)
        out[index_type] = (agent, summary)
    return out


def _budget_between(memories):
    """A memory budget that at least two steps break and at least two
    keep, in the widest such gap between the steps' memories."""
    m = np.sort(np.unique(memories))
    i = 1 + int(np.argmax(np.diff(m)[1:-1]))
    return float(np.sqrt(m[i] * m[i + 1]))


def _jax_steps(cfg, data, workload, actions):
    """Per step: (runtime, obs, reward, cost, done, memory, cum_cost)."""
    state, obs = JE.reset(cfg, data, workload, 1.0)
    rows = []
    for a in actions:
        state, obs, r, done, info = JE.step(cfg, state, a)
        rows.append((float(info["runtime_ns"]), np.asarray(obs), float(r),
                     float(info["cost"]), bool(done),
                     float(info["memory_bytes"]), float(state["cum_cost"])))
    return rows


@pytest.mark.parametrize("index_type", ["alex", "carmi"])
def test_env_steps_teacher_forced(instance, reference, index_type):
    data, workload = instance
    actions = reference[index_type][1]["actions"]
    assert len(actions) == STEPS
    base = JE.EnvConfig(index_type=index_type, episode_len=STEPS - 2)
    mems = [row[5] for row in _jax_steps(base, data, workload, actions)]
    cfg_kw = dict(index_type=index_type, episode_len=STEPS - 2,
                  mem_budget=_budget_between(mems))
    jcfg, tcfg = JE.EnvConfig(**cfg_kw), E.EnvConfig(**cfg_kw)
    want = _jax_steps(jcfg, data, workload, actions)
    assert want[-1][6] > 1.0             # the budget bites: C = 1 is passed

    state, obs = E.reset(tcfg, data, workload, 1.0, device="cpu")
    _, jobs0 = JE.reset(jcfg, data, workload, 1.0)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs0), atol=1e-4)
    for a, (rt, wobs, wr, wcost, wdone, _, wcum) in zip(actions, want):
        state, obs, r, done, info = E.step_core(tcfg, state,
                                                torch.from_numpy(np.array(a)))
        np.testing.assert_allclose(float(info["runtime_ns"]), rt, rtol=1e-4)
        np.testing.assert_allclose(float(r), wr, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(obs.numpy(), wobs, atol=1e-4)
        assert float(info["cost"]) == wcost and bool(done) == wdone
        # ET-MDP's early flag: the running cost passes C = 1
        assert float(state["cum_cost"]) == wcum
        assert bool(state["cum_cost"] > 1.0) == (wcum > 1.0)


def test_tune_closed_loop_alex(instance, reference):
    data, workload = instance
    agent, want = reference["alex"]
    tuner = LITune(LITuneConfig(index_type="alex"), seed=0, device="cpu")
    tuner.state = params_from_jax(
        jax.tree.map(np.asarray, agent.state["params"]), device="cpu")
    got = tuner.tune(data, workload, 1.0, budget_steps=STEPS,
                     deterministic=True)
    assert set(got) == set(want)
    assert got["steps"] == want["steps"] == STEPS
    assert got["terminated_early"] == want["terminated_early"]
    np.testing.assert_allclose(np.stack(got["actions"]),
                               np.stack(want["actions"]), atol=1e-4)
    np.testing.assert_allclose(got["runtimes"], want["runtimes"], rtol=1e-4)
    np.testing.assert_allclose(got["r0_ns"], want["r0_ns"], rtol=1e-4)
    np.testing.assert_allclose(got["episode_return"], want["episode_return"],
                               rtol=1e-4, atol=1e-5)
    # the same step is best; its continuous params agree as the actions do
    assert np.argmin(got["runtimes"]) == np.argmin(want["runtimes"])
    kinds = dict(zip(tuner.cfg.env_cfg().space.names,
                     tuner.cfg.env_cfg().space.kinds))
    assert set(got["best_params"]) == set(want["best_params"])
    for k, v in want["best_params"].items():
        if kinds[k] == "cont":
            np.testing.assert_allclose(got["best_params"][k], v, rtol=1e-4)
        else:
            assert got["best_params"][k] == v, k
    assert got["violations"] == want["violations"]


@pytest.mark.parametrize("index_type", ["alex", "carmi"])
def test_etmdp_early_termination_matches_reference(instance, reference,
                                                   index_type):
    """A budget every step breaks: the second violation passes C = 1 and
    both packages end the episode there with the termination reward."""
    data, workload = instance
    agent = reference[index_type][0]
    kw = dict(index_type=index_type, episode_len=STEPS, mem_budget=1.0)
    want = jetmdp.rollout_episode(
        jax.random.PRNGKey(0), agent.state, agent.cfg.net_cfg(),
        JE.EnvConfig(**kw), jetmdp.ETMDPConfig(), data, workload, 1.0,
        noise_scale=0.0, deterministic=True)
    tuner = LITune(LITuneConfig(index_type=index_type), seed=0, device="cpu")
    state = params_from_jax(jax.tree.map(np.asarray, agent.state["params"]),
                            device="cpu")
    got = etmdp.rollout_episode(
        tuner.generator, state, tuner.cfg.net_cfg(), E.EnvConfig(**kw),
        etmdp.ETMDPConfig(), data, workload, 1.0, noise_scale=0.0,
        deterministic=True, device="cpu")
    assert got["terminated_early"] and want["terminated_early"]
    assert got["steps"] == want["steps"] == 2
    assert got["violations"] == want["violations"] == 2.0
    np.testing.assert_allclose(got["episode_return"], want["episode_return"],
                               rtol=1e-4, atol=1e-5)
