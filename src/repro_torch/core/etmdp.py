"""ET-MDP: Early-Terminated MDP wrapper (paper §4.2, Def. 4.1/4.2), twin of
the serial path of `repro/core/etmdp.py`.

The CMDP (S, A, H, r, c, C, T) becomes an unconstrained MDP with an
absorbing state s_e: when the running cost b_t = sum(c^m_tau + c^r_tau)
exceeds the budget C, the episode moves to s_e with termination reward
r_e and stays there.

One step (`episode_step`) is: policy act -> critic hidden advance -> env
step -> ET-MDP bookkeeping.  `rollout_episode` drives it for one tuning
request.  Replay ingestion and the batched, scanned and per-lane serving
paths belong to later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import ddpg, networks as nets
from repro_torch.index import env as E


@dataclasses.dataclass(frozen=True)
class ETMDPConfig:
    cost_budget: float = 1.0        # C: tolerated failures per episode
    termination_reward: float = -1.0  # r_e (small, per the paper)
    enabled: bool = True            # False -> plain (unsafe) episodes


def init_episode_carry(generator: torch.Generator, env_state, obs,
                       net_cfg):
    """The per-episode recurrent state threaded through `episode_step`.
    ``generator`` draws the exploration noise."""
    dev = obs.device
    return {
        "generator": generator,
        "env": env_state,
        "obs": obs,
        "h_a": nets.zero_hidden(net_cfg, device=dev),
        "h_q": nets.zero_hidden(net_cfg, device=dev),
        "b_t": torch.zeros((), dtype=torch.float32, device=dev),
    }


@torch.no_grad()
def episode_step(params, carry, noise_scale, env_cfg: E.EnvConfig,
                 et_cfg: ETMDPConfig, deterministic: bool = False):
    """One ET-MDP step for a single episode.

    Returns (carry', outputs).  ``outputs["reward"]`` is the ET-MDP reward
    (termination reward substituted on early exit), ``outputs["early"]``
    the budget-exceeded flag, ``outputs["done"]`` early-or-horizon.
    """
    action, h_a2 = ddpg.act(params, carry["obs"], carry["h_a"],
                            carry["generator"], noise_scale=noise_scale,
                            deterministic=deterministic)
    # critic hidden advances on (obs, action) for stored-state replay
    _, h_q2 = params["critic0"](carry["obs"], action, carry["h_q"])
    env2, next_obs, r, done, info = E.step_core(env_cfg, carry["env"], action)
    cost = info["cost"]
    b_t = carry["b_t"] + cost
    if et_cfg.enabled:
        early = b_t > et_cfg.cost_budget
    else:
        early = torch.zeros_like(done)
    r_val = torch.where(early, et_cfg.termination_reward, r)
    next_obs_eff = torch.where(early, torch.zeros_like(next_obs), next_obs)
    done_flag = done | early
    new_carry = {"generator": carry["generator"], "env": env2,
                 "obs": next_obs_eff, "h_a": h_a2, "h_q": h_q2, "b_t": b_t}
    outputs = {"action": action, "reward": r_val, "raw_reward": r,
               "runtime_ns": info["runtime_ns"], "cost": cost,
               "early": early, "done": done_flag,
               "memory_bytes": info["memory_bytes"],
               # the transition view: pre-step obs/hiddens + the post-step
               # observation (zeroed on early exit, the absorbing state)
               "obs": carry["obs"], "next_obs": next_obs_eff,
               "h_a": carry["h_a"], "h_q": carry["h_q"]}
    return new_carry, outputs


reset_episode = E.reset


def rollout_episode(generator: torch.Generator, agent_state, net_cfg,
                    env_cfg: E.EnvConfig, et_cfg: ETMDPConfig, data_keys,
                    workload, wr_ratio, noise_scale: float = 0.1,
                    deterministic: bool = False, device=None):
    """Run one tuning episode under the ET-MDP on ``device`` (None ->
    CUDA; raises without CUDA).

    Returns a summary dict (episode return, best runtime, violations,
    terminated-early flag, runtime and action history).
    """
    device = resolve_device(device)
    env_state, obs = reset_episode(env_cfg, data_keys, workload, wr_ratio,
                                   device=device)
    carry = init_episode_carry(generator, env_state, obs, net_cfg)
    params = agent_state["params"]

    total_r, best_rt, violations = 0.0, float(env_state["r_best"]), 0.0
    terminated = False
    runtimes, actions = [], []
    for _ in range(env_cfg.episode_len):
        carry, out = episode_step(params, carry, noise_scale, env_cfg,
                                  et_cfg, deterministic=deterministic)
        violations += float(out["cost"])
        total_r += float(out["reward"])
        runtime = float(out["runtime_ns"])
        best_rt = min(best_rt, runtime)
        runtimes.append(runtime)
        actions.append(out["action"].cpu().numpy())
        if bool(out["early"]):
            terminated = True
            break
        if bool(out["done"]):
            break
    return {
        "episode_return": total_r,
        "best_runtime_ns": best_rt,
        "r0_ns": float(carry["env"]["r0"]),
        "violations": violations,
        "terminated_early": terminated,
        "runtimes": runtimes,
        "actions": actions,
        "steps": len(runtimes),
    }
