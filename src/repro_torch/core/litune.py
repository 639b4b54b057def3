"""LITune — end-to-end automatic tuner for learned indexes, top-level API
(twin of the online half of `repro/core/litune.py`).

`LITune.tune` answers one tuning request on a concrete (data, workload)
with the ET-MDP-safe agent.  Pre-training (Meta-RL), the batched service
and the O2 stream belong to later slices.  `params_from_jax` moves a
trained agent from the reference into this package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import ddpg, networks as nets
from repro_torch.core.ddpg import DDPGConfig
from repro_torch.core.etmdp import ETMDPConfig, rollout_episode
from repro_torch.core.networks import NetConfig
from repro_torch.index import env as E


def attach_best_params(summary: dict, env_cfg: E.EnvConfig) -> dict:
    """Decode the best-runtime step's action into raw index parameters
    (host-side decode)."""
    best_t = int(np.argmin(summary["runtimes"]))
    return env_cfg.space.decode_np(np.asarray(summary["actions"][best_t]))


@dataclasses.dataclass(frozen=True)
class LITuneConfig:
    index_type: str = "alex"
    episode_len: int = 25
    lstm_hidden: int = 128
    mlp_hidden: int = 256
    ddpg: DDPGConfig = DDPGConfig()
    etmdp: ETMDPConfig = ETMDPConfig()
    safe_rl: bool = True      # False -> LITune w/o Safe-RL (ablation)

    def env_cfg(self) -> E.EnvConfig:
        return E.EnvConfig(index_type=self.index_type,
                           episode_len=self.episode_len)

    def net_cfg(self) -> NetConfig:
        return NetConfig(obs_dim=E.obs_dim(),
                         action_dim=self.env_cfg().space.dim,
                         lstm_hidden=self.lstm_hidden,
                         mlp_hidden=self.mlp_hidden)

    def et_cfg(self) -> ETMDPConfig:
        return self.etmdp if self.safe_rl else \
            dataclasses.replace(self.etmdp, enabled=False)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_jax(tree: dict, device=None) -> dict:
    """Agent state (params + targets) from the reference's
    ``agent_state["params"]`` pytree as numpy arrays:
    ``{"actor": {"lstm": {wi, wh, b}, "mlp": {l0, l1, out: {w, b}}},
    "critic0": {...}}``.  The network widths are read off the shapes, and
    every leaf must land on a parameter of the same shape."""
    actor = tree["actor"]
    cfg = NetConfig(
        obs_dim=np.shape(actor["lstm"]["wi"])[0],
        action_dim=np.shape(actor["mlp"]["out"]["w"])[1],
        lstm_hidden=np.shape(actor["lstm"]["wh"])[0],
        mlp_hidden=np.shape(actor["mlp"]["l0"]["w"])[1],
        n_mlp_layers=sum(k != "out" for k in actor["mlp"]))
    n_critics = sum(k.startswith("critic") for k in tree)
    device = resolve_device(device)
    params = nets.build_actor_critic(cfg, n_critics, device=device)
    params.load_state_dict(
        {k: torch.from_numpy(np.array(v, np.float32))
         for k, v in _flatten(tree).items()}, strict=True)
    return ddpg.agent_state(params)


class LITune:
    def __init__(self, cfg: LITuneConfig = LITuneConfig(), seed: int = 0,
                 device=None):
        """A tuner on ``device`` (None -> CUDA; raises without CUDA), its
        agent drawn from ``seed``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.state = ddpg.init_state(self.generator, cfg.net_cfg(), cfg.ddpg,
                                     device=self.device)

    def tune(self, data_keys, workload, wr_ratio: float,
             budget_steps: int | None = None, deterministic: bool = False):
        """One tuning request: returns best params found + episode
        summary."""
        env_cfg = self.cfg.env_cfg()
        if budget_steps is not None:
            env_cfg = env_cfg.with_episode_len(budget_steps)
        summary = rollout_episode(
            self.generator, self.state, self.cfg.net_cfg(), env_cfg,
            self.cfg.et_cfg(), data_keys, workload, wr_ratio,
            noise_scale=0.0 if deterministic else 0.05,
            deterministic=deterministic, device=self.device)
        summary["best_params"] = attach_best_params(summary, env_cfg)
        return summary
