"""DDPG with LSTM context (the LITune backbone) + target networks: the
acting half (twin of the parts of `repro/core/ddpg.py` that a tuning
request runs).  The sequence update and its optimizer state belong to
the training slice and are not ported yet.
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from repro_torch.core import networks as nets
from repro_torch.core.networks import NetConfig


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    gamma: float = 0.95
    tau: float = 0.01
    actor_lr: float = 3e-4
    critic_lr: float = 1e-3
    noise_scale: float = 0.15
    seq_len: int = 8
    burn_in: int = 2
    batch_size: int = 64
    use_lstm: bool = True
    # Lagrangian safety head (a second critic for costs)
    use_cost_critic: bool = False
    lambda_lr: float = 1e-2
    cost_limit: float = 1.0


def agent_state(params: torch.nn.ModuleDict) -> dict:
    """Online params plus target copies."""
    return {"params": params, "targets": copy.deepcopy(params)}


def init_state(generator: torch.Generator, net_cfg: NetConfig,
               ddpg_cfg: DDPGConfig, device=None) -> dict:
    n_critics = 2 if ddpg_cfg.use_cost_critic else 1
    return agent_state(nets.init_actor_critic(generator, net_cfg,
                                              n_critics=n_critics,
                                              device=device))


@torch.no_grad()
def act(params, obs, hidden, generator: torch.Generator | None = None,
        noise_scale: float = 0.0, deterministic: bool = False):
    """Policy action (plus clipped Gaussian exploration noise unless
    ``deterministic``) and the actor's advanced hidden state."""
    a, hc = params["actor"](obs, hidden)
    if not deterministic:
        noise = torch.randn(a.shape, generator=generator, device=a.device)
        a = torch.clamp(a + noise_scale * noise, -1.0, 1.0)
    return a, hc
