"""Actor / critic networks: LSTM context module + MLP heads as
`nn.Module`s (twin of `repro/core/networks.py`).

The paper's backbone is "DDPG enhanced with LSTM" (§4.2): the LSTM keeps
context from past exploration so the policy can recognize (and avoid)
dangerous regions.  Parameters keep the reference's names and layouts, so
``state_dict`` keys are the reference pytree's paths joined by dots
(``lstm.wi``, ``mlp.l0.w``): weights are ``[d_in, d_out]`` and a head
computes ``x @ w + b``; the LSTM's gates are i, f, g, o with a +1
forget-gate bias.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class NetConfig:
    obs_dim: int
    action_dim: int
    lstm_hidden: int = 128
    mlp_hidden: int = 256
    n_mlp_layers: int = 2


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32,
                                    device=device))


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.w = _param(d_in, d_out, device=device)
        self.b = _param(d_out, device=device)

    def forward(self, x):
        return x @ self.w + self.b


class LSTMCell(nn.Module):
    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        self.wi = _param(d_in, 4 * hidden, device=device)
        self.wh = _param(hidden, 4 * hidden, device=device)
        self.b = _param(4 * hidden, device=device)

    def forward(self, hc, x):
        """x [..., d_in]; hc = (h, c) each [..., hidden]."""
        h, c = hc
        gates = x @ self.wi + h @ self.wh + self.b
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c)


class MLP(nn.Module):
    """``n_mlp_layers`` ReLU layers ``l0, l1, ...`` then the ``out`` head."""

    def __init__(self, cfg: NetConfig, d_in: int, d_out: int, device=None):
        super().__init__()
        self.n_layers = cfg.n_mlp_layers
        d = d_in
        for i in range(cfg.n_mlp_layers):
            setattr(self, f"l{i}", Linear(d, cfg.mlp_hidden, device=device))
            d = cfg.mlp_hidden
        self.out = Linear(d, d_out, device=device)

    def forward(self, x):
        for i in range(self.n_layers):
            x = torch.relu(getattr(self, f"l{i}")(x))
        return self.out(x)


class Actor(nn.Module):
    def __init__(self, cfg: NetConfig, device=None):
        super().__init__()
        self.lstm = LSTMCell(cfg.obs_dim, cfg.lstm_hidden, device=device)
        self.mlp = MLP(cfg, cfg.lstm_hidden + cfg.obs_dim, cfg.action_dim,
                       device=device)

    def forward(self, obs, hidden):
        """obs [..., obs_dim]; hidden (h,c). Returns (action [-1,1],
        hidden')."""
        hc = self.lstm(hidden, obs)
        feat = torch.cat([hc[0], obs], dim=-1)
        return torch.tanh(self.mlp(feat)), hc


class Critic(nn.Module):
    def __init__(self, cfg: NetConfig, device=None):
        super().__init__()
        d_in = cfg.obs_dim + cfg.action_dim
        self.lstm = LSTMCell(d_in, cfg.lstm_hidden, device=device)
        self.mlp = MLP(cfg, cfg.lstm_hidden + d_in, 1, device=device)

    def forward(self, obs, action, hidden):
        """Returns (q [...], hidden')."""
        x = torch.cat([obs, action], dim=-1)
        hc = self.lstm(hidden, x)
        feat = torch.cat([hc[0], x], dim=-1)
        return self.mlp(feat)[..., 0], hc


def zero_hidden(cfg: NetConfig, device=None):
    return (torch.zeros(cfg.lstm_hidden, dtype=torch.float32, device=device),
            torch.zeros(cfg.lstm_hidden, dtype=torch.float32, device=device))


def build_actor_critic(cfg: NetConfig, n_critics: int = 1,
                       device=None) -> nn.ModuleDict:
    """Uninitialized ``{"actor", "critic0", ...}`` modules."""
    mods = {"actor": Actor(cfg, device=device)}
    for i in range(n_critics):
        mods[f"critic{i}"] = Critic(cfg, device=device)
    return nn.ModuleDict(mods)


@torch.no_grad()
def init_actor_critic(generator: torch.Generator, cfg: NetConfig,
                      n_critics: int = 1, device=None) -> nn.ModuleDict:
    """The reference's init: fan-in normal weights (std 1/sqrt(d_in)),
    zero biases, drawn from ``generator`` on its device."""
    params = build_actor_critic(cfg, n_critics, device=device)
    for name, p in params.named_parameters():
        if name.endswith(".b"):
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
                    * (1.0 / math.sqrt(p.shape[0])))
    return params
