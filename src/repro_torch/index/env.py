"""The learned-index tuning environment (the paper's RL environment), twin
of `repro/index/env.py`.

One step = (decode action -> index params) -> rebuild index on the
reservoir sample -> execute the query workload -> metrics/state/reward.
The env is a pure function of its state dict.

Constraint costs (ET-MDP, §4.2): c_m = 1 on memory-budget violation,
c_r = 1 on runtime-budget violation; the ET-MDP wrapper (core/etmdp.py)
terminates when the cumulative cost exceeds C.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import reward as rw
from repro_torch.core.spaces import ParamSpace, alex_space, carmi_space
from repro_torch.index import alex, carmi
from repro_torch.index import cost as C
from repro_torch.index.features import STATE_DIM, state_vector, workload_stats
from repro_torch.kernels.dispatch import KernelConfig


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    index_type: str = "alex"          # alex | carmi
    episode_len: int = 25
    mem_budget: float = C.MEM_BUDGET_BYTES
    runtime_budget: float = C.RUNTIME_BUDGET_NS
    omega: int = 1
    kappa: int = 2
    # kernel posture (kernels/dispatch.py): the mode of the read probes.
    # The default launches the index-probe kernel on CUDA tensors and runs
    # the plain version on CPU tensors.
    kernel: KernelConfig = KernelConfig()

    @property
    def space(self) -> ParamSpace:
        return alex_space() if self.index_type == "alex" else carmi_space()

    def with_episode_len(self, n: int) -> "EnvConfig":
        """Same environment, different horizon."""
        return dataclasses.replace(self, episode_len=n)


def _backend(index_type: str):
    return alex if index_type == "alex" else carmi


def evaluate_params(cfg: EnvConfig, params_raw: dict, data_keys, workload,
                    wr_ratio):
    """Build + run one workload under `params_raw`.

    Returns (runtime_ns, state_pieces, violations) -- the core experiment
    primitive of the env.
    """
    mod = _backend(cfg.index_type)
    idx = mod.build(data_keys, params_raw)
    if cfg.index_type == "alex":
        read_ns, read_m = mod.run_reads(idx, workload["reads"],
                                        kernel=cfg.kernel)
    else:
        read_ns, read_m = mod.run_reads(idx, workload["reads"], params_raw,
                                        kernel=cfg.kernel)
    idx, ins_ns, ins_m = mod.run_inserts(idx, workload["inserts"],
                                         params_raw)
    n_ops = workload["reads"].shape[0] + workload["inserts"].shape[0]
    runtime = (read_ns + ins_ns) / n_ops  # avg ns per operation (paper metric)
    mem = mod.memory_bytes(idx, params_raw) if cfg.index_type == "alex" \
        else mod.memory_bytes(idx)
    c_m = (mem > cfg.mem_budget).to(torch.float32)
    c_r = ((read_ns + ins_ns) > cfg.runtime_budget).to(torch.float32)
    return runtime, (idx, read_m, ins_m), {"c_m": c_m, "c_r": c_r,
                                           "memory_bytes": mem}


def defaults_raw(cfg: EnvConfig, device) -> dict:
    """The index's expert defaults as float32 0-d tensors."""
    return {k: torch.tensor(float(v), dtype=torch.float32, device=device)
            for k, v in _backend(cfg.index_type).DEFAULTS.items()}


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = np.array(x, np.float32)     # a writable copy torch may share
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def reset(cfg: EnvConfig, data_keys, workload, wr_ratio,
          default_raw: dict | None = None, device=None):
    """Initial env state: evaluate the DEFAULT parameters to set R_0.

    ``data_keys`` and the workload's arrays (tensors or numpy) are moved
    to ``device`` (None -> CUDA; raises without CUDA)."""
    device = resolve_device(device)
    data_keys = _as_f32(data_keys, device)
    workload = {k: _as_f32(workload[k], device) for k in ("reads", "inserts")}
    default_raw = default_raw or defaults_raw(cfg, device)
    r0, (idx, read_m, ins_m), viol = evaluate_params(
        cfg, default_raw, data_keys, workload, wr_ratio)
    ws = workload_stats(data_keys, wr_ratio)
    obs = state_vector(idx, read_m, ins_m, r0, r0, r0, ws)
    env_state = {
        "data_keys": data_keys,
        "reads": workload["reads"],
        "inserts": workload["inserts"],
        "wr_ratio": _as_f32(wr_ratio, device),
        "r0": r0, "r_prev": r0, "r_best": r0,
        "t": torch.zeros((), dtype=torch.int32, device=device),
        "cum_cost": torch.zeros((), dtype=torch.float32, device=device),
    }
    return env_state, obs


def step_core(cfg: EnvConfig, env_state: dict, action: torch.Tensor):
    """One tuning step. action in [-1,1]^dim, on the env state's device."""
    params_raw = cfg.space.decode(action)
    workload = {"reads": env_state["reads"], "inserts": env_state["inserts"]}
    runtime, (idx, read_m, ins_m), viol = evaluate_params(
        cfg, params_raw, env_state["data_keys"], workload,
        env_state["wr_ratio"])
    r = rw.reward(runtime, env_state["r0"], env_state["r_prev"],
                  cfg.omega, cfg.kappa)
    ws = workload_stats(env_state["data_keys"], env_state["wr_ratio"])
    obs = state_vector(idx, read_m, ins_m, runtime, env_state["r_prev"],
                       env_state["r0"], ws)
    cost = viol["c_m"] + viol["c_r"]
    new_state = dict(env_state)
    new_state["r_prev"] = runtime
    new_state["r_best"] = torch.minimum(env_state["r_best"], runtime)
    new_state["t"] = env_state["t"] + 1
    new_state["cum_cost"] = env_state["cum_cost"] + cost
    done = new_state["t"] >= cfg.episode_len
    info = {"runtime_ns": runtime, "cost": cost, **viol}
    return new_state, obs, r, done, info


def obs_dim() -> int:
    return STATE_DIM
