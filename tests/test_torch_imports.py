"""The port stands alone: no module of `src/repro_torch` and nothing in
`chip_smoke.py` imports JAX or the JAX package, and its entry points never
drop to the CPU on their own."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import etmdp
from repro_torch.core.litune import LITune, LITuneConfig, params_from_jax
from repro_torch.index import env as E

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_entry_points_raise_without_cuda_and_device(monkeypatch):
    """Given no device, an entry point needs CUDA; it never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.linspace(0, 1, 64, dtype=np.float32)
    workload = {"reads": keys[:8], "inserts": keys[8:16]}
    with pytest.raises(RuntimeError, match="CUDA"):
        LITune(LITuneConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        E.reset(E.EnvConfig(), keys, workload, 1.0)
    cpu_tuner = LITune(LITuneConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        etmdp.rollout_episode(cpu_tuner.generator, cpu_tuner.state,
                              cpu_tuner.cfg.net_cfg(), E.EnvConfig(),
                              etmdp.ETMDPConfig(), keys, workload, 1.0)
    tree = {name: {k: v.detach().numpy() for k, v in mod.state_dict().items()}
            for name, mod in cpu_tuner.state["params"].items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(_nest(tree))


def _nest(flat_per_module):
    out = {}
    for name, flat in flat_per_module.items():
        node = out.setdefault(name, {})
        for key, v in flat.items():
            *parents, leaf = key.split(".")
            d = node
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = v
    return out


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda_or_repo(tmp_path, alone):
    """Without CUDA, or copied away from the repo, the smoke run exits
    non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, cwd=script.parent, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
