"""The port stands alone: repro_torch imports neither jax nor anything of
the JAX package `repro`, and its entry points run on the CUDA card unless
the caller asks for the CPU (no quiet CPU run when the card is missing)."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield path, ".".join(parts)


def test_importing_every_module_pulls_in_no_jax():
    names = [name for _, name in _modules()]
    code = ("import importlib, sys\n"
            f"for m in {names!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(PKG.parent)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_no_jax_or_repro_import_statement():
    for path, _ in _modules():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), f"{path}: import {m}"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from repro_torch import experiments, resolve_device
    from repro_torch.core import policy
    from repro_torch.core.baselines import ServerOracle
    from repro_torch.core.costs import CostModel, calibrate_fetch_cost
    from repro_torch.core.policy_api import PolicySpec, build_policy
    from repro_torch.index.exact import FlatIndex
    from repro_torch.index.ivf import IVFFlatIndex
    from repro_torch.index.lsh import LSHIndex
    from repro_torch.index.nsw import NSWIndex
    from repro_torch.index.pq import IVFPQIndex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat = np.random.default_rng(0).random((40, 4), np.float32)
    cfg = policy.AcaiConfig(h=4, k=2, c_remote=8, c_local=4)
    for call in (lambda: resolve_device(None),
                 lambda: FlatIndex(cat),
                 lambda: IVFFlatIndex(cat, nlist=4),
                 lambda: IVFPQIndex(cat, nlist=4, m=2),
                 lambda: LSHIndex(cat, tables=2, bits=3),
                 lambda: NSWIndex(cat, degree=4, beam=4),
                 lambda: calibrate_fetch_cost(cat, kth=3),
                 lambda: policy.init_state(40, cfg),
                 lambda: policy.AcaiCache(cat, cfg),
                 lambda: ServerOracle(cat, kmax=4),
                 lambda: build_policy(PolicySpec("acai", {"h": 4}), cat, CostModel(1.0)),
                 lambda: build_policy(PolicySpec("sim_lru", {"h": 4}), cat, CostModel(1.0)),
                 lambda: experiments.main(["--from-bench", "BENCH_experiments.json"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    for call in (lambda: init_params(cfg),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: convert.lm_params_from_numpy({}, cfg),
                 lambda: serve.main(["--smoke", "--requests", "1", "--catalog", "0"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the serving tier follows the device of the model it is given
    model = init_params(cfg, device="cpu")
    assert serve.main(["--smoke", "--requests", "1", "--catalog", "0",
                       "--device", "cpu"])["device"] == "cpu"
    assert model.embed.device.type == "cpu"
