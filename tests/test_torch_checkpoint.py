"""Checkpoints, crash-resume and the straggler monitor of the port
(`repro_torch.train.checkpoint`, `repro_torch.train.fault`): the cases of
the reference's tests/test_checkpoint_fault.py that need no mesh, and the
on-disk layout read by both packages (the port's checkpoint restored by
the reference's `restore`, bf16 leaves included)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as j_checkpoint
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs import ShapeSpec
from repro_torch.train import OptConfig, init_train_state, make_train_step
from repro_torch.train import checkpoint
from repro_torch.train.data import SyntheticDataset, to_device
from repro_torch.train.fault import StragglerMonitor, TrainLoop, reshard


@pytest.fixture()
def small_state():
    cfg = SMOKE_ARCHS["qwen1.5-0.5b"]
    model, opt = init_train_state(cfg, seed=0, device="cpu")
    return cfg, model, {"params": dict(model.named_parameters()), "opt": opt}


def _trees_equal(a, b):
    fa, fb = checkpoint.flatten(a), checkpoint.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k].detach(), fb[k].detach()), k


def test_save_restore_roundtrip(tmp_path, small_state):
    cfg, _, state = small_state
    checkpoint.save(str(tmp_path), 7, state)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    restored = checkpoint.restore(str(tmp_path), 7, state)
    _trees_equal(state, restored)
    # bf16 dtypes survive the uint16 view round trip
    assert restored["params"]["embed"].dtype == torch.bfloat16
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 7
    assert manifest["leaves"]["params/embed"] == {"dtype": "bfloat16",
                                                  "shape": [cfg.vocab, cfg.d_model]}


def test_reference_reads_the_ports_layout(tmp_path):
    """A nested state with bf16, float32 and int32 leaves, saved by the
    port, restored by the reference into a like tree of its own."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    state = {"params": {"w": torch.from_numpy(w).bfloat16(), "b": torch.arange(5.0)},
             "opt": {"count": torch.tensor(3, dtype=torch.int32)}}
    checkpoint.save(str(tmp_path), 2, state)
    like = {"opt": {"count": jnp.zeros((), jnp.int32)},
            "params": {"b": jnp.zeros(5), "w": jnp.zeros((3, 4), jnp.bfloat16)}}
    got = j_checkpoint.restore(str(tmp_path), 2, like)
    np.testing.assert_array_equal(np.asarray(got["params"]["w"], np.float32),
                                  state["params"]["w"].float().numpy())
    assert got["params"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["params"]["b"]), np.arange(5.0))
    assert int(got["opt"]["count"]) == 3


def test_checkpoint_gc_keeps_latest(tmp_path, small_state):
    _, _, state = small_state
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(str(tmp_path), s, state, keep=2)
    assert checkpoint.all_steps(str(tmp_path)) == [4, 5]


def test_atomic_commit_no_tmp_left(tmp_path, small_state):
    _, _, state = small_state
    checkpoint.save(str(tmp_path), 1, state)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    # a save cut short leaves only its tmp directory, which no reader sees
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert checkpoint.all_steps(str(tmp_path)) == [1]
    assert checkpoint.latest_step(str(tmp_path)) == 1


def test_crash_resume_loop(tmp_path):
    """A failure injected mid-run: the loop resumes from the checkpoint and
    ends in the same state as an uninterrupted run."""
    cfg = SMOKE_ARCHS["qwen1.5-0.5b"]
    dataset = SyntheticDataset(cfg, ShapeSpec("train", 16, 2, "train"))

    def run(crash_at, where):
        model, opt = init_train_state(cfg, seed=0, device="cpu")
        step_fn = make_train_step(cfg, OptConfig(lr=1e-3))
        crashed = {"done": False}

        def loop_step(state, batch, step):
            if step == crash_at and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected failure")
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if state["params"][name] is not p:
                        p.copy_(state["params"][name])
            _, o, _ = step_fn(model, state["opt"], to_device(batch, cfg, "cpu"), step)
            return {"params": dict(model.named_parameters()), "opt": o}

        loop = TrainLoop(loop_step, {"params": dict(model.named_parameters()), "opt": opt},
                         str(tmp_path / where), ckpt_every=5)
        return loop.run(10, dataset.batch), loop.restarts, crashed["done"]

    final_a, restarts, crashed = run(7, "a")
    assert crashed and restarts == 1
    final_b, restarts_b, _ = run(-1, "b")
    assert restarts_b == 0
    _trees_equal(final_a, final_b)


def test_restart_budget_is_bounded(tmp_path):
    def always_fails(state, batch, step):
        raise RuntimeError("injected failure")

    loop = TrainLoop(always_fails, {"x": torch.zeros(2)}, str(tmp_path), max_restarts=2)
    with pytest.raises(RuntimeError):
        loop.run(3, lambda s: None)
    assert loop.restarts == 3


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(threshold=2.0)
    for s in range(20):
        mon.record(s, 0.1)
    assert not mon.flagged
    mon.record(20, 0.5)
    assert mon.flagged and mon.flagged[-1][0] == 20


def test_restore_and_reshard_place_leaves_on_a_device(tmp_path, small_state):
    """restore(..., device=) puts every leaf on the device asked for, and
    reshard moves a whole tree (the CPU here; the card in chip runs)."""
    _, _, state = small_state
    checkpoint.save(str(tmp_path), 3, state)
    restored = checkpoint.restore(str(tmp_path), 3, state, device="cpu")
    _trees_equal(state, restored)
    moved = reshard(restored, "cpu")
    assert all(t.device.type == "cpu" for t in checkpoint.flatten(moved).values())
    _trees_equal(state, moved)
