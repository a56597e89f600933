"""Adafactor on the reference's stacked leaves (ROADMAP C6): whole
`TrainStep`s of the port against `repro.train.make_train_step` at SMOKE
size in float32, on the reference's weights and batches.

The reference stacks each body slot's parameter over the scanned units
into one leaf, factors a stacked vector (n_units, d) into vr (n_units,)
and vc (d,), and clips each leaf's update by its RMS over every unit; the
port's `optimizer.param_groups` gives the same leaves over its unstacked
layers.  Four architectures: qwen2-72b (dense, QKV biases), mixtral (MoE,
the router), jamba (one unit of 8 layers: a stacked leaf of one unit is
factored all the same) and deepseek-v3 (an unstacked prefix layer and
the unstacked `mtp` head beside the body).

After 1 and after 3 steps every parameter leaf lies within 1e-6 + 1e-3 x
the largest |update| of that leaf in the reference (the update: the
reference's new leaf minus its old), and every optimizer state leaf,
mapped onto the reference's tree, within 1e-3 x its largest |value| (the
sums run in other orders: per layer, then over the layers).  Also the
checkpoint round trip of that state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.shapes import ShapeSpec as JShape
from repro.train import make_train_step as j_make_train_step
from repro.train import optimizer as j_opt
from repro.train.data import SyntheticDataset as JData
from repro_torch import convert
from repro_torch.train import OptConfig, checkpoint, make_train_step
from repro_torch.train import optimizer as t_opt
from repro_torch.train.data import to_device
from test_torch_train import _flat, _pair

ARCHS = ["qwen2-72b", "mixtral-8x22b", "jamba-1.5-large-398b", "deepseek-v3-671b"]
STEPS = 3
SEQ, BATCH = 32, 2
REL, ABS = 1e-3, 1e-6
_RUNS: dict = {}


def _ref_path(key: str, n_prefix: int) -> tuple:
    """The reference tree's path of a port state group key."""
    parts = key.split(".")
    if parts[0] == "layers":
        assert int(parts[1]) < n_prefix, key
        return ("prefix", f"layer{parts[1]}", *parts[2:])
    return tuple(parts)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _run(arch):
    """Both packages' parameters (numpy, the reference's tree) and
    Adafactor states after each of STEPS steps, from the same start."""
    if arch in _RUNS:
        return _RUNS[arch]
    jcfg, jparams, tcfg, model = _pair(arch, flash=False)
    assert tcfg.optimizer == "adafactor"
    data = JData(jcfg, JShape("train", SEQ, BATCH, "train"), seed=1)
    jstep = jax.jit(j_make_train_step(jcfg, j_opt.OptConfig(name="adafactor")))
    jstate = j_opt.init_opt("adafactor", jparams)
    params = dict(model.named_parameters())
    groups = t_opt.param_groups(tcfg, params)
    tstate = t_opt.init_opt("adafactor", params, groups)
    tstep = make_train_step(tcfg, OptConfig(name="adafactor"))
    out = {"ref": [_flat(jax.tree.map(np.asarray, jparams))], "port": [],
           "ref_state": [], "port_state": [], "groups": groups, "tcfg": tcfg,
           "losses": []}
    for i in range(STEPS):
        batch = data.batch(i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()}, i)
        model, tstate, tm = tstep(model, tstate, to_device(batch, tcfg, "cpu"), i)
        out["losses"].append((float(jm.loss), float(tm.loss)))
        out["ref"].append(_flat(jax.tree.map(np.asarray, jparams)))
        out["port"].append(_flat(convert.lm_params_to_numpy(model, tcfg)))
        out["ref_state"].append(jax.tree.map(np.asarray, jstate))
        out["port_state"].append({k: {p: t.numpy().copy() for p, t in v.items()}
                                  for k, v in tstate["v"].items()})
    out["model"], out["state"] = model, tstate
    _RUNS[arch] = out
    return out


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_train_step_matches_the_reference(arch, steps):
    run = _run(arch)
    jl, tl = run["losses"][steps - 1]
    assert tl == pytest.approx(jl, rel=1e-5)
    before, want, got = run["ref"][steps - 1], run["ref"][steps], run["port"][steps - 1]
    assert got.keys() == want.keys()
    for name, w in want.items():
        step = float(np.abs(w - before[name]).max())
        err = float(np.abs(got[name] - w).max())
        assert err <= ABS + REL * step, f"{name}: {err} > {ABS} + {REL} x {step}"
    from repro_torch.models.model import unit_spec

    n_prefix = unit_spec(run["tcfg"]).n_prefix
    ref_state, port_state = run["ref_state"][steps - 1], run["port_state"][steps - 1]
    assert int(ref_state["count"]) == steps
    seen = 0
    for key, parts in port_state.items():
        ref = _at(ref_state["v"], _ref_path(key, n_prefix))
        assert set(parts) == set(ref), key
        for part, arr in parts.items():
            r = np.asarray(ref[part])
            assert arr.shape == r.shape, (key, part)
            scale = float(np.abs(r).max())
            assert float(np.abs(arr - r).max()) <= REL * scale + 1e-30, (key, part)
        seen += 1
    assert seen == len(jax.tree.leaves(ref_state["v"], is_leaf=lambda x: isinstance(
        x, dict) and ("vr" in x or "v" in x)))


def test_stacked_vectors_are_factored():
    """A body vector's group holds vr (n_units,) and vc (d,), as the
    reference's (n_units, d) leaf; a prefix layer's vector one v."""
    run = _run("deepseek-v3-671b")
    groups, state = run["groups"], run["state"]["v"]
    n_units = len(groups["body.slot0.norm1"].names)
    assert groups["body.slot0.norm1"].stacked and n_units >= 2
    assert tuple(state["body.slot0.norm1"]["vr"].shape) == (n_units,)
    assert tuple(state["body.slot0.norm1"]["vc"].shape) == (run["tcfg"].d_model,)
    assert set(state["layers.0.norm1"]) == {"v"} and not groups["layers.0.norm1"].stacked
    assert set(state["mtp.norm"]) == {"v"}
    jamba = _run("jamba-1.5-large-398b")
    assert all(len(g.names) == 1 and g.stacked for k, g in jamba["groups"].items()
               if k.startswith("body."))
    assert set(jamba["state"]["v"]["body.slot0.norm1"]) == {"vr", "vc"}


def test_adafactor_state_checkpoint_round_trip(tmp_path):
    run = _run("mixtral-8x22b")
    state = {"params": dict(run["model"].named_parameters()), "opt": run["state"]}
    checkpoint.save(str(tmp_path), STEPS, state)
    back = checkpoint.restore(str(tmp_path), STEPS, state)
    flat, flat_back = checkpoint.flatten(state), checkpoint.flatten(back)
    assert flat.keys() == flat_back.keys()
    assert "opt/v/body.slot0.norm1/vr" in flat
    for k, v in flat.items():
        assert torch.equal(v.detach(), flat_back[k]), k


def test_param_groups_cover_every_parameter_once():
    for arch in ARCHS:
        run = _run(arch)
        names = [n for g in run["groups"].values() for n in g.names]
        assert sorted(names) == sorted(n for n, _ in run["model"].named_parameters())
        cfg = run["tcfg"]
        spec = __import__("repro_torch.models.model", fromlist=["unit_spec"]).unit_spec(cfg)
        for key, g in run["groups"].items():
            assert len(g.names) == (spec.n_units if g.stacked else 1), key


def test_flat_trees_keep_one_group_a_leaf():
    """`flat_groups` of a plain name -> tensor dict makes every parameter
    its own unstacked leaf, as tests/test_torch_train.py's flat trees; a
    model's layer names take `param_groups` (the per-layer leaves C6
    found wrong are refused), and the state needs its groups."""
    params = {"w": torch.ones(3, 2), "b": torch.ones(4)}
    state = t_opt.init_opt("adafactor", params, t_opt.flat_groups(params))
    assert set(state["v"]) == {"w", "b"} and set(state["v"]["b"]) == {"v"}
    with pytest.raises(ValueError, match="param_groups"):
        t_opt.flat_groups({"layers.0.norm1": torch.ones(4)})
    with pytest.raises(TypeError):
        t_opt.init_opt("adafactor", params)
    assert dataclasses.is_dataclass(OptConfig())
