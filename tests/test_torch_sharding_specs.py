"""Port parity of the partition specs (`repro_torch.sharding.specs`) and the
dry-run's input stand-ins (`repro_torch.train.batching.input_specs`)
against `repro.sharding.specs` and `repro.train.batching`.

Every parameter of the ten architectures at full width, built on the meta
device, gets the reference's `PartitionSpec` of the leaf that
`convert.lm_params_from_numpy` maps it to, without the leading unit axis
of a stacked body leaf, at the meshes (16, 16), (2, 16, 16), (1, 4) and
(2, 2), with fsdp and replicate_misaligned_heads off and on; the same for
the optimizer state, batch and cache specs.  Specs are compared exactly.

The Adafactor state is kept on the reference's leaves
(`optimizer.param_groups`, C6 fixed): a body group's state has the
reference's stacked shapes and specs, unit axis included.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models.model import unit_spec as j_unit_spec
from repro.sharding import specs as JS
from repro.train import batching as j_batching
from repro_torch.configs import ARCHS, SHAPES, runnable
from repro_torch.models import init_cache, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import specs as S
from repro_torch.train import batching
from repro_torch.train.optimizer import init_opt, param_groups
from torch_dist_workers import host_mesh  # noqa: F401

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 4}, {"data": 2, "model": 2}]
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
_REF_PARAMS: dict = {}


def _multi(mesh_shape) -> bool:
    return "pod" in mesh_shape


def _ref_params(arch):
    """The reference's parameter shapes (jax.eval_shape), once an arch."""
    if arch not in _REF_PARAMS:
        cfg = J_ARCHS[arch]
        _REF_PARAMS[arch] = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), cfg))
    return _REF_PARAMS[arch]


def _cfgs(arch, fsdp, rmh):
    jcfg = dataclasses.replace(J_ARCHS[arch], fsdp=fsdp, replicate_misaligned_heads=rmh)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _ref_place(name: str, arch: str):
    """(the reference tree's path of the port's parameter / cache layer
    `name`, whether that leaf is stacked over the units)."""
    spec = j_unit_spec(J_ARCHS[arch])
    parts = name.split(".")
    if parts[0] != "layers":
        return tuple(parts), False
    i, rest = int(parts[1]), parts[2:]
    if i < spec.n_prefix:
        return ("prefix", f"layer{i}", *rest), False
    return ("body", f"slot{(i - spec.n_prefix) % len(spec.kinds)}", *rest), True


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _ref_spec(tree, name, arch):
    """The reference's spec of the port's `name`, the unit axis dropped."""
    path, stacked = _ref_place(name, arch)
    spec = tuple(_at(tree, path))
    if stacked:
        assert spec[0] is None, (name, spec)
        return spec[1:]
    return spec


def _n_leaves(tree) -> int:
    return len(jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec)))


@pytest.fixture(scope="module")
def port_params():
    return {arch: dict(init_params(cfg, device="meta").named_parameters())
            for arch, cfg in ARCHS.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_match_reference(port_params, arch):
    params = port_params[arch]
    assert all(p.device.type == "meta" for p in params.values())
    for mesh_shape in MESHES:
        for fsdp, rmh in FLAGS:
            jcfg, cfg = _cfgs(arch, fsdp, rmh)
            want = JS.param_pspecs(jcfg, _ref_params(arch), mesh_shape)
            got = S.param_pspecs(cfg, params, mesh_shape)
            for name, spec in got.items():
                assert spec == _ref_spec(want, name, arch), (name, mesh_shape, fsdp, rmh)
    # every reference leaf is some parameter's (the body's once a unit)
    spec = j_unit_spec(J_ARCHS[arch])
    body = sum(1 for n in params if _ref_place(n, arch)[1])
    assert len(params) - body + body // spec.n_units == _n_leaves(_ref_params(arch))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_opt_specs_match_reference(port_params, arch, opt):
    params = port_params[arch]
    groups = param_groups(ARCHS[arch], params)
    state = init_opt(opt, params, groups)
    for mesh_shape in MESHES:
        jcfg, cfg = _cfgs(arch, True, True)
        jspecs = JS.param_pspecs(jcfg, _ref_params(arch), mesh_shape)
        want = JS.opt_pspecs(opt, _ref_params(arch), jspecs, jcfg, mesh_shape)
        pspecs = S.param_pspecs(cfg, params, mesh_shape)
        got = S.opt_pspecs(opt, pspecs, groups)
        assert tuple(want["count"]) == got["count"] == ()
        if opt == "adamw":
            for part in ("master", "m", "v"):
                for name, spec in got[part].items():
                    assert spec == _ref_spec(want[part], name, arch), (part, name)
            continue
        # Adafactor's state is the reference's leaf for leaf: a body
        # group's, unit axis included
        assert len(got["v"]) == _n_leaves(_ref_params(arch))
        for key, parts in got["v"].items():
            path = _ref_place(groups[key].names[0], arch)[0] if not groups[key].stacked \
                else tuple(key.split("."))
            ref = {k: tuple(v) for k, v in _at(want["v"], path).items()}
            assert set(parts) == set(state["v"][key]) == set(ref), key
            assert parts == ref, key
            for part, spec in parts.items():
                assert len(spec) == state["v"][key][part].dim(), (key, part)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_match_reference(arch):
    """Names, shapes and dtypes of every input, for every shape (the
    decode shapes of an encoder too: they are only skipped later)."""
    for shape in SHAPES.values():
        for kind in (None, "train", "prefill", "decode"):
            want = j_batching.input_specs(J_ARCHS[arch], J_SHAPES[shape.name], kind)
            got = batching.input_specs(ARCHS[arch], shape, kind)
            assert list(got) == list(want)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(want[k].shape), (shape.name, kind, k)
                assert str(v.dtype).removeprefix("torch.") == np.dtype(want[k].dtype).name


@pytest.mark.parametrize("arch", list(ARCHS))
def test_batch_specs_match_reference(arch):
    for shape in SHAPES.values():
        for mesh_shape in MESHES:
            want = JS.batch_pspecs(J_ARCHS[arch], j_batching.input_specs(
                J_ARCHS[arch], J_SHAPES[shape.name]), _multi(mesh_shape), mesh_shape)
            got = S.batch_pspecs(ARCHS[arch], batching.input_specs(ARCHS[arch], shape),
                                 _multi(mesh_shape), mesh_shape)
            assert got == {k: tuple(v) for k, v in want.items()}, (shape.name, mesh_shape)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_specs_match_reference(arch):
    """Every runnable prefill and decode shape's cache, layer by layer."""
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    for shape in SHAPES.values():
        if shape.kind == "train" or not runnable(cfg, shape)[0]:
            continue
        jcache = jax.eval_shape(lambda: j_init_cache(jcfg, shape.global_batch,
                                                     shape.seq_len))
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        for mesh_shape in MESHES:
            want = JS.cache_pspecs(jcfg, jcache, mesh_shape, _multi(mesh_shape))
            got = S.cache_pspecs(cfg, cache, mesh_shape, _multi(mesh_shape))
            for i, layer in enumerate(got):
                path, stacked = _ref_place(f"layers.{i}", arch)
                ref = _at(want, path)
                for name, spec in layer.items():
                    r = tuple(ref[name])
                    assert spec == (r[1:] if stacked else r), (shape.name, i, name)
                    assert tuple(cache[i][name].shape) == tuple(
                        _at(jcache, path)[name].shape)[1 if stacked else 0:]


def test_divisibility_check_drops_axes_that_do_not_divide():
    ms = {"pod": 2, "data": 16, "model": 16}
    assert S.check(("model", ("pod", "data"), ("data",)), (48, 64, 8), ms) == \
        ("model", ("pod", "data"), None)
    assert S.check((("data",), None), (32, 3), ms) == ("data", None)
    mamba = ARCHS["mamba2-130m"]        # 24 SSD heads on a 16-way model axis
    assert S.param_pspec("layers.0.mixer.a_log", (24,), mamba, ms) == (None,)
    assert S.param_pspec("layers.0.mixer.in_proj", (768, 3352), mamba, ms) == (None, None)


def test_placements_on_a_mesh(host_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    assert S.placements(("data", "model"), host_mesh) == [Shard(0), Shard(1)]
    assert S.placements((None, "model"), host_mesh) == [Replicate(), Shard(1)]
    assert S.placements((None, None), host_mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="pod"):
        S.placements((("pod", "data"), None), host_mesh)
    t = torch.arange(12.0).reshape(3, 4)
    dt = distribute_tensor(t, host_mesh, S.placements((None, "model"), host_mesh))
    assert torch.equal(dt.to_local(), t)
