"""Port parity of the expert-parallel MoE (`repro_torch.models.moe` under
`repro_torch.sharding.ctx.mesh_context`) against the reference's
`_moe_shard_map` (`repro.models.moe`), on torch.distributed gloo ranks.

The reference's side runs once for the module in a subprocess with four
forced host devices (`XLA_FLAGS=--xla_force_host_platform_device_count=4`):
SMOKE mixtral, jamba and deepseek-v3 in float32, capacity factor 0
(dropless) and 1.0 (slots drop per data shard and local expert), fsdp off
and on, at the (data, model) meshes (1, 4) and (2, 2), and the unmeshed
single-stage `moe_ffn`; and a 6-expert mixtral layer, whose experts do
not divide a 4-rank `model` axis (TP inside experts: the reference's
two-stage and single-stage branches).  The port's ranks are spawned gloo worlds
(`torch_dist_workers.run_world`), handed the reference's parameters and
inputs as numpy; a one-rank world in this process holds the (1, 1) mesh.

Tolerances: the output to atol = rtol = 1e-5 (the partials' all-reduce
sums in another order), the aux loss to 1e-6; the (1, 1) mesh equal to the
port's single-stage `moe_ffn` bit for bit (top-2: at most two nonzero
partials a token); a forward of the whole SMOKE model to 1e-4 (the LM
parity tests' tolerance, tests/test_torch_lm_archs.py).
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro_torch import convert
from repro_torch.core import distributed as D
from repro_torch.models import moe as TMOE
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.ctx import current, mesh_active, mesh_context
from torch_dist_workers import (host_mesh, jobs_rank, moe_forward_rank,  # noqa: F401
                                moe_from_numpy, run_world)

ARCHS = ["mixtral-8x22b", "jamba-1.5-large-398b", "deepseek-v3-671b"]
MESHES = [(1, 4), (2, 2)]
CFS = [0.0, 1.0]
MOE_DP = 2          # the shard_map branch: 2 divides the 32 tokens
B, S = 4, 8
OUT_TOL, AUX_TOL, FWD_TOL = 1e-5, 1e-6, 1e-4

_CHILD = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import SMOKE_ARCHS
    from repro.models import moe as M
    from repro.sharding.ctx import mesh_context

    archs, meshes, cfs, moe_dp, b, s, path = json.loads(sys.argv[1])
    assert jax.device_count() == 4, jax.devices()
    out = {}
    for i, arch in enumerate(archs):
        base = dataclasses.replace(SMOKE_ARCHS[arch], dtype="float32")
        p = M.init_moe(jax.random.PRNGKey(10 + i), base)
        leaves = {"router": p["router"], "wi": p["wi"], "wg": p["wg"], "wo": p["wo"]}
        for k, v in p.get("shared", {}).items():
            leaves["shared." + k] = v
        for k, v in leaves.items():
            out[f"{arch}|p|{k}"] = np.asarray(v, np.float32)
        x = np.random.default_rng(20 + i).normal(size=(b, s, base.d_model))
        x = jnp.asarray(x.astype(np.float32))
        out[f"{arch}|x"] = np.asarray(x)
        for cf in cfs:
            cfg = dataclasses.replace(base, capacity_factor=cf)
            o, aux = M.moe_ffn(p, x, cfg)
            out[f"{arch}|single|{cf}|out"] = np.asarray(o)
            out[f"{arch}|single|{cf}|aux"] = np.asarray(aux)
            for fsdp in (False, True):
                c = dataclasses.replace(cfg, moe_dp=moe_dp, fsdp=fsdp)
                for shape in meshes:
                    with mesh_context(jax.make_mesh(tuple(shape), ("data", "model")),
                                      ("data",)):
                        o, aux = jax.jit(lambda p, x, c=c: M.moe_ffn(p, x, c))(p, x)
                    key = f"{arch}|ep|{cf}|{fsdp}|{shape[0]}x{shape[1]}"
                    out[key + "|out"] = np.asarray(o)
                    out[key + "|aux"] = np.asarray(aux)
    # 6 experts on a 4-rank model axis: the reference takes its two-stage
    # branch at moe_dp 2 and its single-stage one at moe_dp 0, on the
    # global arrays, the layout only annotating them (its meshed run of
    # these branches does not trace under the installed JAX), so unmeshed
    base = dataclasses.replace(SMOKE_ARCHS[archs[0]], dtype="float32", n_experts=6)
    p = M.init_moe(jax.random.PRNGKey(30), base)
    for k in ("router", "wi", "wg", "wo"):
        out[f"odd|p|{k}"] = np.asarray(p[k], np.float32)
    x = jnp.asarray(out[f"{archs[0]}|x"])
    for cf in cfs:
        for dp in (moe_dp, 0):
            for fsdp in (False, True):
                c = dataclasses.replace(base, capacity_factor=cf, moe_dp=dp, fsdp=fsdp)
                o, aux = jax.jit(lambda p, x, c=c: M.moe_ffn(p, x, c))(p, x)
                out[f"odd|{cf}|{dp}|{fsdp}|out"] = np.asarray(o)
                out[f"odd|{cf}|{dp}|{fsdp}|aux"] = np.asarray(aux)
    np.savez(path, **out)
""")


def _port_cfg(jcfg, **kw) -> ModelConfig:
    return ModelConfig(**{**dataclasses.asdict(jcfg), **kw})


def _start_reference(path):
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    arg = json.dumps([ARCHS, MESHES, CFS, MOE_DP, B, S, str(path)])
    return subprocess.Popen([sys.executable, "-c", _CHILD, arg], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's parameters, inputs and outputs (numpy), from one
    subprocess on four forced host devices; the (1, 2) world's forwards
    run meanwhile (they need none of it)."""
    tmp = tmp_path_factory.mktemp("moe_ref")
    proc = _start_reference(tmp / "ref.npz")
    try:
        fwd = run_world(moe_forward_rank, (1, 2), tmp, forward_cases())
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with np.load(tmp / "ref.npz") as f:
        out = dict(f)
    out["forward (1, 2)"] = fwd
    return out


def _leaves(ref, arch) -> dict:
    pre = f"{arch}|p|"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _cfg(arch, cf, fsdp, moe_dp=MOE_DP) -> ModelConfig:
    return _port_cfg(dataclasses.replace(J_SMOKE[arch], dtype="float32"),
                     capacity_factor=cf, fsdp=fsdp, moe_dp=moe_dp)


def _whole(ranks, name, shape):
    """The whole output from the ranks' data shards (model rank 0 of each
    data row); every model rank of a row holds the same sum."""
    n_data, n_model = shape
    rows = []
    for r in range(n_data):
        row = [ranks[r * n_model + m][name]["out"] for m in range(n_model)]
        for other in row[1:]:
            np.testing.assert_array_equal(other, row[0])
        rows.append(row[0])
    return np.concatenate(rows, axis=0)


# experts that do not divide the (1, 4) mesh's model axis: TP inside each
# expert (the reference's two-stage branch at moe_dp 2, single-stage at 0)
ODD = _port_cfg(dataclasses.replace(J_SMOKE["mixtral-8x22b"], dtype="float32",
                                    n_experts=6), moe_dp=MOE_DP)


def _odd_cases(ref):
    return [(f"odd|{cf}|{dp}|{fsdp}",
             dataclasses.replace(ODD, capacity_factor=cf, moe_dp=dp, fsdp=fsdp),
             _leaves(ref, "odd"), ref[f"{ARCHS[0]}|x"])
            for cf in CFS for dp in (MOE_DP, 0) for fsdp in (False, True)]


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """Each mesh's ranks run every case once: the shard_map branch (moe_dp
    2) and the single-stage branch (moe_dp 0) for every arch, capacity
    factor and fsdp; at (1, 4) the layer with 6 experts (TP inside
    experts, both branches, fsdp off and on); at (2, 2) the
    SMOKE forwards of mixtral and jamba (the (1, 2) ones ran beside the
    reference).  The two worlds run side by side."""
    tmp = tmp_path_factory.mktemp("moe_worlds")

    def world(shape):
        cases = [(f"{arch}|{branch}|{cf}|{fsdp}", _cfg(arch, cf, fsdp, dp),
                  _leaves(ref, arch), ref[f"{arch}|x"])
                 for arch in ARCHS for cf in CFS for fsdp in (False, True)
                 for branch, dp in (("ep", MOE_DP), ("single", 0))]
        if shape == (1, 4):
            cases += _odd_cases(ref)
        jobs = [("moe_ep", cases)]
        if shape == (2, 2):
            jobs.append(("moe_forward", forward_cases()))
        return [{k: v for res in r.values() for k, v in res.items()}
                for r in run_world(jobs_rank, shape, tmp, jobs)]

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        out = dict(zip(MESHES, pool.map(world, MESHES)))
    out[(1, 2)] = ref["forward (1, 2)"]
    return out


# --------------------------------------------------------------------------
# the context
# --------------------------------------------------------------------------

def test_mesh_context_nests_and_restores(host_mesh):
    assert not mesh_active() and current() is None
    with mesh_context(host_mesh, "data"):
        assert current().batch_axes == ("data",)
        with mesh_context(host_mesh, ("data", "model")):
            assert current().batch_axes == ("data", "model")
        assert current().batch_axes == ("data",)
    assert not mesh_active()
    with pytest.raises(ValueError, match="pod"):
        with mesh_context(host_mesh, ("pod", "data")):
            pass
    assert not mesh_active()


# --------------------------------------------------------------------------
# (1, 1): bit for bit against the single-stage moe_ffn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_equals_single_stage_bit_for_bit(host_mesh, ref, arch, dtype):
    """Both branches on a (1, 1) mesh (moe_dp 2: shard_map; moe_dp 0:
    single-stage), fsdp off and on, with and without drops: output and aux
    equal the unmeshed single-stage moe_ffn's bit for bit; collectives:
    the fsdp gathers, the aux and the combine all-reduces."""
    x = torch.from_numpy(ref[f"{arch}|x"])
    for cf in CFS:
        for fsdp in (False, True):
            base = dataclasses.replace(_cfg(arch, cf, fsdp, 0), dtype=dtype)
            layer = moe_from_numpy(_leaves(ref, arch), base)
            xs = x.to(layer.wi.dtype)
            want, want_aux = TMOE.moe_ffn(layer, xs, base)
            convert.moe_block(layer, base, host_mesh)   # the (1, 1) cut: whole, specs
            for dp in (MOE_DP, 0):
                cfg = dataclasses.replace(base, moe_dp=dp)
                D.reset_collectives()
                with mesh_context(host_mesh, ("data",)):
                    got, got_aux = TMOE.moe_ffn(layer, xs, cfg)
                assert torch.equal(got, want), (cf, fsdp, dp)
                assert torch.equal(got_aux, want_aux), (cf, fsdp, dp)
                assert dict(D.COLLECTIVES) == ({"all_gather": 4, "all_reduce": 2} if fsdp
                                               else {"all_reduce": 2})


# --------------------------------------------------------------------------
# (1, 4) and (2, 2) against the reference's _moe_shard_map
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_shard_map_branch_matches_reference(ref, worlds, arch, shape):
    for cf in CFS:
        for fsdp in (False, True):
            name = f"{arch}|ep|{cf}|{fsdp}"
            key = f"{arch}|ep|{cf}|{fsdp}|{shape[0]}x{shape[1]}"
            got = _whole(worlds[shape], name, shape).reshape(B, S, -1)
            np.testing.assert_allclose(got, ref[key + "|out"], rtol=OUT_TOL, atol=OUT_TOL,
                                       err_msg=name)
            for r in worlds[shape]:
                np.testing.assert_allclose(r[name]["aux"], ref[key + "|aux"],
                                           rtol=AUX_TOL, atol=AUX_TOL, err_msg=name)


def test_drops_are_per_data_shard(ref):
    """The reference's own semantics the port reproduces: with slots
    dropping, the (2, 2) shard_map differs from the single-stage layer
    (capacity per data shard) while the (1, 4) one equals it."""
    arch = ARCHS[0]
    single = ref[f"{arch}|single|1.0|out"]
    np.testing.assert_allclose(ref[f"{arch}|ep|1.0|False|1x4|out"], single, rtol=OUT_TOL,
                               atol=OUT_TOL)
    assert np.abs(ref[f"{arch}|ep|1.0|False|2x2|out"] - single).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_single_stage_branch_matches_unmeshed_reference(ref, worlds, arch, shape):
    """moe_dp 0 under the mesh: the single-stage capacity and positions
    over the global token order, so the reference's unmeshed moe_ffn (at
    capacity factor 1.0 slots drop)."""
    for cf in CFS:
        for fsdp in (False, True):
            name = f"{arch}|single|{cf}|{fsdp}"
            got = _whole(worlds[shape], name, shape).reshape(B, S, -1)
            np.testing.assert_allclose(got, ref[f"{arch}|single|{cf}|out"], rtol=OUT_TOL,
                                       atol=OUT_TOL, err_msg=name)
            for r in worlds[shape]:
                np.testing.assert_allclose(r[name]["aux"], ref[f"{arch}|single|{cf}|aux"],
                                           rtol=AUX_TOL, atol=AUX_TOL, err_msg=name)


@pytest.mark.parametrize("shape", MESHES)
def test_collective_counts_of_each_branch(worlds, shape):
    """shard_map: 4 fsdp gathers (fsdp on), the combine and the aux
    all-reduces; single-stage: the same, plus one gather of the expert ids
    where the data axis has more than one rank."""
    ids = 1 if shape[0] > 1 else 0
    for r in worlds[shape]:
        for arch in ARCHS:
            for cf in CFS:
                for fsdp in (False, True):
                    g = 4 if fsdp else 0
                    ep = r[f"{arch}|ep|{cf}|{fsdp}"]["counts"]
                    single = r[f"{arch}|single|{cf}|{fsdp}"]["counts"]
                    assert ep == ({"all_gather": g, "all_reduce": 2} if g
                                  else {"all_reduce": 2})
                    assert single == ({"all_gather": g + ids, "all_reduce": 2} if g + ids
                                      else {"all_reduce": 2})


def test_experts_that_do_not_divide_the_model_axis_run_tp_inside_experts(ref, worlds):
    """6 experts on a 4-rank `model` axis run the reference's TP inside
    experts (every expert on every rank, the
    rank's block of the expert FFN dim, the partials summed over `model`),
    in the two-stage branch (moe_dp 2) and the single-stage one (moe_dp
    0), and match the reference's moe_ffn of those branches; collectives: the fsdp
    gathers, the aux and the combine all-reduces."""
    for name, cfg, _, _ in _odd_cases(ref):
        got = _whole(worlds[(1, 4)], name, (1, 4)).reshape(B, S, -1)
        np.testing.assert_allclose(got, ref[name + "|out"], rtol=OUT_TOL, atol=OUT_TOL,
                                   err_msg=name)
        for r in worlds[(1, 4)]:
            np.testing.assert_allclose(r[name]["aux"], ref[name + "|aux"], rtol=AUX_TOL,
                                       atol=AUX_TOL, err_msg=name)
            assert r[name]["counts"] == ({"all_gather": 4, "all_reduce": 2} if cfg.fsdp
                                         else {"all_reduce": 2}), name
        assert r[name]["wi_shape"] == [6, cfg.d_model, cfg.moe_d_ff // 4], name


# --------------------------------------------------------------------------
# a whole forward under the mesh
# --------------------------------------------------------------------------

FWD_ARCHS = ["mixtral-8x22b", "jamba-1.5-large-398b"]
FWD_B, FWD_S = 2, 16


def _fwd_pair(arch, b=FWD_B):
    """(reference float32 SMOKE config, numpy tree, tokens), dropless."""
    jcfg = dataclasses.replace(J_SMOKE[arch], dtype="float32")
    params = j_init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (b, FWD_S)).astype(np.int32)
    return jcfg, tree, toks


def forward_cases(b=FWD_B, archs=FWD_ARCHS):
    out = []
    for arch in archs:
        jcfg, tree, toks = _fwd_pair(arch, b)
        for fsdp in (False, True):
            out.append((f"{arch}|{fsdp}", _port_cfg(jcfg, moe_dp=MOE_DP, fsdp=fsdp), tree,
                        toks))
    return out


@pytest.mark.parametrize("arch", FWD_ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_forward_under_mesh_matches_unmeshed_reference(worlds, arch, shape):
    """The whole model laid out by the specs (`convert.lm_params_block`).
    Dropless, so the shard_map branch's output is the single-stage
    layer's; the aux loss too where the data axis has one rank (with two,
    the branch averages the shards' Switch losses, as the reference's).
    jamba's Mamba2 layers run laid out over `model` too."""
    jcfg, tree, toks = _fwd_pair(arch)
    want = j_forward(jax.tree.map(np.asarray, tree), jcfg, tokens=toks)
    ranks = worlds[shape]
    n_data, n_model = shape
    for fsdp in (False, True):
        name = f"{arch}|{fsdp}"
        got = np.concatenate([ranks[r * n_model][name]["logits"] for r in range(n_data)])
        np.testing.assert_allclose(got, np.asarray(want.logits), rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=name)
        if n_data == 1:
            for r in ranks:
                np.testing.assert_allclose(r[name]["aux"], float(want.aux_loss),
                                           rtol=FWD_TOL, atol=FWD_TOL, err_msg=name)


POD_ARCHS = ["mixtral-8x22b", "jamba-1.5-large-398b", "deepseek-v3-671b"]


@pytest.fixture(scope="module")
def pod_world(tmp_path_factory):
    """The SMOKE forwards on a (pod 2, data 2, model 2) world, the batch of 4
    over ("pod", "data")."""
    return run_world(moe_forward_rank, (2, 2, 2), tmp_path_factory.mktemp("moe_pod"),
                     forward_cases(4, POD_ARCHS))


@pytest.mark.parametrize("arch", POD_ARCHS)
def test_forward_with_the_batch_over_two_axes_matches_unmeshed_reference(pod_world, arch):
    """The batch over ("pod", "data"), as the multi-pod production mesh lays
    it (ROADMAP C10: the expert-parallel MoE once raised NotImplementedError
    for two batch axes of more than one rank): the whole model laid out
    on (2, 2, 2), every rank's slice of the logits against the reference's
    unmeshed forward (the ids and the aux sums gathered and reduced over
    both axes, in row-major order)."""
    jcfg, tree, toks = _fwd_pair(arch, 4)
    want = j_forward(jax.tree.map(np.asarray, tree), jcfg, tokens=toks)
    for fsdp in (False, True):
        name = f"{arch}|{fsdp}"
        got = np.concatenate([pod_world[r * 2][name]["logits"] for r in range(4)])
        np.testing.assert_allclose(got, np.asarray(want.logits), rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=name)


# --------------------------------------------------------------------------
# ROADMAP C15: a rank's expert buffer holds its own slots' rows only
# --------------------------------------------------------------------------

ROW_MESHES = [(2, 2), (2, 1), (4, 1), (2, 2, 2)]
# 6 experts: expert parallel at model 2 (3 a rank), all on a rank at model 1;
# 3 experts: TP inside experts at model 2 (C7's layout), whole at model 1
ROW_EXPERTS = (6, 3)
_ROW_REF: dict = {}


def _row_cfg(n_e, cf, dp) -> ModelConfig:
    return _port_cfg(dataclasses.replace(J_SMOKE[ARCHS[0]], dtype="float32",
                                         n_experts=n_e, capacity_factor=cf, moe_dp=dp))


def _row_setup():
    """Each row case's reference: the layer's leaves and the reference's
    unmeshed moe_ffn (single-stage at moe_dp 0, two-stage at 2) on the
    module's (4, 8, d) x, in this process."""
    if not _ROW_REF:
        from repro.models import moe as JM

        x = np.random.default_rng(41).normal(size=(B, S, J_SMOKE[ARCHS[0]].d_model))
        x = x.astype(np.float32)
        for n_e in ROW_EXPERTS:
            base = dataclasses.replace(J_SMOKE[ARCHS[0]], dtype="float32", n_experts=n_e)
            p = JM.init_moe(jax.random.PRNGKey(40 + n_e), base)
            leaves = {k: np.asarray(p[k], np.float32) for k in ("router", "wi", "wg", "wo")}
            for cf in CFS:
                for dp in (0, MOE_DP):
                    c = dataclasses.replace(base, capacity_factor=cf, moe_dp=dp)
                    out, _ = JM.moe_ffn(p, jax.numpy.asarray(x), c)
                    _ROW_REF[(n_e, cf, dp)] = (leaves, np.asarray(out))
        _ROW_REF["x"] = x
    return _ROW_REF


def _row_cases(shape):
    """The cases `moe_share` takes on `shape`: moe_dp 0 always, moe_dp 2 where
    the experts do not divide `model` (with expert parallelism moe_dp 2 is
    the shard_map branch)."""
    ref = _row_setup()
    m = shape[-1]
    return [(f"e{n_e}|{cf}|{dp}", _row_cfg(n_e, cf, dp), ref[(n_e, cf, dp)][0], ref["x"])
            for n_e in ROW_EXPERTS for cf in CFS for dp in (0, MOE_DP)
            if dp == 0 or n_e % m]


@pytest.fixture(scope="module")
def row_worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_rows")

    def world(shape):
        return [r["moe_rows"] for r in
                run_world(jobs_rank, shape, tmp, [("moe_rows", _row_cases(shape))])]

    with concurrent.futures.ThreadPoolExecutor(len(ROW_MESHES)) as pool:
        return dict(zip(ROW_MESHES, pool.map(world, ROW_MESHES)))


def rows_by_hand(t: int, n_batch: int, moe_dp: int, cap) -> int:
    """A rank's buffer rows an expert: the rank's tl = t / n_batch tokens
    against the block of bs = t / blocks tokens (blocks = moe_dp where it
    divides t, else 1): one whole block -> its cap(bs) rows, part of one
    -> min(tl, cap(bs)) (a token adds at most one slot to an expert), k
    whole blocks -> k cap(bs).  Before C15's fix every rank ran blocks x
    cap(bs)."""
    tl = t // n_batch
    bs = t // (moe_dp if moe_dp > 1 and t % moe_dp == 0 else 1)
    if tl < bs:
        return min(tl, cap(bs))
    return tl // bs * cap(bs)


@pytest.mark.parametrize("shape", ROW_MESHES)
def test_rank_buffers_hold_their_own_rows(row_worlds, shape):
    """C15: on every rank one expert buffer of (E_rank, rows, d), rows by
    `rows_by_hand` (E_rank = E / model with expert parallelism, E under TP
    inside experts), the same slots kept as the reference: the ranks'
    outputs within 1e-5 of the reference's unmeshed moe_ffn."""
    ref = _row_setup()
    n_batch, m = int(np.prod(shape[:-1])), shape[-1]
    b = B // n_batch
    t = B * S
    for name, cfg, _, _ in _row_cases(shape):
        n_e = cfg.n_experts
        e_rank = n_e // m if n_e % m == 0 else n_e
        rows = rows_by_hand(t, n_batch, cfg.moe_dp, lambda n: TMOE.capacity(n, cfg))
        want = ref[(n_e, cfg.capacity_factor, cfg.moe_dp)][1]
        for r in row_worlds[shape]:
            got = r[name]
            assert got["buffers"] == [[e_rank, rows, cfg.d_model]], (name, got["buffers"])
            np.testing.assert_allclose(got["out"], want[got["me"] * b:(got["me"] + 1) * b],
                                       rtol=OUT_TOL, atol=OUT_TOL, err_msg=name)


def test_rows_by_hand_against_the_old_global_buffer():
    """The hand formula at the production cells (mixtral-8x22b train_4k, a
    rank's 65536 tokens a microbatch on one pod, 32768 across pods, capacity
    factor 1.25, 8 experts, top-2): the opt variant's one block a rank
    keeps cap(65536) = 20480 / cap(32768) = 10240 rows of the 327680 every
    rank ran before; the baseline's one global block min(tl, cap(t))."""
    cfg = dataclasses.replace(_row_cfg(8, 1.25, 0), experts_per_token=2)

    def cap(n):
        return TMOE.capacity(n, cfg)

    assert rows_by_hand(16 * 65536, 16, 16, cap) == 20480
    assert rows_by_hand(32 * 32768, 32, 32, cap) == 10240
    assert 16 * cap(65536) == cap(16 * 65536) == 327680
    assert rows_by_hand(16 * 65536, 16, 0, cap) == 65536
    assert rows_by_hand(32 * 32768, 32, 0, cap) == 32768
