"""Training under the specs' layout on torch.distributed gloo ranks, the
counterpart of the reference's test_multidevice_pjit_execution_subprocess
(tests/test_sharding_dryrun.py:55-98: SMOKE mixtral trained for two steps
on a (2, 4) mesh).

Every rank holds its blocks of the parameters (`convert.lm_params_block`)
and trains on its `data` slice of the global batch through the port's
`TrainStep` under `mesh_context`: the loss is the global batch's mean,
the gradients are summed over the batch axes (`train_step.sync_grads`, and
the fsdp gathers' reduce-scatter), the global norm and Adafactor's
statistics reduce over the axes that shard each block.  The reference's
unsharded `make_train_step` runs in this process on the same weights and
batches.

Meshes: (2, 4) SMOKE mixtral (Adafactor, fsdp, expert parallel, 2 kv
heads split at model 4), ShapeSpec("train", 16, 4, "train"), and in the
same world SMOKE qwen2-72b under replicate_misaligned_heads (its 2 kv
heads at model 4: wk / wv whole over `model`, their biases split over it
and gathered for a use every rank makes alike); (2, 2) qwen2-72b
(Adafactor, fsdp, QKV biases); (1, 2) qwen1.5-0.5b (AdamW, tied head,
accumulation over 2 microbatches).  The layers of models/mla.py and
models/ssm.py and the MTP head (`LAID_OUT`): SMOKE deepseek-v3 (MLA + MoE +
MTP, Adafactor, fsdp) in the (2, 2) world, mamba2 (AdamW) in the (1, 2)
world, and in the (2, 4) world jamba, three mamba2 layouts (d_model 48:
in_proj whole, heads replicated, 1.5 heads a rank; d_state 5: the conv
whole too; d_model 18 at expand 3: out_proj whole) and mixtral with 6
experts, TP inside experts (ROADMAP C7), in the single-stage and the
two-stage (moe_dp 2) branch.  Two steps each; after each, the loss and
the grad norm to 1e-5 relative, and every parameter, its blocks gathered
from the ranks into the reference's tree, to 1e-5; in the `LAID_OUT` runs
an AdamW element whose step the eps term dominates (`_eps_bound`) to 1e-5
+ lr a step so dominated.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.configs.shapes import ShapeSpec as JShape
from repro.models import init_params as j_init_params
from repro.train import make_train_step as j_make_train_step
from repro.train import optimizer as j_opt
from repro.train.data import SyntheticDataset as JData
from repro_torch import convert
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.tp import axes_of
from test_torch_train import _flat
from torch_dist_workers import jobs_rank, run_world

TOL = 1e-5
STEPS = 2
# mesh -> (arch, config changes, accumulation)
RUNS = {(2, 4): ("mixtral-8x22b", {"fsdp": True}, 1),
        (2, 2): ("qwen2-72b", {"fsdp": True}, 1),
        (1, 2): ("qwen1.5-0.5b", {}, 2)}
# more runs in a mesh's world: (mesh, name) -> (arch, changes, accum)
RMH = {((2, 4), "qwen2-72b-rmh"): ("qwen2-72b", {"fsdp": True,
                                                 "replicate_misaligned_heads": True}, 1)}
# MLA + MoE + MTP, the Mamba2 mixer (aligned; 1.5 heads a rank; the conv
# whole; out_proj whole), the jamba hybrid, and TP inside experts (6
# experts on 4 model ranks, ROADMAP C7) in both MoE branches
LAID_OUT = {
    ((2, 2), "deepseek-v3"): ("deepseek-v3-671b", {"fsdp": True}, 1),
    ((1, 2), "mamba2"): ("mamba2-130m", {}, 1),
    ((2, 4), "jamba"): ("jamba-1.5-large-398b", {"fsdp": True}, 1),
    ((2, 4), "mamba2 d48"): ("mamba2-130m", {"d_model": 48}, 1),
    ((2, 4), "mamba2 n5"): ("mamba2-130m", {"d_state": 5}, 1),
    ((2, 4), "mamba2 d18"): ("mamba2-130m", {"d_model": 18, "expand": 3, "ssm_head_dim": 9,
                                             "d_state": 5}, 1),
    ((2, 4), "mixtral e6"): ("mixtral-8x22b", {"fsdp": True, "n_experts": 6}, 1),
    ((2, 4), "mixtral e6 two-stage"): ("mixtral-8x22b", {"fsdp": True, "n_experts": 6,
                                                         "moe_dp": 2}, 1),
}
EXTRA = {**RMH, **LAID_OUT}
SHAPE = ("train", 16, 4, "train")
_REF: dict = {}


def _runs(mesh) -> dict:
    """The runs of one mesh's world: name -> (arch, changes, accum)."""
    out = {RUNS[mesh][0]: RUNS[mesh]}
    out.update({name: run for (m, name), run in EXTRA.items() if m == mesh})
    return out


def _reference(mesh, name=None):
    """(port cfg, numpy tree, batches, reference losses, grad norms and
    flat parameters after each step) of a mesh's run (default its first)."""
    name = name or RUNS[mesh][0]
    if (mesh, name) not in _REF:
        arch, changes, accum = _runs(mesh)[name]
        jcfg = dataclasses.replace(J_SMOKE[arch], dtype="float32", **changes)
        params = j_init_params(jax.random.PRNGKey(5), jcfg)
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
        data = JData(jcfg, JShape(*SHAPE), seed=6)
        batches = [data.batch(i) for i in range(STEPS)]
        step = jax.jit(j_make_train_step(jcfg, j_opt.OptConfig(name=jcfg.optimizer),
                                         accum=accum))
        state = j_opt.init_opt(jcfg.optimizer, params)
        losses, norms, flats, eps_bound = [], [], [], []
        for i, b in enumerate(batches):
            params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in b.items()},
                                    i)
            losses.append(float(m.loss))
            norms.append(float(m.grad_norm))
            flats.append(_flat(jax.tree.map(np.asarray, params)))
            eps_bound.append(_eps_bound(jcfg, state, i) if jcfg.optimizer == "adamw" else {})
        _REF[mesh, name] = (ModelConfig(**dataclasses.asdict(jcfg)), tree, batches, losses,
                            norms, flats, eps_bound)
    return _REF[mesh, name]


def _eps_bound(jcfg, state, i: int) -> dict:
    """AdamW's elements whose step lr m / (sqrt(v) + eps) the eps term
    dominates (sqrt(v), bias-corrected, below 10 eps: gradients of 1e-9
    and less): there the step turns float32 noise in the gradient (the
    ranks sum it in another order) into up to lr, so such an element is
    held to TOL + lr, every other to TOL.  Leaf -> mask."""
    opt = j_opt.OptConfig(name="adamw")
    b2c = 1.0 - opt.b2 ** (i + 1)
    v = _flat(jax.tree.map(np.asarray, state["v"]))
    return {leaf: np.sqrt(a / b2c) < 10 * opt.eps for leaf, a in v.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One spawned world a mesh shape, side by side."""
    tmp = tmp_path_factory.mktemp("train_mesh")

    def world(mesh):
        cases = [(name, *_reference(mesh, name)[:3], accum)
                 for name, (_, _, accum) in _runs(mesh).items()]
        ranks = run_world(jobs_rank, mesh, tmp, [("tp_train", cases)], timeout=480)
        return {name: [r["tp_train"][name] for r in ranks] for name in _runs(mesh)}

    for mesh in RUNS:      # the reference's runs first, in this process
        for name in _runs(mesh):
            _reference(mesh, name)
    with concurrent.futures.ThreadPoolExecutor(len(RUNS)) as pool:
        return dict(zip(RUNS, pool.map(world, RUNS)))


def _assemble(ranks, mesh, step: int) -> dict:
    """Every parameter whole, from the ranks' blocks (each placed by its
    spec at the rank's coordinates; replicas must agree)."""
    n_data, n_model = mesh
    shape = {"data": n_data, "model": n_model}
    out = {}
    for name, spec in ranks[0]["specs"].items():
        whole = None
        for r, rec in enumerate(ranks):
            coords = {"data": r // n_model, "model": r % n_model}
            block = rec["params"][step][name]
            if whole is None:
                full = [d * int(np.prod([shape[a] for a in axes_of(e)]))
                        for d, e in zip(block.shape, spec)]
                whole = np.full(full, np.nan, np.float32)
            idx = []
            for d, e in zip(block.shape, spec):
                n, c = 1, 0
                for a in axes_of(e):
                    n, c = n * shape[a], c * shape[a] + coords[a]
                idx.append(slice(c * d, (c + 1) * d))
            prev = whole[tuple(idx)]
            if not np.isnan(prev).all():
                np.testing.assert_array_equal(prev, block, err_msg=f"{name} replicas")
            whole[tuple(idx)] = block
        assert not np.isnan(whole).any(), name
        out[name] = whole
    return out


def _check_steps(worlds, mesh, name):
    cfg, _, _, losses, norms, flats, eps_bound = _reference(mesh, name)
    lr = j_opt.OptConfig(name=cfg.optimizer).lr
    ranks = worlds[mesh][name]
    meta = init_params(cfg, device="meta")
    for i in range(STEPS):
        for r in ranks:
            assert r["losses"][i] == pytest.approx(losses[i], rel=TOL), (mesh, i)
            assert r["grad_norms"][i] == pytest.approx(norms[i], rel=TOL), (mesh, i)
        got = _flat(convert.lm_params_to_numpy(meta, cfg, {
            n: torch.from_numpy(a) for n, a in _assemble(ranks, mesh, i).items()}))
        assert got.keys() == flats[i].keys()
        for leaf, want in flats[i].items():
            # the eps bound holds the laid-out runs only; the others stay at
            # TOL.  An element keeps the lr of each eps-dominated step so far
            steps = np.zeros(want.shape, int)
            if (mesh, name) in LAID_OUT:
                steps = sum(eps_bound[j].get(leaf, steps) for j in range(i + 1))
            loose = steps > 0
            np.testing.assert_allclose(got[leaf][~loose], want[~loose], rtol=TOL, atol=TOL,
                                       err_msg=f"{mesh} {name} step {i}: {leaf}")
            diff = np.abs(got[leaf] - want)[loose]
            assert np.all(diff <= TOL + lr * steps[loose] + TOL * np.abs(want[loose])), (
                f"{mesh} {name} step {i}: {leaf} {diff.max()}")


@pytest.mark.parametrize("mesh", list(RUNS))
def test_two_steps_match_the_unsharded_reference(worlds, mesh):
    _check_steps(worlds, mesh, RUNS[mesh][0])


@pytest.mark.parametrize("mesh, name", list(RMH))
def test_replicated_misaligned_heads_train_like_the_reference(worlds, mesh, name):
    """The opt variant's layout: wk / wv whole over `model`, bk / bv split
    over it.  Every rank adds the whole gathered bias, so its gradient is
    whole on each rank and the gather's backward keeps the rank's block
    (a reduce-scatter would count it once a rank); the first step's
    collectives show that gather and no reduce over `model` of it."""
    _check_steps(worlds, mesh, name)
    cfg = _reference(mesh, name)[0]
    for r in worlds[mesh][name]:
        assert r["specs"]["layers.0.mixer.wk"][1] is None
        assert "model" in axes_of(r["specs"]["layers.0.mixer.bk"][0])
        # bk and bv, a layer each, in the forward and the remat recompute
        assert r["sites"]["all_gather|attn_bias"] == 2 * 2 * cfg.n_layers
        assert not any(k.startswith("reduce_scatter|attn_bias") for k in r["sites"])


@pytest.mark.parametrize("mesh, name", list(LAID_OUT))
def test_mla_mamba_mtp_and_tp_inside_experts_train_like_the_reference(worlds, mesh, name):
    """Two steps of each against the reference's train step: a replicated
    parameter's gradient (q_norm, kv_norm, the MTP norm, a whole a_log)
    whole on every model rank and counted once, or every leaf and the
    grad norm would move.  The first step runs the layers' backward
    collectives; 6 experts on 4 model ranks split each expert's FFN."""
    _check_steps(worlds, mesh, name)
    for r in worlds[mesh][name]:
        sites = r["sites"]
        if name.startswith("mixtral"):
            assert axes_of(r["specs"]["layers.0.ffn.wi"][2]) == ("model",), name
            assert r["specs"]["layers.0.ffn.wi"][0] is None, name
        elif name == "deepseek-v3":
            # the MLA's latent gathers, forward and remat recompute, and
            # the MTP block's; the MTP head's residual gather
            assert sites["all_gather|mla_kv_a"] == 2 * 2 + 1 + 1, name
            assert sites["all_gather|mtp_proj"] == 1, name
            assert sites["all_reduce|mla_in.grad"] > 0, name
        else:
            assert sites.get("all_reduce|ssm_mark.grad", 0) > 0, name


@pytest.mark.parametrize("mesh", list(RUNS))
def test_backward_collectives_and_gradient_sync(worlds, mesh):
    """The first step's collectives: the layers' backward all-reduces over
    `model` (".grad" sites); where fsdp is on, one reduce-scatter of each
    data-sharded weight's gradient a microbatch (the remat recompute
    gathers the body's weights again, so the gathers are more); a
    grad_sync all-reduce for every parameter not sharded over `data`
    (only the data axis carries the batch here)."""
    cfg = _reference(mesh)[0]
    accum = RUNS[mesh][2]
    for r in worlds[mesh][RUNS[mesh][0]]:
        sites = r["sites"]
        assert sites["all_reduce|attn_in.grad"] == accum * cfg.n_layers
        assert sites["all_reduce|logits_in.grad"] == accum
        unsharded = sum(1 for s in r["specs"].values()
                        if "data" not in {a for e in s for a in axes_of(e)})
        assert sites["all_reduce|grad_sync"] == unsharded
        moe = {n for n in r["specs"] if cfg.n_experts and ".ffn." in n
               and ".ffn.shared." not in n}
        sharded = {n for n, s in r["specs"].items()
                   if "data" in {a for e in s for a in axes_of(e)}}
        if cfg.fsdp:
            assert sites["reduce_scatter|fsdp.grad"] == accum * len(sharded - moe)
            assert sites.get("reduce_scatter|moe_weights.grad", 0) == accum * len(
                sharded & moe)
            assert sites["all_gather|fsdp"] >= sites["reduce_scatter|fsdp.grad"]
        else:
            assert not sharded and "reduce_scatter|fsdp.grad" not in sites
