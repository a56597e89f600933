"""MLA, the Mamba2 mixer and jamba's hybrid under the specs' layout on
torch.distributed gloo ranks, against the reference's unsharded `forward`
/ `generate` (the serving half of tests/test_torch_tp.py, for the layers
`models/mla.py` and `models/ssm.py` lay out over `model`).

A rank holds the block of every parameter that `param_pspecs` gives it
(`convert.lm_params_block`), its cache blocks (`init_cache` under the
mesh: the whole MLA latent, its conv channels and ssm heads) and its
`data` slice of the batch.  Worlds (data, model): (1, 2), (1, 4), (2, 2)
and (2, 1), one spawned gloo world a mesh shape with every case inside
it, and (1, 1) in this process.

Cases at SMOKE size in float32, fsdp where the published configuration
has it: deepseek-v3 (MLA + MoE; the materialized and the absorbed decode),
mamba2, jamba (Mamba2, attention and MoE), and three mamba2 layouts the
aligned one does not reach: d_model 48 (6 heads: at model 4 in_proj is
whole, the heads replicate and out_proj's rows split heads, 1.5 a rank,
as mamba2-130m's at model 16), d_state 5 (at model 4 the conv's channels
do not split either) and d_model 18 with expand 3 (at model 4 out_proj is
whole: every rank computes every head from gathered blocks).

Tolerances: the prefill logits to 1e-5, 5 greedy tokens equal; at (1, 1)
logits and tokens equal to the unmeshed port's bit for bit.  Collectives
pinned by site; the heads each rank's attention and SSD scan ran over.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import distributed as D
from repro_torch.models import forward, init_params
from repro_torch.serve.engine import generate
from repro_torch.sharding.ctx import mesh_context
from test_torch_tp import MESHES, STEPS, TOL, F, _cases, _setup, _whole
from torch_dist_workers import host_mesh, jobs_rank, run_world  # noqa: F401

# name -> (arch, config changes, generate?)
CASES = {
    "deepseek-v3": ("deepseek-v3-671b", F, True),
    "deepseek-v3 absorbed": ("deepseek-v3-671b", {**F, "mla_absorbed_decode": True}, True),
    "mamba2": ("mamba2-130m", {}, True),
    "mamba2 d48": ("mamba2-130m", {"d_model": 48}, True),
    "mamba2 n5": ("mamba2-130m", {"d_state": 5}, True),
    "mamba2 d18": ("mamba2-130m", {"d_model": 18, "expand": 3, "ssm_head_dim": 9,
                                   "d_state": 5}, True),
    "jamba": ("jamba-1.5-large-398b", F, True),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each mesh's ranks serve every case (greedy decoding only)."""
    tmp = tmp_path_factory.mktemp("tp_a12c_worlds")
    cases = [case + (False,) for case in _cases(CASES, CASES)]

    def world(shape):
        return [r["tp_serve"] for r in
                run_world(jobs_rank, shape, tmp, [("tp_serve", cases)], timeout=240)]

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        return dict(zip(MESHES, pool.map(world, MESHES)))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", MESHES)
def test_prefill_logits_and_greedy_tokens_match_reference(worlds, shape, name):
    arch, changes, gen = CASES[name]
    _, _, _, want, toks = _setup(name, arch, changes, gen)
    ranks = worlds[shape]
    np.testing.assert_allclose(_whole(ranks, shape, name, "logits"), want, rtol=TOL,
                               atol=TOL, err_msg=name)
    np.testing.assert_array_equal(_whole(ranks, shape, name, "tokens"), toks)


def _ssm_sites(layers: int, n_model: int, in_split: bool, conv_split: bool,
               rows_split: bool) -> dict:
    """A forward's Mamba2 collectives by site: in_proj's and the conv's
    gathers where their blocks split, the norm's sum of squares and the
    partial where out_proj's rows do (every split dim counts over a
    one-rank axis too)."""
    sites = {}
    if in_split:
        sites["all_gather|ssm_in"] = layers
    if conv_split:
        sites["all_gather|ssm_conv"] = layers
    if rows_split:
        sites["all_reduce|ssm_norm"] = layers
        sites["all_reduce|ssm_out"] = layers
    return sites


def _own(sites: dict, prefix: str) -> dict:
    return {k: v for k, v in sites.items() if k.split("|")[1].startswith(prefix)}


@pytest.mark.parametrize("shape", MESHES)
def test_collectives_by_site(worlds, shape):
    """The prefill's MLA and Mamba2 collectives, and the same pattern a
    decode step; none of a backward's in serving."""
    n_model = shape[1]
    for r in worlds[shape]:
        for name in ("deepseek-v3", "deepseek-v3 absorbed"):
            # 3 MLA layers: both latents gathered, the partial reduced;
            # 4 heads divide 1, 2, 4: no head gather
            want = {"all_gather|mla_q_a": 3, "all_gather|mla_kv_a": 3, "all_reduce|mla_out": 3}
            assert _own(r[name]["sites"], "mla_") == want, name
            gen = _own(r[name]["gen_sites"], "mla_")
            assert gen == {k: v * STEPS for k, v in want.items()}, name
            # fsdp: wq_a, wq_b, wkv_a, wk_b, wv_b and wo a layer
            assert r[name]["sites"]["all_gather|fsdp"] >= 6 * 3, name
        split = {"mamba2": (True, True, True),
                 "mamba2 d48": (n_model != 4, True, True),
                 "mamba2 n5": (n_model != 4, n_model != 4, True),
                 "mamba2 d18": (True, True, n_model != 4),
                 "jamba": (True, True, True)}
        for name, (in_s, conv_s, rows_s) in split.items():
            layers = 7 if name == "jamba" else 2
            want = _ssm_sites(layers, n_model, in_s, conv_s, rows_s)
            assert _own(r[name]["sites"], "ssm_") == want, name
            assert _own(r[name]["gen_sites"], "ssm_") == {k: v * STEPS
                                                         for k, v in want.items()}, name
        for name in CASES:
            assert not any(k.endswith(".grad") for k in r[name]["gen_sites"]), name


@pytest.mark.parametrize("shape", MESHES)
def test_each_rank_holds_its_blocks_and_runs_its_heads(worlds, shape):
    """The rank's blocks and cache are what the specs give it; its SSD scans
    and MLA attention run over the heads its rows of out_proj / wo cover,
    never all of them when those rows split."""
    n_model = shape[1]
    for r in worlds[shape]:
        ds = r["deepseek-v3"]
        assert ds["heads"]["attention"] == [4 // n_model] * 3
        assert ds["cache"] == {"ckv": [1, 8, 16], "krope": [1, 8, 8]}   # whole latent
        assert ds["blocks"]["layers.0.mixer.wq_a"] == [64 // shape[0], 32 // n_model]
        assert ds["blocks"]["layers.0.mixer.q_norm"] == [32]
        mb = r["mamba2"]
        assert mb["heads"]["ssd"] == [8 // n_model] * 2
        assert mb["cache"] == {"conv": [1, 3, 160 // n_model], "ssm": [1, 8 // n_model, 16, 16]}
        assert mb["blocks"]["layers.0.mixer.in_proj"] == [64, 296 // n_model]
        # 6 heads, 96 rows: at model 4, 24 rows (1.5 heads) a rank -> 2 heads
        d48 = r["mamba2 d48"]
        assert d48["heads"]["ssd"] == [{1: 6, 2: 3, 4: 2}[n_model]] * 2
        assert d48["cache"]["ssm"][1] == (6 if n_model == 4 else 6 // n_model)
        assert d48["cache"]["conv"][2] == 128 // n_model
        assert d48["blocks"]["layers.0.mixer.in_proj"][1] == (230 if n_model == 4
                                                              else 230 // n_model)
        assert d48["blocks"]["layers.0.mixer.a_log"] == [6 if n_model == 4 else 6 // n_model]
        # out_proj whole at model 4: every rank computes all 6 heads
        assert r["mamba2 d18"]["heads"]["ssd"] == [6 if n_model == 4 else 6 // n_model] * 2
        jb = r["jamba"]
        assert jb["heads"]["ssd"] == [8 // n_model] * 7
        assert jb["heads"]["attention"] == [4 // n_model]


def test_one_rank_mesh_is_bit_for_bit_the_unmeshed_port(host_mesh):
    """(1, 1): every case's logits and tokens equal the unmeshed port's bit
    for bit (the same arithmetic; collectives over one rank), and its
    collectives follow the pattern of an aligned mesh (every split dim
    counts)."""
    for name in CASES:
        arch, changes, gen = CASES[name]
        cfg, tree, inputs, _, _ = _setup(name, arch, changes, gen)
        kw = {k: torch.from_numpy(v) for k, v in inputs.items()}
        model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
        want = forward(model, cfg, **kw)
        want_toks = generate(model, cfg, kw["tokens"], STEPS)
        convert.shard_module(model, cfg, host_mesh)
        D.reset_collectives()
        with mesh_context(host_mesh, ("data",)):
            got = forward(model, cfg, **kw)
            sites = {f"{p}|{s}": n for (p, s), n in D.COLLECTIVE_SITES.items()}
            got_toks = generate(model, cfg, kw["tokens"], STEPS)
        assert torch.equal(got.logits, want.logits), name
        assert torch.equal(got.aux_loss, want.aux_loss), name
        assert torch.equal(got_toks, want_toks), name
        if name.startswith("deepseek"):
            assert _own(sites, "mla_") == {"all_gather|mla_q_a": 3, "all_gather|mla_kv_a": 3,
                                           "all_reduce|mla_out": 3}, name
        else:
            layers = 7 if name == "jamba" else 2
            assert _own(sites, "ssm_") == _ssm_sites(layers, 1, True, True, True), name


def test_remat_recomputation_on_another_thread_runs_the_layout(host_mesh):
    """Autograd runs a CUDA backward on a device thread of its own, where the
    thread-local mesh context is not open: a checkpointed unit's
    recomputation reopens its forward's context there.  Here the backward
    runs on a second thread (SMOKE deepseek-v3 and jamba, float32, remat on,
    the (1, 1) mesh): the recomputation runs the laid-out MLA / Mamba2 (its
    collectives count again) and the gradients equal those of a backward on
    the forward's thread bit for bit."""
    import dataclasses
    import threading

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.train.data import SyntheticDataset, to_device
    from repro_torch.train.train_step import loss_fn

    for arch, site in (("deepseek-v3-671b", "mla_kv_a"), ("jamba-1.5-large-398b", "ssm_in")):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        assert cfg.remat
        batch = to_device(SyntheticDataset(cfg, ShapeSpec("train", 32, 2, "train")).batch(0),
                          cfg, "cpu")
        model = convert.shard_module(init_params(cfg, seed=0, device="cpu").train_mode(),
                                     cfg, host_mesh)
        params = list(model.parameters())
        grads = {}
        for where in ("here", "thread"):
            with mesh_context(host_mesh, ("data",)):
                total, _ = loss_fn(model, cfg, batch)
                D.reset_collectives()
            out = {}

            def backward(out=out, total=total):
                out["g"] = torch.autograd.grad(total, params, allow_unused=True)

            if where == "here":
                backward()
            else:
                t = threading.Thread(target=backward)
                t.start()
                t.join()
            assert D.COLLECTIVE_SITES[("all_gather", site)] > 0, (arch, where)
            grads[where] = out["g"]
        for a, b in zip(grads["here"], grads["thread"]):
            assert (a is None and b is None) or torch.equal(a, b), arch
