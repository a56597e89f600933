"""Serving under the specs' layout (`sharding.specs` run by the model:
tensor-parallel attention and FFN, the vocab-parallel embedding and head,
fsdp, expert parallelism and TP inside experts) on torch.distributed gloo
ranks, against the reference's unsharded `forward` / `generate`.

A rank holds the block of every parameter that `param_pspecs` gives it
(`convert.lm_params_block`) and its `data` slice of the batch; its logits
are its vocab shard, gathered here over `model` for the comparison.
Worlds (data, model): (1, 2), (1, 4), (2, 2) and (2, 1), spawned gloo
processes (`torch_dist_workers.run_world`, one world a mesh shape, every
architecture inside it), and (1, 1) in this process.

Architectures at SMOKE size in float32, with fsdp where the published
configuration has it: qwen1.5-0.5b (tied head, no fsdp), yi-6b (one kv head: its block splits it at model 2 and 4),
qwen2-72b (QKV biases; 2 kv heads, misaligned at model 4; also with
replicate_misaligned_heads, the opt variant, and with 2 query heads, so
wo's rows split heads too, alone and under replicate_misaligned_heads,
where the FFN's wo stays whole over `model` at model 4: ROADMAP C13),
minitron-8b (squared ReLU), mixtral (expert parallel; and with 3
experts, TP inside experts, in the single-stage and the two-stage
branch), qwen2-vl-7b (M-RoPE, a vision prefix) and
hubert-xlarge (the encoder).  MLA, the Mamba2 mixer and the MTP head
(deepseek-v3, mamba2, jamba) are held the same way in
tests/test_torch_tp_a12c.py.

Tolerances: the prefill logits to 1e-5 (the partials' all-reduces sum in
another order), 5 greedy tokens equal; at (1, 1) logits and tokens equal
to the unmeshed port's bit for bit.  Collectives pinned by site.
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
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.serve.engine import generate as j_generate
from repro.train import batching as j_batching
from repro_torch import convert
from repro_torch.core import distributed as D
from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import generate
from repro_torch.sharding.ctx import mesh_context
from torch_dist_workers import host_mesh, jobs_rank, run_world  # noqa: F401

TOL = 1e-5
B, S, STEPS = 2, 16, 5
MESHES = [(1, 2), (1, 4), (2, 2), (2, 1)]
# name -> (arch, config changes, generate?)
F = {"fsdp": True}      # the published configs' fsdp (the SMOKE ones drop it)
CASES = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", {}, True),
    "yi-6b": ("yi-6b", F, True),
    "qwen2-72b": ("qwen2-72b", F, True),
    "qwen2-72b rmh": ("qwen2-72b", {**F, "replicate_misaligned_heads": True}, True),
    "qwen2-72b h2": ("qwen2-72b", {**F, "n_heads": 2, "n_kv_heads": 2}, True),
    # ROADMAP C13: at model 4 the 2 heads are misaligned, so wo stays whole
    # over `model`, the FFN's too, while its wi / wg are column blocks
    "qwen2-72b h2 rmh": ("qwen2-72b", {**F, "n_heads": 2, "n_kv_heads": 2,
                                       "replicate_misaligned_heads": True}, True),
    "minitron-8b": ("minitron-8b", F, True),
    "mixtral": ("mixtral-8x22b", {**F, "capacity_factor": 0.0}, True),
    "mixtral two-stage": ("mixtral-8x22b", {**F, "moe_dp": 2}, True),
    "mixtral e3": ("mixtral-8x22b", {**F, "n_experts": 3}, True),
    "mixtral e3 two-stage": ("mixtral-8x22b", {"n_experts": 3, "moe_dp": 2}, True),
    "qwen2-vl-7b": ("qwen2-vl-7b", F, False),
    "hubert-xlarge": ("hubert-xlarge", F, False),
}
_REF: dict = {}


def _setup(name, arch, changes, gen):
    """(port cfg, numpy tree, forward inputs, reference logits, reference
    tokens or None), once a case."""
    if name not in _REF:
        jcfg = dataclasses.replace(J_SMOKE[arch], dtype="float32", **changes)
        params = j_init_params(jax.random.PRNGKey(3), jcfg)
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
        kind = "train" if not jcfg.causal else "prefill"
        batch = j_batching.synthetic_batch(jcfg, JShape("x", S, B, kind), seed=4)
        inputs = {k: np.array(batch[k]) for k in ("tokens", "embeds", "positions3")
                  if k in batch}
        want = np.asarray(j_forward(params, jcfg, **{k: jnp.asarray(v)
                                                     for k, v in inputs.items()}).logits)
        toks = (np.asarray(j_generate(params, jcfg, jnp.asarray(inputs["tokens"]), STEPS))
                if gen
                else None)
        _REF[name] = (ModelConfig(**dataclasses.asdict(jcfg)), tree, inputs, want, toks)
    return _REF[name]


def _cases(names, table):
    out = []
    for name in names:
        arch, changes, gen = table[name]
        cfg, tree, inputs, _, _ = _setup(name, arch, changes, gen)
        out.append((name, cfg, tree, inputs, STEPS if gen else 0))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each mesh's ranks serve every case."""
    tmp = tmp_path_factory.mktemp("tp_worlds")
    cases = _cases(CASES, CASES)

    def world(shape):
        return [r["tp_serve"] for r in
                run_world(jobs_rank, shape, tmp, [("tp_serve", cases)])]

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        return dict(zip(MESHES, pool.map(world, MESHES)))


def _whole(ranks, shape, name, field):
    """The whole batch's `field` from the ranks' data shards (model rank 0
    of each data row; every model rank of a row holds the same)."""
    n_data, n_model = shape
    rows = []
    for r in range(n_data):
        row = [ranks[r * n_model + m][name][field] for m in range(n_model)]
        for other in row[1:]:
            np.testing.assert_array_equal(other, row[0])
        rows.append(row[0])
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", MESHES)
def test_prefill_logits_and_greedy_tokens_match_reference(worlds, shape, name):
    arch, changes, gen = CASES[name]
    _, _, _, want, toks = _setup(name, arch, changes, gen)
    ranks = worlds[shape]
    got = _whole(ranks, shape, name, "logits")
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)
    if gen:
        np.testing.assert_array_equal(_whole(ranks, shape, name, "tokens"), toks)


@pytest.mark.parametrize("shape", MESHES)
def test_temperature_sampling_over_vocab_shards_matches_the_whole_engine(worlds, shape):
    """Gumbel draws over vocab shards: each rank slices the global (B,
    vocab) uniforms to its ids, so the sharded engine picks the tokens the
    unmeshed port's generate picks from the same uniforms."""
    for name in ("qwen2-72b", "mixtral"):
        arch, changes, gen = CASES[name]
        cfg, tree, inputs, _, _ = _setup(name, arch, changes, gen)
        model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
        u = np.random.default_rng(11).random((STEPS - 1, B, cfg.vocab), dtype=np.float32)
        want = generate(model, cfg, torch.from_numpy(inputs["tokens"]), STEPS,
                        temperature=0.7, uniforms=torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(_whole(worlds[shape], shape, name, "sampled"), want)


def _dense_sites(shape, layers=2, fsdp=True, misaligned_kv=False, tied=False):
    """A dense GQA model's forward collectives by site."""
    sites = {"all_reduce|attn_out": layers, "all_reduce|mlp_out": layers,
             "all_reduce|embed": 1}
    if fsdp:
        # wq, wk, wv, wo, wi, wg, wo a layer; the embedding, and the head
        sites["all_gather|fsdp"] = 7 * layers + 1 + (0 if tied else 1)
    if misaligned_kv:
        sites["all_gather|attn_heads"] = 2 * layers
    return sites


@pytest.mark.parametrize("shape", MESHES)
def test_collectives_by_site(worlds, shape):
    ranks = worlds[shape]
    for r in ranks:
        assert r["qwen1.5-0.5b"]["sites"] == _dense_sites(shape, fsdp=False, tied=True)
        assert r["qwen2-72b"]["sites"] == _dense_sites(shape, misaligned_kv=shape[1] == 4)
        # the rmh variant: misaligned wk / wv whole over `model`, no gather
        assert "all_gather|attn_heads" not in r["qwen2-72b rmh"]["sites"]
        # 2 query heads at model 4: q, k and v gathered, wo's rows split heads
        h2 = r["qwen2-72b h2"]["sites"]
        assert h2.get("all_gather|attn_heads", 0) == (6 if shape[1] == 4 else 0)
        # greedy: one (max, argmax) gather over `model` a forward where
        # the vocab is sharded (at model 1 the logits are whole)
        gen = r["qwen2-72b"]["gen_sites"]
        assert gen.get("all_gather|sample", 0) == (STEPS if shape[1] > 1 else 0)
        assert gen["all_reduce|attn_out"] == 2 * STEPS
        # no backward collective in serving
        assert not any(k.endswith(".grad") for k in gen)


def test_one_rank_mesh_is_bit_for_bit_the_unmeshed_port(host_mesh):
    """(1, 1): every case's logits and tokens equal the unmeshed port's bit
    for bit (the same arithmetic; all-reduces over one rank)."""
    for name in CASES:
        arch, changes, gen = CASES[name]
        cfg, tree, inputs, _, _ = _setup(name, arch, changes, gen)
        kw = {k: torch.from_numpy(v) for k, v in inputs.items()}
        model = convert.lm_params_from_numpy(tree, cfg, device="cpu")
        want = forward(model, cfg, **kw)
        want_toks = generate(model, cfg, kw["tokens"], STEPS) if gen else None
        convert.shard_module(model, cfg, host_mesh)
        D.reset_collectives()
        with mesh_context(host_mesh, ("data",)):
            got = forward(model, cfg, **kw)
            got_toks = generate(model, cfg, kw["tokens"], STEPS) if gen else None
        assert torch.equal(got.logits, want.logits), name
        assert torch.equal(got.aux_loss, want.aux_loss), name
        if gen:
            assert torch.equal(got_toks, want_toks), name
        assert D.COLLECTIVES["all_reduce"] > 0, name


def test_one_rank_collectives_move_nothing_and_still_count(host_mesh):
    """Over a one-rank axis the collectives return their input (no copy of a
    weight a call) and count the call at its site; gradients pass through."""
    w = torch.arange(12.0).reshape(3, 4).requires_grad_()
    D.reset_collectives()
    outs = [D.gather_shards(w, host_mesh, "data", 0, "t"),
            D.gather_replicated(w, host_mesh, "model", 1, "t"),
            D.reduce_partials(w, host_mesh, "model", "t"),
            D.replicated_input(w, host_mesh, "model", "t")]
    assert all(o.data_ptr() == w.data_ptr() and torch.equal(o, w) for o in outs)
    sum(o.sum() for o in outs).backward()
    assert torch.equal(w.grad, torch.full_like(w, 4.0))
    for fn in (D.all_reduce, lambda t, m, a, s: D.reduce_scatter(t, m, a, 0, s)):
        assert fn(w, host_mesh, "data", "t").data_ptr() == w.data_ptr()
    assert D.all_gather(w, host_mesh, "model", "t")[0].data_ptr() == w.data_ptr()
    assert dict(D.COLLECTIVE_SITES) == {
        ("all_gather", "t"): 3, ("reduce_scatter", "t.grad"): 1, ("all_reduce", "t"): 2,
        ("all_reduce", "t.grad"): 1, ("reduce_scatter", "t"): 1}
