"""Serving a global batch that does not divide the batch axes (ROADMAP C14,
C16): every rank holds the whole batch, and the KV and latent caches shard
their sequence over the batch axes, as the reference's layout
(`sharding.specs.batch_whole` / `cache_pspecs`), on torch.distributed gloo
ranks against the reference's unmeshed prefill, decode steps and
`generate`.

A rank holds the block of every parameter that `param_pspecs` gives it
(`convert.lm_params_block`) and, under `mesh_context(..., global_batch=1)`,
its slots S / n_batch of every k / v (the sliding window's ring too) and
ckv / krope leaf; it writes a token where it owns its slot and combines
each attention layer's softmax partials, gathered over the batch axes
(site "attn_seq"), in rank order.  Worlds (data, model) (2, 1), (2, 2) and
(pod, data, model) (2, 2, 2), one spawned gloo world a mesh shape with
every case inside it; the linear cache, the ring and MLA also through a
batch-1 `ServeEngine`, at global batch 1 and as a rank's slot of a batch
that divides.

Cases at SMOKE size in float32, batch 1: qwen1.5-0.5b (the linear cache;
also with flash forced, whose prefill must take the reference's flash path
over the prompt's own keys), mixtral (the ring, window 32, a 20-token
prompt decoded 16 steps past it: at (2, 2, 2) the ring's last slice holds
no token at the first steps), deepseek-v3 (the
materialized and the absorbed MLA decode) and jamba (attention, Mamba2 and
MoE).  C16: mixtral with capacity factor 1.25 over a 64-token prompt, whose
MoE drops slots: the rank routes the whole batch as the unmeshed layer.

Tolerances: prefill and per-step logits to 1e-5 (the partials' combine and
the collectives sum in another order), greedy tokens equal.  The rank-order
combine against one softmax to 1e-6.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.serve.engine import generate as j_generate
from repro.serve.engine import make_decode_step as j_decode_step
from repro.serve.engine import make_prefill as j_prefill
from repro_torch.models import init_cache
from repro_torch.models.model import layer_kind
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import specs as S
from torch_dist_workers import jobs_rank, run_world

TOL = 1e-5
MESHES = [(2, 1), (2, 2), (2, 2, 2)]
F = {"fsdp": True}
# name -> (arch, config changes, prompt length, decode steps, s_max)
CASES = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", {}, 20, 5, 32),
    "qwen1.5-0.5b flash": ("qwen1.5-0.5b", {"flash_threshold": 32, "flash_chunk": 16}, 20,
                           3, 32),
    "mixtral": ("mixtral-8x22b", F, 20, 16, 40),
    "deepseek-v3": ("deepseek-v3-671b", F, 20, 5, 32),
    "deepseek-v3 absorbed": ("deepseek-v3-671b", {**F, "mla_absorbed_decode": True}, 20, 5,
                             32),
    "jamba": ("jamba-1.5-large-398b", F, 20, 5, 32),
    "mixtral cf1.25": ("mixtral-8x22b", {**F, "capacity_factor": 1.25}, 64, 0, 64),
}
# the cases a batch-1 ServeEngine also serves: the linear cache, the ring, MLA
ENGINE = ["qwen1.5-0.5b", "mixtral", "deepseek-v3"]
_PARAMS: dict = {}
_REF: dict = {}


def _params(name):
    """(reference config, its parameters, prompt (1, S)), once a case."""
    if name not in _PARAMS:
        arch, changes, s, _, _ = CASES[name]
        jcfg = dataclasses.replace(J_SMOKE[arch], dtype="float32", **changes)
        toks = np.random.default_rng(6).integers(0, jcfg.vocab, (1, s)).astype(np.int32)
        _PARAMS[name] = (jcfg, j_init_params(jax.random.PRNGKey(5), jcfg), toks)
    return _PARAMS[name]


def _setup(name):
    """(port cfg, numpy tree, prompt (1, S), steps, s_max, the reference's
    prefill logits, per-step logits and generate tokens), once a case."""
    if name not in _REF:
        _, _, s, steps, s_max = CASES[name]
        jcfg, params, toks = _params(name)
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
        logits, cache = jax.jit(j_prefill(jcfg, s_max))(
            params, {"tokens": jnp.asarray(toks)}, j_init_cache(jcfg, 1, s_max))
        last = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        decode = jax.jit(j_decode_step(jcfg))
        per_step = []
        for i in range(steps):
            last, lg, cache = decode(params, cache, last, s + i)
            per_step.append(np.asarray(lg))
        want = np.asarray(j_generate(params, jcfg, jnp.asarray(toks), steps + 1, s_max=s_max))
        _REF[name] = (ModelConfig(**dataclasses.asdict(jcfg)), tree, toks, steps, s_max,
                      np.asarray(logits), per_step, want)
    return _REF[name]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each mesh's ranks serve every case at batch 1 (the ENGINE cases
    through ServeEngine too); the reference's side is computed in this
    process meanwhile."""
    tmp = tmp_path_factory.mktemp("seq_cache_worlds")
    cases = []
    for name, (_, _, _, steps, s_max) in CASES.items():
        jcfg, params, toks = _params(name)
        cases.append((name, ModelConfig(**dataclasses.asdict(jcfg)),
                      jax.tree.map(lambda a: np.asarray(a, np.float32), params), toks, steps,
                      s_max, name in ENGINE))

    def world(shape):
        return [r["seq_cache"] for r in
                run_world(jobs_rank, shape, tmp, [("seq_cache", cases)], timeout=240)]

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = [pool.submit(world, shape) for shape in MESHES]
        for name in CASES:
            _setup(name)
        return {shape: f.result() for shape, f in zip(MESHES, futs)}


def _mesh_shape(shape) -> dict:
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return dict(zip(names, shape))


def _n_batch(shape) -> int:
    return int(np.prod(shape[:-1]))


SERVED = [n for n in CASES if CASES[n][3]]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", SERVED)
def test_batch_one_serves_as_the_unmeshed_reference(worlds, shape, name):
    """Prefill and every decode step's logits within 1e-5 of the reference's
    unmeshed ones on every rank; the greedy tokens (the decode loop's and
    `generate`'s) equal the reference's `generate`."""
    _, _, _, steps, _, want_prefill, want_steps, want_tokens = _setup(name)
    for r, rec in enumerate(worlds[shape]):
        got = rec[name]
        assert got["whole"], (name, r)
        np.testing.assert_allclose(got["prefill"], want_prefill, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} rank {r} prefill")
        assert len(got["steps"]) == steps
        for i, (g, w) in enumerate(zip(got["steps"], want_steps)):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} rank {r} step {i}")
        np.testing.assert_array_equal(got["tokens"], want_tokens, err_msg=name)
        np.testing.assert_array_equal(got["generate"], want_tokens, err_msg=name)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ENGINE)
def test_serve_engine_admits_into_either_layout(worlds, shape, name):
    """ServeEngine at batch 1 serves the reference's tokens at global batch 1
    (its cache and its one-row prefill's sequence-sharded) and as a rank's
    slot of a batch that divides the batch axes (every rank the same
    prompt): there its one-row prefill keeps the batch cache's layout,
    every slot on every rank."""
    cfg, _, _, _, s_max, _, _, want = _setup(name)
    whole = init_cache(cfg, 1, s_max, device="meta")[0]
    n = _n_batch(shape)
    for rec in worlds[shape]:
        eng = rec[name]["engine"]
        for label in ("whole", "divides"):
            assert eng[label]["tokens"] == want[0].tolist(), (name, label)
        for leaf, t in whole.items():
            if leaf in ("k", "v", "ckv", "krope"):
                assert eng["whole"]["slots"][leaf][1] * n == t.shape[1], (name, leaf)
                assert eng["divides"]["slots"][leaf][1] == t.shape[1], (name, leaf)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mixtral", "deepseek-v3", "jamba"])
def test_each_rank_holds_its_share_of_the_sequence(worlds, shape, name):
    """Every cache leaf is the rank's block of `cache_pspecs`' layout of the
    whole cache (built at the global batch 1): k / v / ckv / krope hold S /
    n_batch slots (mixtral's ring: its 32 slots over the batch ranks), the
    batch whole; the recorded `pspec` is that spec."""
    cfg, _, _, _, s_max, *_ = _setup(name)
    mesh_shape = _mesh_shape(shape)
    whole = init_cache(cfg, 1, s_max, device="meta")
    specs = S.cache_pspecs(cfg, whole, mesh_shape, len(shape) == 3)
    n = _n_batch(shape)
    seq_leaves = 0
    for rec in worlds[shape]:
        cache = rec[name]["cache"]
        for i, layer in enumerate(whole):
            for leaf, t in layer.items():
                got_shape, got_spec = cache[i][leaf]
                assert got_spec == specs[i][leaf], (name, i, leaf)
                assert tuple(got_shape) == S.local_shape(t.shape, specs[i][leaf],
                                                         mesh_shape), (name, i, leaf)
                if leaf in ("k", "v", "ckv", "krope"):
                    assert got_shape[0] == 1 and got_shape[1] * n == t.shape[1], \
                        (name, i, leaf)
                    seq_leaves += 1
    assert seq_leaves > 0


def _attention_layers(cfg) -> int:
    return sum(layer_kind(cfg, i)[0] in ("attn", "mla") for i in range(cfg.n_layers))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", SERVED)
def test_collectives_by_site(worlds, shape, name):
    """A decode step gathers each attention layer's partials once a batch
    axis of more than one rank (site "attn_seq"); the prefill none (it
    attends over the prompt's own keys).  Under the whole batch the MoE
    exchanges nothing over the batch axes (no "moe_ids", no "moe_aux")."""
    cfg = _setup(name)[0]
    axes = len(shape) - 1
    for rec in worlds[shape]:
        got = rec[name]
        assert got["step_sites"].get("all_gather|attn_seq", 0) == _attention_layers(cfg) * axes
        assert "all_gather|attn_seq" not in got["prefill_sites"]
        for sites in (got["step_sites"], got["prefill_sites"]):
            assert not [s for s in sites if "moe_ids" in s or "moe_aux" in s], sites


@pytest.mark.parametrize("shape", MESHES)
def test_prefill_takes_the_reference_flash_path(worlds, shape):
    """The flash condition reads the whole cache's length (32 >= the forced
    threshold 32), though a rank attends over the prompt's 20 keys: one
    flash call a layer over those keys, as the unmeshed prefill makes one
    over its 32-slot cache; without flash forced, none."""
    cfg = _setup("qwen1.5-0.5b flash")[0]
    for rec in worlds[shape]:
        calls = rec["qwen1.5-0.5b flash"]["flash"]
        assert len(calls) == _attention_layers(cfg)
        assert all(c[1] == 20 for c in calls), calls
        assert rec["qwen1.5-0.5b"]["flash"] == []


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_moe_under_a_whole_batch_matches_unmeshed_reference(worlds, shape):
    """C16: SMOKE mixtral at capacity factor 1.25, batch 1, a 64-token
    prompt: slots drop, so a rank that counted the other ranks' copies of
    the batch as tokens before its own would drop others.  Every rank's
    prefill logits within 1e-5 of the reference's unmeshed forward."""
    want = _setup("mixtral cf1.25")[5]
    for r, rec in enumerate(worlds[shape]):
        np.testing.assert_allclose(rec["mixtral cf1.25"]["prefill"], want, rtol=TOL,
                                   atol=TOL, err_msg=f"rank {r}")


# --------------------------------------------------------------------------
# the rank-order combine
# --------------------------------------------------------------------------

def _softmax_f64(q, k, v, mask):
    """One softmax over every slot, in float64: q (B, 1, H, D), k / v (B, T,
    KV, D), GQA head h on kv head h // (H / KV)."""
    g = q.shape[2] // k.shape[2]
    kk = k.double().repeat_interleave(g, dim=2)
    vv = v.double().repeat_interleave(g, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.double(), kk) / q.shape[-1] ** 0.5
    w = torch.softmax(logits + mask.double(), dim=-1)
    return torch.einsum("bhst,bthd->bshd", w, vv)


@pytest.mark.parametrize("slices", [3, 6])
def test_combine_equals_one_softmax(slices):
    """Seeded q / k / v over 24 slots in `slices` slices: the partials of
    each slice combined in rank order equal one softmax over all slots
    (float64 reference) to 1e-6, including a slice whose every slot is
    masked (m = -inf: it adds nothing) and a ring slice never written
    (positions < 0)."""
    g = torch.Generator().manual_seed(7)
    b, h, kv, d, t = 1, 4, 2, 8, 24
    q = torch.randn(b, 1, h, d, generator=g)
    k = torch.randn(b, t, kv, d, generator=g)
    v = torch.randn(b, t, kv, d, generator=g)
    cfg = ModelConfig(**dataclasses.asdict(J_SMOKE["qwen1.5-0.5b"]))
    # positions: the last slice never written (-1), the first past the query
    # (masked by the causal rule), the rest before it
    pos = torch.arange(t)
    per = t // slices
    pos[:per] = 100
    pos[-per:] = -1
    mask = L.seq_mask(1, 50, pos, cfg)
    parts = torch.stack([L.sdpa_partials(q, k[:, i:i + per], v[:, i:i + per],
                                         mask[:, i:i + per])
                         for i in range(0, t, per)])
    assert torch.isinf(parts[0, ..., -2]).all() and torch.isinf(parts[-1, ..., -2]).all()
    got = L.combine_partials(parts)
    want = _softmax_f64(q, k, v, mask)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


def test_combine_of_rows_no_slice_keeps_is_zero():
    """A row no rank keeps (every slice masked) combines to 0, not NaN."""
    g = torch.Generator().manual_seed(8)
    q = torch.randn(1, 1, 2, 4, generator=g)
    k = torch.randn(1, 8, 2, 4, generator=g)
    mask = torch.full((1, 4), float("-inf"))
    parts = torch.stack([L.sdpa_partials(q, k[:, i:i + 4], k[:, i:i + 4], mask)
                         for i in (0, 4)])
    out = L.combine_partials(parts)
    assert torch.equal(out, torch.zeros_like(out))


def test_write_slots_writes_only_the_owned_slots():
    """A token at whole-cache slot p lands in the block [lo, lo + T) that
    holds p, and nowhere else; a span over two blocks splits."""
    blocks = [torch.zeros(1, 4, 1) for _ in range(3)]
    new = torch.arange(1.0, 4.0).reshape(1, 3, 1)
    for r, blk in enumerate(blocks):
        L.write_slots(blk, new, 3, 4 * r)
    whole = torch.cat(blocks, dim=1)[0, :, 0]
    assert whole.tolist() == [0, 0, 0, 1, 2, 3] + [0] * 6
