"""Port parity of the LM substrate's other mixers and architectures: MoE,
MLA (both decode paths), the Mamba2 SSD scan, the jamba hybrid and the
vision / audio prefixes (`repro_torch.models` against `repro.models`) at
SMOKE size, with the reference's parameters carried in by
`convert.lm_params_from_numpy` (norm weights perturbed from their one
init, so that they count).

Tolerances: float32 outputs and logits at rtol = atol = 1e-4 (float32
sums taken in other orders); routed expert ids, slot positions and the
dropped slots exactly; bf16 logits to 3e-2 of the largest logit, the
reference's own bound for bf16 decode against a full forward
(tests/test_decode_multistep.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.configs.shapes import ShapeSpec as JShape
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import moe as JMOE
from repro.models import ssm as JSSM
from repro.train import batching as j_batching
from repro_torch import convert
from repro_torch.configs import ShapeSpec as TShape
from repro_torch.models import forward as t_forward
from repro_torch.models import init_cache as t_init_cache
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TSSM
from repro_torch.models.config import ModelConfig
from repro_torch.train import batching as t_batching

NEW = ["deepseek-v3-671b", "mixtral-8x22b", "mamba2-130m", "jamba-1.5-large-398b",
       "qwen2-vl-7b", "hubert-xlarge"]
DECODERS = [a for a in NEW if a != "hubert-xlarge"]
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_cfg(jcfg, **kw):
    return ModelConfig(**{**dataclasses.asdict(jcfg), **kw})


def _perturb_norms(tree, rng):
    for key, node in tree.items():
        if isinstance(node, dict):
            _perturb_norms(node, rng)
        elif "norm" in key:
            tree[key] = 1.0 + 0.1 * rng.normal(size=node.shape)


def lm_pair(jcfg, seed=0):
    """(reference params, port model) on the reference's init, its norm
    weights perturbed in numpy."""
    params = j_init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    _perturb_norms(np_params, np.random.default_rng(seed))
    dt = jnp.dtype(jcfg.dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dt), np_params)
    return jparams, convert.lm_params_from_numpy(np_params, _port_cfg(jcfg), device="cpu")


def _inputs(jcfg, b, s, seed):
    """(reference kwargs, port kwargs) of one numpy-seeded input: frame
    embeddings for the audio encoder, tokens (and text M-RoPE ids, the
    same position on all three axes) otherwise."""
    rng = np.random.default_rng(seed)
    if jcfg.modality == "audio":
        e = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
        return {"embeds": jnp.array(e)}, {"embeds": _t(e)}
    toks = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    jkw, tkw = {"tokens": jnp.array(toks)}, {"tokens": _t(toks)}
    if jcfg.pos_emb == "mrope":
        p3 = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        jkw["positions3"], tkw["positions3"] = jnp.array(p3), _t(p3)
    return jkw, tkw


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def _reference_routing(jp, x, jcfg, cap):
    """The reference's routing (moe_ffn's single-stage formulas): expert ids
    (T, k), slot positions (T*k,) and the kept mask."""
    logits = x.astype(jnp.float32) @ jp["router"]
    scores = (jax.nn.sigmoid(logits) if jcfg.attn_type == "mla"
              else jax.nn.softmax(logits, axis=-1))
    _, eidx = jax.lax.top_k(scores, jcfg.experts_per_token)
    flat = eidx.reshape(-1)
    onehot = jax.nn.one_hot(flat, jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    return np.asarray(eidx), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("cf", [0.0, 1.0])
def test_moe_ffn_matches_reference(arch, cf):
    """The single-stage MoE: dropless (the SMOKE configs) and at capacity
    factor 1, where slots drop; routed ids, positions and dropped slots
    equal, outputs and the aux loss to 1e-4."""
    jcfg = dataclasses.replace(J_SMOKE[arch], dtype="float32", capacity_factor=cf)
    tcfg = _port_cfg(jcfg)
    jparams, port = lm_pair(jcfg, seed=1)
    i = next(i for i, layer in enumerate(port.layers) if layer.kind[1] == "moe")
    tp = port.layers[i].ffn
    prefix = jcfg.moe_layer_start if jcfg.n_experts else 0
    if i < prefix:
        jp = jparams["prefix"][f"layer{i}"]["ffn"]
    else:
        from repro.models.model import unit_spec
        n = len(unit_spec(jcfg).kinds)
        jp = jax.tree.map(lambda a: a[(i - prefix) // n],
                          jparams["body"][f"slot{(i - prefix) % n}"]["ffn"])
    x = np.random.default_rng(2).normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    want, want_aux = JMOE.moe_ffn(jp, jnp.array(x), jcfg)
    got, got_aux = TMOE.moe_ffn(tp, _t(x), tcfg)
    _close(got.numpy(), want)
    _close(got_aux.numpy(), want_aux)

    t = 48
    cap = TMOE.capacity(t, tcfg)
    assert cap == (t * jcfg.experts_per_token if cf <= 0 else
                   int(max((t * jcfg.experts_per_token * cf) // jcfg.n_experts, min(t, 8))))
    eidx, pos, keep = _reference_routing(jp, jnp.array(x.reshape(t, -1)), jcfg, cap)
    _, _, teidx = TMOE.route(tp, _t(x.reshape(t, -1)), tcfg)
    tpos = TMOE.slot_positions(teidx.reshape(-1), jcfg.n_experts)
    np.testing.assert_array_equal(teidx.numpy(), eidx)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal((tpos < cap).numpy(), keep)
    if cf > 0:
        assert not keep.all()  # the capacity case does drop slots


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x22b"])
def test_moe_two_stage_matches_reference(arch, dp):
    """moe_dp > 1 with no mesh: the per-block dispatch, at a capacity
    factor where slots drop within a block."""
    jcfg = dataclasses.replace(J_SMOKE[arch], dtype="float32", moe_dp=dp,
                               capacity_factor=1.0)
    tcfg = _port_cfg(jcfg)
    jparams, port = lm_pair(jcfg, seed=3)
    i = next(i for i, layer in enumerate(port.layers) if layer.kind[1] == "moe")
    prefix = jcfg.moe_layer_start
    jp = jax.tree.map(lambda a: a[i - prefix], jparams["body"]["slot0"]["ffn"])
    x = np.random.default_rng(4).normal(size=(4, 8, jcfg.d_model)).astype(np.float32)
    want, want_aux = JMOE.moe_ffn(jp, jnp.array(x), jcfg)
    got, got_aux = TMOE.moe_ffn(port.layers[i].ffn, _t(x), tcfg)
    _close(got.numpy(), want)
    _close(got_aux.numpy(), want_aux)


def test_moe_bf16_combine_sums_slots_in_order():
    """bf16 deepseek SMOKE MoE: within 3e-2 of the reference's output, the
    routing (on float32 router logits) exactly equal."""
    jcfg = J_SMOKE["deepseek-v3-671b"]
    tcfg = _port_cfg(jcfg)
    jparams, port = lm_pair(jcfg, seed=5)
    jp = jax.tree.map(lambda a: a[0], jparams["body"]["slot0"]["ffn"])
    x = np.random.default_rng(6).normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    xb = jnp.array(x, jnp.bfloat16)
    want, _ = JMOE.moe_ffn(jp, xb, jcfg)
    got, _ = TMOE.moe_ffn(port.layers[1].ffn, _t(np.asarray(xb, np.float32)).bfloat16(),
                          tcfg)
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() <= 3e-2 * np.abs(want).max()


# --------------------------------------------------------------------------
# SSD
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,length", [(4, 16), (8, 32), (16, 32), (32, 32)])
def test_ssd_chunked_matches_reference(chunk, length):
    rng = np.random.default_rng(chunk)
    b, h, p, n = 2, 3, 4, 5
    x = rng.normal(size=(b, length, h, p)).astype(np.float32)
    a = -np.abs(rng.normal(size=(b, length, h))).astype(np.float32) * 0.3
    bb = rng.normal(size=(b, length, n)).astype(np.float32)
    cc = rng.normal(size=(b, length, n)).astype(np.float32)
    wy, wst = JSSM.ssd_chunked(*(jnp.array(v) for v in (x, a, bb, cc)), chunk)
    gy, gst = TSSM.ssd_chunked(*(_t(v) for v in (x, a, bb, cc)), chunk)
    _close(gy.numpy(), wy)
    _close(gst.numpy(), wst)
    # the segment sums: -inf above the diagonal before exp
    seg = TSSM._segsum(_t(a[0, :chunk, 0]))
    assert torch.isinf(seg.triu(1)[seg.triu(1) != 0]).all()
    _close(seg.nan_to_num(neginf=0).numpy(),
           np.nan_to_num(np.asarray(JSSM._segsum(jnp.array(a[0, :chunk, 0]))), neginf=0))


@pytest.mark.parametrize("length", [5, 16, 23, 40])
def test_mamba_mixer_prefill_padding_and_state(length):
    """mamba_mixer's chunked prefill at lengths below, at, between and
    above chunk multiples (ssd_chunk 16: padding at 23 and 40) against the
    reference, cache included; the padded final state equals the state
    the recurrence reaches one token at a time (dt is 0 on padding)."""
    jcfg = dataclasses.replace(J_SMOKE["mamba2-130m"], dtype="float32")
    tcfg = _port_cfg(jcfg)
    jparams, port = lm_pair(jcfg, seed=7)
    jp = jax.tree.map(lambda a: a[0], jparams["body"]["slot0"]["mixer"])
    tp = port.layers[0].mixer
    x = np.random.default_rng(length).normal(size=(2, length, jcfg.d_model)).astype(np.float32)
    jc = JSSM.init_mamba_cache(jcfg, 2, jnp.float32)
    want, jc = JSSM.mamba_mixer(jp, jnp.array(x), jcfg, cache=jc)
    tc = TSSM.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    got = TSSM.mamba_mixer(tp, _t(x), tcfg, cache=tc)
    _close(got.numpy(), want)
    _close(tc["ssm"].numpy(), jc["ssm"])
    _close(tc["conv"].numpy(), jc["conv"])
    step = TSSM.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
    for i in range(length):
        TSSM.mamba_mixer(tp, _t(x[:, i:i + 1]), tcfg, cache=step)
    _close(step["ssm"].numpy(), tc["ssm"].numpy())


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("flash", [False, True])
def test_forward_logits_match_reference_float32(arch, flash):
    """Forward logits and the aux loss, with the flash path off and forced
    on (flash_threshold 32, flash_chunk 16; hubert's bidirectional
    encoder, deepseek's MLA at Dk 24 / Dv 16)."""
    kw = {"dtype": "float32"}
    if flash:
        kw.update(flash_threshold=32, flash_chunk=16)
    jcfg = dataclasses.replace(J_SMOKE[arch], **kw)
    jparams, port = lm_pair(jcfg)
    jkw, tkw = _inputs(jcfg, 2, 64, seed=2)
    want = j_forward(jparams, jcfg, **jkw)
    got = t_forward(port, _port_cfg(jcfg), **tkw)
    assert got.logits.dtype == torch.float32
    _close(got.logits.numpy(), want.logits)
    _close(got.aux_loss.numpy(), want.aux_loss)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-130m",
                                  "jamba-1.5-large-398b", "mixtral-8x22b"])
def test_forward_logits_match_reference_bf16(arch):
    """bf16 SMOKE logits.  A token whose two best experts' scores tie within
    bf16's rounding of its hidden state routes either way, in either
    framework (on this input jamba's and mixtral's reference forwards move
    0.22 and 0.37 of the largest logit from their own float32 forward), so
    the bound is the float32 forward: the port within 3e-2 of its largest
    logit, or within 1.25 times the reference's own distance to it."""
    jcfg = J_SMOKE[arch]
    assert jcfg.dtype == "bfloat16"
    jparams, port = lm_pair(jcfg)
    jkw, tkw = _inputs(jcfg, 2, 32, seed=3)
    want = np.asarray(j_forward(jparams, jcfg, **jkw).logits, np.float64)
    got = t_forward(port, _port_cfg(jcfg), **tkw).logits.numpy()
    f32 = dataclasses.replace(jcfg, dtype="float32")
    exact = np.asarray(j_forward(jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
                                 f32, **jkw).logits, np.float64)
    scale = np.abs(exact).max()
    ref_err = np.abs(want - exact).max() / scale
    assert np.abs(got - exact).max() / scale <= max(3e-2, 1.25 * ref_err)


def test_vision_prefix_matches_reference():
    """qwen2-vl's stubbed frontend: a batch of patch embeddings before the
    tokens with 3-D M-RoPE ids (synthetic_batch), in float32, and the
    port's batch equal to the reference's."""
    jcfg = dataclasses.replace(J_SMOKE["qwen2-vl-7b"], dtype="float32")
    jparams, port = lm_pair(jcfg, seed=8)
    jb = j_batching.synthetic_batch(jcfg, JShape("p", 32, 2, "prefill"), seed=4)
    tb = t_batching.synthetic_batch(_port_cfg(jcfg), TShape("p", 32, 2, "prefill"),
                                    seed=4, device="cpu")
    assert list(tb) == list(jb) == ["tokens", "embeds", "positions3"]
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    want = j_forward(jparams, jcfg, **j_batching.forward_kwargs(jcfg, jb)).logits
    got = t_forward(port, _port_cfg(jcfg), **t_batching.forward_kwargs(None, tb)).logits
    assert got.shape == (2, 32, jcfg.vocab)
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_synthetic_batch_equals_reference(arch, kind):
    """Same structure, dtypes and draws; bf16 embeddings to the bit."""
    jcfg = J_SMOKE[arch]
    jb = j_batching.synthetic_batch(jcfg, JShape("s", 16, 2, kind), seed=9)
    tb = t_batching.synthetic_batch(_port_cfg(jcfg), TShape("s", 16, 2, kind), seed=9,
                                    device="cpu")
    assert list(tb) == list(jb)
    for k in jb:
        want = np.asarray(jb[k].astype(jnp.float32) if jb[k].dtype == jnp.bfloat16 else jb[k])
        got = tb[k].float().numpy() if tb[k].dtype == torch.bfloat16 else tb[k].numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("flash", [False, True])
def test_five_step_decode_matches_reference(arch, flash):
    """Cached prefill, then five decode steps (tests/test_decode_multistep.py's
    schedule), in float32: every call's logits equal the reference's, the
    cache rows the port wrote in place equal its cache, and the decode
    stays within the reference's 3e-2 of a full forward."""
    kw = {"dtype": "float32"}
    if flash:
        kw.update(flash_threshold=32, flash_chunk=16)
    jcfg = dataclasses.replace(J_SMOKE[arch], **kw)
    tcfg = _port_cfg(jcfg)
    jparams, port = lm_pair(jcfg, seed=4)
    b, s, steps = 2, 16, 5
    s_max = 32 if flash else s + steps + 4
    jkw, tkw = _inputs(jcfg, b, s + steps, seed=5)
    full = t_forward(port, tcfg, **tkw).logits

    def cut(kwargs, lo, hi):
        out = {"tokens": kwargs["tokens"][:, lo:hi]}
        if "positions3" in kwargs:
            out["positions3"] = kwargs["positions3"][:, :, lo:hi]
        return out

    jo = j_forward(jparams, jcfg, cache=j_init_cache(jcfg, b, s_max), cache_len=0,
                   **cut(jkw, 0, s))
    to = t_forward(port, tcfg, cache=t_init_cache(tcfg, b, s_max, device="cpu"),
                   cache_len=0, **cut(tkw, 0, s))
    _close(to.logits.numpy(), jo.logits)
    worst = 0.0
    for j in range(steps):
        jo = j_forward(jparams, jcfg, cache=jo.cache, cache_len=s + j,
                       **cut(jkw, s + j, s + j + 1))
        to = t_forward(port, tcfg, cache=to.cache, cache_len=s + j,
                       **cut(tkw, s + j, s + j + 1))
        _close(to.logits.numpy(), jo.logits)
        a, g = full[:, s + j].numpy(), to.logits[:, 0].numpy()
        worst = max(worst, float(np.abs(a - g).max() / (np.abs(a).max() + 1e-9)))
    assert worst < 3e-2, worst
    _compare_caches(to.cache, jo.cache, jcfg)


def _compare_caches(tcache, jcache, jcfg):
    """The port's per-layer cache against the reference's tree (prefix
    layers unstacked, body slots stacked over units)."""
    from repro.models.model import unit_spec

    spec = unit_spec(jcfg)
    for i, layer in enumerate(tcache):
        if i < spec.n_prefix:
            ref = jcache["prefix"][f"layer{i}"]
        else:
            u, j = divmod(i - spec.n_prefix, len(spec.kinds))
            ref = jax.tree.map(lambda a: a[u], jcache["body"][f"slot{j}"])
        assert sorted(layer) == sorted(ref)
        for name, leaf in layer.items():
            _close(leaf.float().numpy(), np.asarray(ref[name], np.float32))


def test_mla_absorbed_decode_matches_materialized_and_reference():
    """tests/test_mla_absorbed.py on the port (absorbed = materialized
    within 2e-2, bf16 SMOKE), and each path against the reference's in
    float32 at 1e-4."""
    cfg = J_SMOKE["deepseek-v3-671b"]
    for dtype, tol in (("bfloat16", None), ("float32", TOL)):
        jcfg = dataclasses.replace(cfg, dtype=dtype)
        jabs = dataclasses.replace(jcfg, mla_absorbed_decode=True)
        tcfg, tabs = _port_cfg(jcfg), _port_cfg(jabs)
        jparams, port = lm_pair(jcfg, seed=0)
        b, s = 2, 24
        toks = np.random.default_rng(11).integers(0, cfg.vocab, (b, s + 4)).astype(np.int32)
        pre = t_forward(port, tcfg, tokens=_t(toks[:, :s]),
                        cache=t_init_cache(tcfg, b, s + 8, device="cpu"), cache_len=0)
        c0 = pre.cache
        c1 = [{k: v.clone() for k, v in layer.items()} for layer in c0]
        if tol:
            jpre = j_forward(jparams, jcfg, tokens=jnp.array(toks[:, :s]),
                             cache=j_init_cache(jcfg, b, s + 8), cache_len=0)
            j0 = j1 = jpre.cache
        for step in range(3):
            tk = _t(toks[:, s + step:s + step + 1])
            d0 = t_forward(port, tcfg, tokens=tk, cache=c0, cache_len=s + step).logits
            d1 = t_forward(port, tabs, tokens=tk, cache=c1, cache_len=s + step).logits
            a, g = d0[:, 0].float().numpy(), d1[:, 0].float().numpy()
            assert np.abs(a - g).max() / (np.abs(a).max() + 1e-9) < 2e-2
            if tol:
                jt = jnp.array(toks[:, s + step:s + step + 1])
                w0 = j_forward(jparams, jcfg, tokens=jt, cache=j0, cache_len=s + step)
                w1 = j_forward(jparams, jabs, tokens=jt, cache=j1, cache_len=s + step)
                j0, j1 = w0.cache, w1.cache
                _close(d0.numpy(), w0.logits, tol)
                _close(d1.numpy(), w1.logits, tol)


def test_init_params_holds_every_reference_parameter():
    """Every architecture's port model holds as many parameters as the
    reference's tree (MTP heads included), and a tree with a leaf the port
    has no parameter for is refused, naming it."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.models import init_params

    for arch in NEW:
        cfg = SMOKE_ARCHS[arch]
        model = init_params(cfg, seed=0, device="cpu")
        n = sum(p.numel() for p in model.parameters())
        jn = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            j_init_params(jax.random.PRNGKey(0), J_SMOKE[arch])))
        assert n == jn, arch
    bad = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       j_init_params(jax.random.PRNGKey(0), J_SMOKE["deepseek-v3-671b"]))
    bad["mtp"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="mtp.extra"):
        convert.lm_params_from_numpy(bad, _port_cfg(J_SMOKE["deepseek-v3-671b"]),
                                     device="cpu")


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_serve_engine_c2_rows_match_reference_deepseek():
    """ServeEngine on deepseek SMOKE (a prefix MLA layer, MoE MLA units) in
    float32: the reference writes an admitted prefill into batch row i of
    a prefix layer's cache and into row 0 of a body layer's (its
    dynamic_update_slice clamps on the unit axis); the port's cache equals
    the reference's after the first admission wave and at the end, and the
    finished sequences are equal."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve import ServeEngine as TEngine

    jcfg = dataclasses.replace(J_SMOKE["deepseek-v3-671b"], dtype="float32")
    tcfg = _port_cfg(jcfg)
    jparams, port = lm_pair(jcfg, seed=12)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jcfg.vocab, 8).astype(np.int32) for _ in range(5)]
    jeng = JEngine(jparams, jcfg, batch=3, s_max=32)
    teng = TEngine(port, tcfg, batch=3, s_max=32)
    for i, p in enumerate(prompts):
        jeng.submit(i, jnp.asarray(p), max_tokens=4)
        teng.submit(i, _t(p), max_tokens=4)
    assert teng._admit() == jeng._admit() == 3
    _compare_caches(teng.cache, jeng.cache, jcfg)
    prefix, body = teng.cache[0]["ckv"], teng.cache[1]["ckv"]
    assert all(prefix[i].abs().sum() > 0 for i in range(3))   # row i a prompt
    assert body[0].abs().sum() > 0 and not body[1:].abs().any()  # row 0 only
    while teng.step():
        assert jeng.step()
    assert not jeng.step()
    assert {k: list(map(int, v)) for k, v in teng.done.items()} == \
        {k: list(map(int, v)) for k, v in jeng.done.items()}
    _compare_caches(teng.cache, jeng.cache, jcfg)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_serve_engine_matches_reference_ssm(arch):
    """The engine's row rule on SSM caches (every layer a body layer: row
    0), in float32: finished sequences and the final caches equal."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve import ServeEngine as TEngine

    jcfg = dataclasses.replace(J_SMOKE[arch], dtype="float32")
    jparams, port = lm_pair(jcfg, seed=14)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, jcfg.vocab, 6).astype(np.int32) for _ in range(3)]
    jeng = JEngine(jparams, jcfg, batch=2, s_max=24)
    teng = TEngine(port, _port_cfg(jcfg), batch=2, s_max=24)
    for i, p in enumerate(prompts):
        jeng.submit(i, jnp.asarray(p), max_tokens=3)
        teng.submit(i, _t(p), max_tokens=3)
    while teng.step():
        assert jeng.step()
    assert {k: list(map(int, v)) for k, v in teng.done.items()} == \
        {k: list(map(int, v)) for k, v in jeng.done.items()}
    _compare_caches(teng.cache, jeng.cache, jcfg)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x22b", "mamba2-130m",
                                  "jamba-1.5-large-398b"])
def test_generate_greedy_tokens_match_reference(arch):
    from repro.serve import generate as j_generate
    from repro_torch.serve import generate as t_generate

    jcfg = dataclasses.replace(J_SMOKE[arch], dtype="float32")
    jparams, port = lm_pair(jcfg, seed=16)
    prompt = np.random.default_rng(17).integers(0, jcfg.vocab, (2, 10)).astype(np.int32)
    want = j_generate(jparams, jcfg, jnp.array(prompt), steps=6)
    got = t_generate(port, _port_cfg(jcfg), _t(prompt), steps=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", DECODERS)
def test_launcher_serves_every_decoder_arch_on_the_cpu(arch):
    """`python -m repro_torch.launch.serve --arch <id> --smoke --device cpu`
    (shortened): the engine and the semantic tier run; qwen2-vl's text
    tokens take M-RoPE ids equal on the three axes, where the reference's
    launcher stops for want of positions3."""
    from repro_torch.launch import serve

    fig = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
                      "--batch", "2", "--catalog", "64"])
    eng, sem = fig["engine"], fig["semantic"]
    assert eng["requests"] == eng["prefills"] == 4 and eng["logits_finite"]
    # NAG is a ratio of float32 sums: a run served wholly from the store
    # (mamba2 SMOKE here) may land a rounding above 1
    assert sem["requests"] == 4 and 0.0 <= sem["nag"] <= 1.0 + 1e-6


def test_launcher_refuses_the_encoder_with_the_reference_message():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="hubert-xlarge-smoke is encoder-only: no decode "
                                         "serving"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
