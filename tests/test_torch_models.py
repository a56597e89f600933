"""Port parity of the LM substrate: `repro_torch.models` against
`repro.models` at SMOKE size, with the reference's parameters carried in
by `convert.lm_params_from_numpy` (biases and norm weights perturbed from
their zero / one init, so that they count).

Tolerances: the element-wise layers (rms_norm, RoPE, M-RoPE) agree to
1e-6; attention and float32 logits to 1e-4 (float32 sums taken in other
orders); bf16 logits to 3e-2 of the largest logit, the reference's own
bound for bf16 decode against a full forward (tests/test_decode_multistep.py),
since the two frameworks round bf16 matmuls at other places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models.model import unit_spec as j_unit_spec
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import forward as t_forward
from repro_torch.models import init_cache as t_init_cache
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig

DENSE = ["qwen1.5-0.5b", "yi-6b", "minitron-8b", "qwen2-72b"]
# the MoE, MLA, SSM, hybrid and prefixed architectures (tests/test_torch_lm_archs.py)
ALL_OTHERS = ["deepseek-v3-671b", "mixtral-8x22b", "mamba2-130m", "jamba-1.5-large-398b",
              "qwen2-vl-7b", "hubert-xlarge"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_cfg(jcfg, **kw):
    """The port's ModelConfig with the reference config's fields."""
    return ModelConfig(**{**dataclasses.asdict(jcfg), **kw})


def lm_pair(jcfg, seed=0):
    """(reference params, port model): the reference's init, perturbed in
    numpy, handed to both."""
    params = j_init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    rng = np.random.default_rng(seed)
    body = np_params["body"]["slot0"]
    for name in ("bq", "bk", "bv"):
        if name in body["mixer"]:
            body["mixer"][name] = 0.1 * rng.normal(size=body["mixer"][name].shape)
    for name in ("norm1", "norm2"):
        body[name] = 1.0 + 0.1 * rng.normal(size=body[name].shape)
    np_params["final_norm"] = 1.0 + 0.1 * rng.normal(size=np_params["final_norm"].shape)
    dt = jnp.dtype(jcfg.dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dt), np_params)
    port = convert.lm_params_from_numpy(np_params, _port_cfg(jcfg), device="cpu")
    return jparams, port


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + ALL_OTHERS)
def test_configs_are_the_reference_configs(arch):
    from repro.configs import ARCHS as J_ARCHS

    for smoke, table in ((False, J_ARCHS), (True, J_SMOKE)):
        port = tconfigs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(port) == dataclasses.asdict(table[arch])
        assert port.param_count() == table[arch].param_count()
        assert tuple(tmodel.unit_spec(port)) == tuple(j_unit_spec(table[arch]))


def test_shapes_and_runnable_are_the_reference_ones():
    from repro.configs import SHAPES, runnable

    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in SHAPES.items()}
    for arch in DENSE + ALL_OTHERS:
        for name, shape in SHAPES.items():
            assert tconfigs.runnable(tconfigs.ARCHS[arch], tconfigs.SHAPES[name]) == \
                runnable(tconfigs.ARCHS[arch], shape)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(TL.rms_norm(_t(x), _t(w), 1e-5).numpy(),
                               np.asarray(JL.rms_norm(jnp.array(x), jnp.array(w), 1e-5)),
                               rtol=1e-6, atol=1e-6)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(TL.apply_rope(_t(x), _t(pos), 1e4).numpy(),
                               np.asarray(JL.apply_rope(jnp.array(x), jnp.array(pos), 1e4)),
                               rtol=1e-6, atol=1e-6)
    pos3 = rng.integers(0, 500, (3, 2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_mrope(_t(x), _t(pos3), 1e4, (2, 3, 3)).numpy(),
        np.asarray(JL.apply_mrope(jnp.array(x), jnp.array(pos3), 1e4, (2, 3, 3))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,t,q_offset,written_upto,window,causal", [
    (16, 16, 0, None, 0, True),     # dense
    (1, 40, 39, 40, 0, True),       # dense decode against a cache
    (64, 64, 0, None, 0, True),     # flash (T >= 32, T % 16 == 0)
    (24, 64, 0, 24, 0, True),       # flash, cached prefill
    (16, 64, 20, 36, 8, True),      # flash, window and offset
    (32, 64, 0, None, 0, False),    # flash, bidirectional
])
def test_attention_core_matches_reference(s, t, q_offset, written_upto, window, causal):
    jcfg = dataclasses.replace(J_SMOKE["yi-6b"], flash_threshold=32, flash_chunk=16,
                               sliding_window=window, causal=causal)
    tcfg = _port_cfg(jcfg)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, t, 1, 16)).astype(np.float32)
    v = rng.normal(size=(2, t, 1, 16)).astype(np.float32)
    want = JL.attention_core(jnp.array(q), jnp.array(k), jnp.array(v), q_offset,
                             jcfg, written_upto=written_upto)
    got = TL.attention_core(_t(q), _t(k), _t(v), q_offset, tcfg,
                            written_upto=written_upto)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("flash", [False, True])
def test_forward_logits_match_reference_float32(arch, flash):
    kw = {"dtype": "float32"}
    if flash:
        kw.update(flash_threshold=32, flash_chunk=16)
    jcfg = dataclasses.replace(J_SMOKE[arch], **kw)
    jparams, port = lm_pair(jcfg)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 64)).astype(np.int32)
    want = j_forward(jparams, jcfg, tokens=jnp.array(toks)).logits
    got = t_forward(port, _port_cfg(jcfg), tokens=_t(toks)).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "yi-6b"])
def test_forward_logits_match_reference_bf16(arch):
    jcfg = J_SMOKE[arch]
    assert jcfg.dtype == "bfloat16"
    jparams, port = lm_pair(jcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    want = j_forward(jparams, jcfg, tokens=jnp.array(toks)).logits
    got = t_forward(port, _port_cfg(jcfg), tokens=_t(toks)).logits
    assert got.dtype == torch.float32
    assert _max_rel(want, got.numpy()) < 3e-2


@pytest.mark.parametrize("flash", [False, True])
def test_cached_prefill_and_decode_match_reference(flash):
    """Prefill into a cache, then five decode steps, in float32: the
    logits of every call agree, and the cache rows the port wrote in place
    equal the reference's."""
    kw = {"dtype": "float32"}
    if flash:
        kw.update(flash_threshold=32, flash_chunk=16)
    jcfg = dataclasses.replace(J_SMOKE["qwen1.5-0.5b"], **kw)
    tcfg = _port_cfg(jcfg)
    jparams, port = lm_pair(jcfg, seed=4)
    b, s, steps, s_max = 2, 12, 5, 32
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (b, s + steps)).astype(np.int32)
    jc = j_init_cache(jcfg, b, s_max)
    tc = t_init_cache(tcfg, b, s_max, device="cpu")
    jo = j_forward(jparams, jcfg, tokens=jnp.array(toks[:, :s]), cache=jc, cache_len=0)
    to = t_forward(port, tcfg, tokens=_t(toks[:, :s]), cache=tc, cache_len=0)
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits), rtol=1e-4, atol=1e-4)
    for j in range(steps):
        jo = j_forward(jparams, jcfg, tokens=jnp.array(toks[:, s + j:s + j + 1]),
                       cache=jo.cache, cache_len=s + j)
        to = t_forward(port, tcfg, tokens=_t(toks[:, s + j:s + j + 1]),
                       cache=to.cache, cache_len=s + j)
        np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                                   rtol=1e-4, atol=1e-4)
    for i, layer in enumerate(to.cache):
        np.testing.assert_allclose(layer["k"].numpy(),
                                   np.asarray(jo.cache["body"]["slot0"]["k"][i]),
                                   rtol=1e-4, atol=1e-4)


def test_swa_ring_cache_long_decode():
    """tests/test_decode_multistep.py's ring test on a dense SMOKE config
    with sliding_window = 8, in float32: decoding far past the window
    through the ring cache gives the reference's logits, and stays within
    the reference's 3e-2 of a full forward restricted to the window."""
    jcfg = dataclasses.replace(J_SMOKE["qwen1.5-0.5b"], sliding_window=8,
                               dtype="float32")
    tcfg = _port_cfg(jcfg)
    jparams, port = lm_pair(jcfg, seed=1)
    b, total = 1, 40
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (b, total)).astype(np.int32)
    full = t_forward(port, tcfg, tokens=_t(toks)).logits
    # ring cache sized to the window (s_max > window would use the linear path)
    tc = t_init_cache(tcfg, b, jcfg.sliding_window, device="cpu")
    jc = j_init_cache(jcfg, b, jcfg.sliding_window)
    to = t_forward(port, tcfg, tokens=_t(toks[:, :16]), cache=tc, cache_len=0)
    jo = j_forward(jparams, jcfg, tokens=jnp.array(toks[:, :16]), cache=jc, cache_len=0)
    worst = 0.0
    for j in range(16, total):
        to = t_forward(port, tcfg, tokens=_t(toks[:, j:j + 1]), cache=to.cache,
                       cache_len=j)
        jo = j_forward(jparams, jcfg, tokens=jnp.array(toks[:, j:j + 1]),
                       cache=jo.cache, cache_len=j)
        np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                                   rtol=1e-4, atol=1e-4)
        worst = max(worst, _max_rel(full[:, j].numpy(), to.logits[:, 0].numpy()))
    assert worst < 3e-2, worst


def test_init_params_shapes_and_seed():
    cfg = tconfigs.get_config("qwen1.5-0.5b", smoke=True)
    a = tmodel.init_params(cfg, seed=3, device="cpu")
    b = tmodel.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not any(p.requires_grad for p in a.parameters())
    # the reference's analytic count leaves out the final norm
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count() + cfg.d_model
    assert a.embed.dtype == torch.bfloat16 and not hasattr(a, "lm_head")
    out = a(tokens=torch.zeros((1, 5), dtype=torch.long))
    assert out.logits.shape == (1, 5, cfg.vocab) and out.logits.dtype == torch.float32
