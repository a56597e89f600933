"""Port parity of the flash-attention plain version: `ref.flash_attention_ref`
(and `ops.flash_attention` on CPU tensors, which dispatches to it) against
the reference's Pallas kernel in interpret mode and its XLA flash path
`_sdpa_flash`, on the same numpy-seeded inputs.

Tolerance: rtol = atol = 1e-4, the reference's own for its kernel against
the dense oracle (tests/test_kernels.py); both sides accumulate in float32
in different orders.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 1e-4

# tests/test_kernels.py's five shapes
SHAPES = [(2, 64, 64, 4, 2, 32, True, 0),
          (1, 128, 128, 8, 8, 64, True, 0),
          (2, 64, 64, 4, 4, 32, False, 0),
          (2, 64, 64, 4, 2, 32, True, 24),
          (1, 32, 128, 4, 2, 32, True, 0)]


def _qkv(b, s, t, h, kv, d, seed=0, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, t, kv, d)).astype(np.float32),
            rng.normal(size=(b, t, kv, d if dv is None else dv)).astype(np.float32))


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window", SHAPES)
def test_plain_version_matches_interpret_mode_kernel(b, s, t, h, kv, d, causal, window):
    q, k, v = _qkv(b, s, t, h, kv, d)
    want = jops.flash_attention(jnp.array(q), jnp.array(k), jnp.array(v),
                                causal=causal, window=window, q_offset=t - s,
                                written_upto=t, interpret=True)
    got = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window, q_offset=t - s, written_upto=t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# the widths the new architectures bring (b, s, t, h, kv, dk, dv, causal,
# window, q_offset, written_upto): deepseek-v3's SMOKE MLA (nope 16 + rope 8,
# v 16; heads share no kv head), a cached prefill into a part-written cache,
# and hubert-xlarge's head width 80, bidirectional
WIDE_PAIRS = [(2, 40, 64, 4, 4, 24, 16, True, 0, 24, 64),
              (1, 24, 96, 4, 4, 24, 16, True, 0, 0, 24),
              (2, 48, 48, 4, 4, 80, 80, False, 0, 0, None),
              (1, 32, 128, 4, 2, 80, 80, True, 40, 96, 128)]


@pytest.mark.parametrize("b,s,t,h,kv,dk,dv,causal,window,q_offset,written_upto",
                         WIDE_PAIRS)
def test_plain_version_matches_interpret_mode_kernel_at_dk_dv(b, s, t, h, kv, dk, dv, causal,
                                                              window, q_offset,
                                                              written_upto):
    """v narrower than q and k (the output takes v's width, the scale q's)
    and a head width off the kernels' 64-column grid, against the Pallas
    kernel in interpret mode."""
    q, k, v = _qkv(b, s, t, h, kv, dk, seed=dk + s, dv=dv)
    kw = dict(causal=causal, window=window, q_offset=q_offset, written_upto=written_upto)
    want = jops.flash_attention(jnp.array(q), jnp.array(k), jnp.array(v), interpret=True,
                                **kw)
    got = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # ops on CPU tensors is the plain version, and (Dk, Dv) is a built pair
    assert torch.equal(tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                            torch.from_numpy(v), **kw), got)
    assert (dk, dv) in tops.FLASH_HEAD_DIMS


@pytest.mark.parametrize("q_offset,written_upto,window,chunk", [
    (40, 70, 0, 16),      # a cached prefill whose cache is part written
    (0, 33, 0, 32),       # prefill at cache_len 0: keys past the prompt masked
    (17, 90, 24, 16),     # sliding window against an offset
    (100, 128, 0, 64),    # every row sees every key up to written_upto
    (0, 0, 0, 32),        # nothing written: every row returns 0
])
def test_plain_version_matches_sdpa_flash(q_offset, written_upto, window, chunk):
    b, s, t, h, kv, d = 2, 24, 128, 4, 2, 16
    q, k, v = _qkv(b, s, t, h, kv, d, seed=3)
    cfg = dataclasses.replace(SMOKE_ARCHS["minitron-8b"], sliding_window=window)
    want = JL._sdpa_flash(jnp.array(q), jnp.array(k), jnp.array(v), q_offset, cfg,
                          written_upto=written_upto, chunk=chunk)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tref.flash_attention_ref(tq, tk, tv, causal=True, window=window,
                                   q_offset=q_offset, written_upto=written_upto,
                                   chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if written_upto == 0:
        assert not got.abs().any()
    # a different chunking (and a ragged last chunk) is the same function
    other = tref.flash_attention_ref(tq, tk, tv, causal=True, window=window,
                                     q_offset=q_offset, written_upto=written_upto,
                                     chunk=48)
    np.testing.assert_allclose(other.numpy(), got.numpy(), rtol=TOL, atol=TOL)


def test_ops_dispatches_cpu_tensors_to_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 32, 96, 4, 1, 16, seed=5))
    tops.reset_launches()
    got = tops.flash_attention(q, k, v, causal=True, q_offset=64, written_upto=90)
    want = tref.flash_attention_ref(q, k, v, causal=True, q_offset=64,
                                    written_upto=90)
    assert torch.equal(got, want)
    assert tops.LAUNCHES["flash_attention"] == 0
    # bf16 in, bf16 out; the math is float32 inside
    got16 = tops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert got16.dtype == torch.bfloat16 and got16.shape == q.shape


# The CUDA kernel's numerics for bf16 at D 64 / 80 / 128
# (csrc/flash_attention_wgmma.cu), emulated in plain torch: K / V tiles of
# the kernel's width, logits and the online softmax in float32 as the
# reference keeps them, and p . V with p cut into `parts` bf16 terms (p1 =
# bf16(p), p2 = bf16(p - p1), ...) against bf16 V, summed in float32; the
# output is rounded to bf16.  parts=None keeps the float32 p.  With
# `ksteps`, rows are held as the kernel's shared-memory tiles, 64-column
# parts zero past the row's width (TMA's fill), S is summed over `ksteps`
# products of 16 columns, and p . V reads the first `pv_n` columns of the
# V parts (wgmma's n).  The check
# is chip_smoke.py's: within one bf16 rounding of the float32 plain
# version fed the same bf16 inputs, |got - want| <= 2^-8 |want| + 1e-6.
BF16_REL, F32_FLOOR = 2.0 ** -8, 1e-6
GQA_D128 = (1, 256, 512, 8, 2, 128, True, 0)


def _kernel_tile(d):
    return 128 if d <= 80 else 64


def _parts(a):
    """a's last dim as the kernel's 64-column parts, zero past its width."""
    return torch.nn.functional.pad(a, (0, -a.shape[-1] % 64))


def _flash_bf16_emulation(q, k, v, parts, *, causal, window, q_offset,
                          written_upto, round_out=True, ksteps=None, pv_n=None):
    b, s, h, dd = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    bk = _kernel_tile(dd)
    qg = q.reshape(b, s, kvh, h // kvh, dd).float()
    q_pos = q_offset + torch.arange(s)
    m = torch.full((b, kvh, h // kvh, s), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, h // kvh, s, dv if pv_n is None else pv_n))
    for j in range(0, t, bk):
        kb, vb = k[:, j:j + bk].float(), v[:, j:j + bk].float()
        if ksteps is None:
            logits = torch.einsum("bskgd,btkd->bkgst", qg, kb)
        else:
            qp, kp = _parts(qg), _parts(kb)
            logits = 0.0
            for kk in range(16 * ksteps)[::16]:
                logits = logits + torch.einsum("bskgd,btkd->bkgst", qp[..., kk:kk + 16],
                                               kp[..., kk:kk + 16])
        if pv_n is not None:
            vb = _parts(vb)[..., :pv_n]
        logits = logits / dd ** 0.5
        k_pos = j + torch.arange(kb.shape[1])
        ok = (k_pos[None, :] < written_upto).expand(s, -1).clone()
        if causal:
            ok &= k_pos[None, :] <= q_pos[:, None]
        if window:
            ok &= k_pos[None, :] > q_pos[:, None] - window
        logits = logits.masked_fill(~ok, float("-inf"))
        m_new = torch.maximum(m, logits.amax(-1))
        shift = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(logits - shift[..., None]).masked_fill(~ok, 0.0)
        rescale = torch.where(torch.isfinite(m), torch.exp(m - shift), torch.zeros_like(m))
        l = l * rescale + p.sum(-1)
        if parts is None:
            pv = torch.einsum("bkgst,btkd->bkgsd", p, vb)
        else:
            pv, rest = 0.0, p
            for _ in range(parts):
                term = rest.bfloat16().float()
                pv = pv + torch.einsum("bkgst,btkd->bkgsd", term, vb)
                rest = rest - term
        acc = acc * rescale[..., None] + pv
        m = m_new
    out = (acc[..., :dv] / torch.clamp_min(l, 1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    out = out.reshape(b, s, h, dv)
    return out.bfloat16() if round_out else out


def _bf16_case(shape, dv=None):
    b, s, t, h, kv, d, causal, window = shape
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(b, s, t, h, kv, d, dv=dv))
    kw = dict(causal=causal, window=window, q_offset=t - s, written_upto=t)
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    chunk=_kernel_tile(d), **kw)
    return q, k, v, kw, want


def _ratio(got, want):
    return float(((got.float() - want).abs() / (BF16_REL * want.abs() + F32_FLOOR)).max())


@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window", SHAPES + [GQA_D128])
def test_bf16_kernel_numerics_stay_within_one_bf16_rounding(b, s, t, h, kv, d,
                                                           causal, window):
    """Three bf16 parts of p (the kernel's design) at tests/test_kernels.py's
    five shapes and a GQA D 128 one."""
    q, k, v, kw, want = _bf16_case((b, s, t, h, kv, d, causal, window))
    got = _flash_bf16_emulation(q, k, v, 3, **kw)
    assert got.dtype == torch.bfloat16
    assert _ratio(got, want) <= 1.0


@pytest.mark.parametrize("shape", [SHAPES[1], GQA_D128])
def test_a_single_bf16_p_exceeds_one_bf16_rounding(shape):
    """p rounded once to bf16 errs by 2^-9 of each term: far outside the
    check, so p has to be split."""
    q, k, v, kw, want = _bf16_case(shape)
    assert _ratio(_flash_bf16_emulation(q, k, v, 1, **kw), want) > 10.0


def test_two_bf16_parts_of_p_err_above_the_floor_on_short_causal_rows():
    """Two parts leave 2^-18 of each term: on the first rows of a causal
    prefill (few keys, no averaging) that is several times the check's 1e-6
    floor, which an output near 0 must meet.  Three parts hold p exactly:
    their float32 sum is p, for every p the softmax makes above 1e-30 (below
    that, the third part would be a bf16 subnormal; such a p adds nothing
    to a row whose largest p is 1)."""
    q, k, v, kw, _ = _bf16_case(SHAPES[0])
    exact = _flash_bf16_emulation(q, k, v, None, round_out=False, **kw)
    two = _flash_bf16_emulation(q, k, v, 2, round_out=False, **kw)
    assert float((two - exact)[:, :8].abs().max()) > 2 * F32_FLOOR
    rng = np.random.default_rng(7)
    p = torch.exp(-torch.from_numpy(rng.exponential(8.0, 200_000).astype(np.float32)))
    p = p[p > 1e-30]
    p1 = p.bfloat16().float()
    p2 = (p - p1).bfloat16().float()
    p3 = (p - p1 - p2).bfloat16().float()
    assert torch.equal(p1 + p2 + p3, p)
    assert not torch.equal(p1 + p2, p)


# deepseek-v3's MLA prefill widths on the wgmma kernel: q / k 192 = nope 128
# + rope 64, v 128, the kernel's 64-key tiles; causal with S and T off the
# tile, and a window
MLA_BF16 = [(1, 200, 333, 4, 4, 192, True, 0), (2, 130, 130, 2, 2, 192, True, 0),
            (1, 96, 256, 4, 4, 192, True, 64)]


@pytest.mark.parametrize("shape", MLA_BF16)
def test_bf16_kernel_numerics_at_dk_192_dv_128(shape):
    """The p split at (Dk, Dv) = (192, 128): three parts within one bf16
    rounding of the float32 plain version, one part far outside it."""
    q, k, v, kw, want = _bf16_case(shape, dv=128)
    assert want.shape[-1] == 128
    got = _flash_bf16_emulation(q, k, v, 3, **kw)
    assert got.shape == want.shape
    assert _ratio(got, want) <= 1.0
    assert _ratio(_flash_bf16_emulation(q, k, v, 1, **kw), want) > 10.0


# hubert-xlarge's (80, 80) on the wgmma kernel: q, k and v rows as two
# 64-column parts, columns 80-127 zero; S over 5 k-steps (four in part 0,
# one in part 1), p . V by n80 over the two V parts, 128-key tiles; full
# (hubert's encoder) and causal masks, S and T off the tile
WIDTH80_BF16 = [(2, 48, 48, 4, 4, 80, False, 0), (1, 130, 200, 4, 2, 80, False, 0),
                (1, 130, 200, 4, 2, 80, True, 0), (1, 96, 256, 2, 2, 80, True, 64)]


@pytest.mark.parametrize("shape", WIDTH80_BF16)
def test_bf16_kernel_numerics_at_dk_dv_80(shape):
    """Three bf16 parts of p over the padded tiles within one bf16 rounding
    (|got - want| <= 2^-8 |want| + 1e-6) of the float32 plain version and
    of the JAX Pallas kernel in interpret mode, fed the same bf16 values as
    float32; one part far outside it."""
    q, k, v, kw, want = _bf16_case(shape, dv=80)
    got = _flash_bf16_emulation(q, k, v, 3, ksteps=5, pv_n=80, **kw)
    assert got.shape == want.shape and _ratio(got, want) <= 1.0
    jw = jops.flash_attention(*(jnp.array(a.float().numpy()) for a in (q, k, v)),
                              interpret=True, **kw)
    assert _ratio(got, torch.from_numpy(np.array(jw))) <= 1.0
    assert _ratio(_flash_bf16_emulation(q, k, v, 1, ksteps=5, pv_n=80, **kw), want) > 10.0


@pytest.mark.parametrize("shape", WIDTH80_BF16[1:3])
def test_zero_columns_past_80_add_nothing(shape):
    """The kernel stops S at 5 k-steps and p . V at n80: 8 k-steps over both
    parts (48 zero columns more) and n128 with 48 columns dropped give the
    same output: the extra k-steps add exact zeros to S (bit for bit), and
    n128 sums the same products in another order (float32 rounding: 1e-5
    relative, 1e-6 absolute, the check's floor)."""
    q, k, v, kw, _ = _bf16_case(shape, dv=80)
    five = _flash_bf16_emulation(q, k, v, 3, ksteps=5, pv_n=80, round_out=False, **kw)
    eight = _flash_bf16_emulation(q, k, v, 3, ksteps=8, pv_n=80, round_out=False, **kw)
    assert torch.equal(eight, five)
    n128 = _flash_bf16_emulation(q, k, v, 3, ksteps=8, pv_n=128, round_out=False, **kw)
    plain = _flash_bf16_emulation(q, k, v, 3, round_out=False, **kw)
    for other in (n128, plain):
        np.testing.assert_allclose(other.numpy(), five.numpy(), rtol=1e-5, atol=F32_FLOOR)
