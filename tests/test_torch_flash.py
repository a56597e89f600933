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


def _qkv(b, s, t, h, kv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, t, kv, d)).astype(np.float32),
            rng.normal(size=(b, t, kv, d)).astype(np.float32))


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
