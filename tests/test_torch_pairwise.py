"""Port parity, `pairwise_l2`'s batched form and launch plan, on the CPU.

The CUDA designs run only on the card (chip_smoke.py holds each against
the plain version there at the main path's shapes).  Here: the batched
plain version is bitwise the stack of per-pair plain calls, the PQ tables
built through it stay within tolerance of the JAX reference's
`_pq_adc_lut_jit`, encoding in row blocks changes no code, and the plan
picks each design at the shapes the main path gives it.  Tolerances:
rtol 1e-5, atol 1e-5 x the distance scale (another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index.pq import _pq_adc_lut_jit
from repro_torch.index import pq as tpq
from repro_torch.index.pq import PQCodec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL = 1e-5


@pytest.mark.parametrize("m,b,c,dsub", [(8, 64, 256, 16), (8, 8, 256, 16), (4, 5, 100, 6),
                                        (3, 40, 33, 32), (1, 7, 9, 4)])
def test_batched_plain_is_bitwise_the_stack_of_pairs(m, b, c, dsub):
    rng = np.random.default_rng(m * 100 + b)
    q = torch.from_numpy(rng.normal(size=(b, m * dsub)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(m, c, dsub)).astype(np.float32))
    view = q.view(b, m, dsub).transpose(0, 1)      # (m, b, dsub), strided rows
    got = tops.pairwise_l2_batched(view, x)
    assert got.shape == (b, m, c)
    want = torch.stack([tref.pairwise_l2_ref(q[:, i * dsub:(i + 1) * dsub].contiguous(), x[i])
                        for i in range(m)], dim=1)
    assert torch.equal(got, want)
    assert torch.equal(tref.pairwise_l2_batched_ref(view.contiguous(), x), want)


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_adc_lut_matches_the_reference_lut(m, b):
    rng = np.random.default_rng(b + m)
    d = 32
    books = rng.normal(size=(m, 256, d // m)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    got = PQCodec(torch.from_numpy(books)).adc_lut(torch.from_numpy(q)).numpy()
    want = np.asarray(_pq_adc_lut_jit(jnp.array(q), jnp.array(books)))
    assert got.shape == want.shape == (b, m, 256)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5 * 4.0 * d)


def test_encode_in_row_blocks_changes_no_code(monkeypatch):
    rng = np.random.default_rng(3)
    books = torch.from_numpy(rng.normal(size=(4, 16, 3)).astype(np.float32))
    data = torch.from_numpy(rng.normal(size=(1000, 12)).astype(np.float32))
    codec = PQCodec(books)
    whole = codec.encode(data)
    want = torch.stack([torch.argmin(tref.pairwise_l2_ref(data[:, i * 3:(i + 1) * 3].contiguous(),
                                                          books[i]), dim=1)
                        for i in range(4)], dim=1).to(torch.uint8)
    assert torch.equal(whole, want)
    monkeypatch.setattr(tpq, "ENCODE_ROWS", 77)
    assert torch.equal(codec.encode(data), whole)
    assert codec.encode(data[:0]).shape == (0, 4)


# the main path's shapes (Q, N, D, M) and the design each takes: the
# cached-row scan, the coarse quantizer, the PQ tables, topk_l2's sample
# bound, the semantic tier's exact scan, k-means' assignment, and the
# calibration's sample bound
@pytest.mark.parametrize("nq,n,d,m,want", [
    (64, 864, 128, 1, ("tile32", 0, 54)),
    (8, 864, 128, 1, ("skinny", 8, 4)),
    (64, 256, 128, 1, ("tile32", 0, 16)),
    (8, 256, 128, 1, ("skinny", 8, 1)),
    (64, 256, 16, 8, ("tile32", 0, 128)),
    (8, 256, 16, 8, ("tile32", 0, 64)),
    (64, 16384, 128, 1, ("tile64", 0, 256)),
    (8, 16384, 128, 1, ("skinny", 8, 64)),
    (64, 16384, 1024, 1, ("tile64", 0, 256)),
    (1, 16384, 1024, 1, ("skinny", 1, 64)),
    (1, 1_000_000, 1024, 1, ("skinny", 1, 132)),
    (8, 1_000_000, 1024, 1, ("skinny", 8, 132)),
    (1_000_000, 256, 128, 1, ("tile64", 0, 62500)),
    (512, 16384, 1024, 1, ("tile64", 0, 2048)),
    (5, 1000, 20, 1, ("skinny", 8, 4)),
    (16, 100, 4096, 1, ("tile32", 0, 4)),     # 16 queries of 4096 do not fit
    (17, 300, 64, 1, ("tile32", 0, 10))])
def test_pairwise_l2_plan_at_the_main_path_shapes(nq, n, d, m, want):
    assert tops.pairwise_l2_plan(nq, n, d, m) == want


def test_pairwise_l2_plan_needs_16_byte_rows_for_the_skinny_design():
    assert tops.pairwise_l2_plan(8, 3000, 1024, 1, streamable=False)[0] == "tile32"
    assert tops.pairwise_l2_plan(8, 256, 16, 1, streamable=False) == ("tile32", 0, 8)
    assert tops.pairwise_l2_plan(8, 3000, 1022, 1)[0] == "tile32"
    assert tops.pairwise_l2_skinny_smem_bytes_host(16, 1024) <= tops.SMEM_LIMIT
    assert tops.pairwise_l2_skinny_smem_bytes_host(16, 4096) > tops.SMEM_LIMIT
    # the rings start on 16 bytes after the queries and their norms
    for qm in (1, 2, 4, 8, 16):
        ring = 4 * 8 * 2 * 32 * 68
        assert (tops.pairwise_l2_skinny_smem_bytes_host(qm, 100) - ring) % 16 == 0
