"""Port parity, traces: repro_torch.core.trace is a numpy copy of
repro.core.trace and must give bitwise-identical arrays for the same seed,
so the port and the reference replay one and the same workload."""

import numpy as np
import pytest

from repro.core import trace as jtrace
from repro_torch.core import trace as ttrace


@pytest.mark.parametrize("name", sorted(jtrace.TINY_TRACE_KWARGS))
def test_traces_bitwise_identical(name):
    kw = jtrace.TINY_TRACE_KWARGS[name]
    for seed in (0, 5):
        want = jtrace.build_trace(name, **kw, seed=seed)
        got = ttrace.build_trace(ttrace.TraceSpec(name, kw), seed=seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("gen", ["sift_like", "amazon_like"])
def test_slice_generators_bitwise_identical(gen):
    kw = {"n": 1500, "d": 24, "t": 700}
    for seed in (0, 1):
        want = getattr(jtrace, gen)(**kw, seed=seed)
        got = getattr(ttrace, gen)(**kw, seed=seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_rolling_events_and_registry_match():
    kw = jtrace.TINY_TRACE_KWARGS["rolling_catalog"]
    for (ts, ti, tr), (js, ji, jr) in zip(ttrace.rolling_catalog_events(**kw),
                                          jtrace.rolling_catalog_events(**kw)):
        assert ts == js
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tr, jr)
    assert ttrace.registered_traces() == jtrace.registered_traces()
    with pytest.raises(ValueError, match="unknown trace scenario"):
        ttrace.build_trace("nope")
