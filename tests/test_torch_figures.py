"""Port parity of the paper's figure grids: `repro_torch.experiments`'
fig1-fig8 registrations, summaries and named-grid entry point against
`benchmarks.experiments`.

Every grid's fields and spec list (at a fixed c_f, both sizes) equal the
reference's; each summary gives the reference's lines on the same rows;
tiny replays of fig3 (two calibrations), fig6, fig7 and fig8 (sift_like or
amazon_like at n 400, d 16, 96 requests, h 16, k 4; fig6 and fig8 without
the cell each shares with the default AÇAI cell) match the reference's
`run_grid`: baselines to 1e-6 of its unrounded NAG, AÇAI, started from the
reference's state with its rounding uniforms injected, to 1e-3.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import experiments as JX
from repro.core import policy as jpolicy
from repro.core.trace import TraceSpec as JTraceSpec
from repro_torch import convert
from repro_torch import experiments as X
from repro_torch.core.trace import TraceSpec

SIZES = dict(n=400, t=96)
C_F = 0.731
GRID_FIELDS = ("name", "desc", "h", "k", "full_h", "cf_kths", "batch")


def _specs(grid, c_f, full):
    h = grid.full_h if full else grid.h
    return [s.to_dict() for s in grid.policy_specs(c_f, h, grid.k, full)]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", list(JX.GRIDS))
def test_grid_matches_reference(name, full):
    """Fields, traces and every spec of each registered grid, at both
    sizes, equal the reference's."""
    assert list(X.GRIDS) == list(JX.GRIDS)
    g, j = X.GRIDS[name], JX.GRIDS[name]
    for field in GRID_FIELDS:
        assert getattr(g, field) == getattr(j, field), field
    assert [t.to_dict() for t in g.traces] == [t.to_dict() for t in j.traces]
    assert (g.summarize is None) == (j.summarize is None)
    got = _specs(g, C_F, full)
    assert got == _specs(j, C_F, full)
    assert len(got) == len({json.dumps(s, sort_keys=True) for s in got})


def test_sweep_lists_and_aliases_match_reference():
    assert X.TRACE_ALIASES == JX.TRACE_ALIASES
    assert X.FIGURES == tuple(f"fig{i}" for i in range(1, 9))
    with pytest.raises(KeyError):
        X.run_named("fig9")
    for full in (False, True):
        for f in ("_fig2_hs", "_fig4_ks", "_fig5_hs"):
            assert getattr(X, f)(full) == getattr(JX, f)(full), (f, full)
    kw = dict(names=("sim_lru",), extra=("lru",), augmented=True)
    assert ([s.to_dict() for s in X._tuned_baselines(C_F, 30, 10, **kw)]
            == [s.to_dict() for s in JX._tuned_baselines(C_F, 30, 10, **kw)])


def _rows(grid_name, seed, **over):
    """Rows shaped as run_grid's for the grid's specs (reduced sweep) over
    two traces, with random metrics; `over` (label -> nag) pins NAGs."""
    g = JX.GRIDS[grid_name]
    rng = np.random.default_rng(seed)
    rows = []
    for tname in ("sift_like", "amazon_like"):
        for kth in g.cf_kths[:2]:
            for spec in g.policy_specs(C_F * kth, g.h, g.k, False):
                p = spec.to_dict()
                rows.append({
                    "trace": {"name": tname, "params": {}}, "policy": p, "label": spec.label,
                    "h": p.get("h", g.h), "k": p.get("k", g.k), "cf_kth": kth,
                    "nag": over.get(spec.label, round(float(rng.uniform(0.2, 0.9)), 4)),
                    "t90": int(rng.integers(0, 4000)),
                    "fetches_per_req": round(float(rng.uniform(0, 3)), 3),
                    "occupancy_mean": round(float(rng.uniform(0, 400)), 1),
                    "occupancy_p99_dev": round(float(rng.uniform(0, 0.2)), 4)})
    return rows


SUMMARIES = {
    "improvement_vs_2nd": ("fig1", lambda m: m._improvement_vs_2nd),
    "improvement_per_h": ("fig2", lambda m: m._improvement_per("h")),
    "improvement_per_cf_kth": ("fig3", lambda m: m._improvement_per("cf_kth")),
    "improvement_per_k": ("fig4", lambda m: m._improvement_per("k")),
    "spread_by_policy": ("fig5", lambda m: m._spread_by_policy),
    "fig6": ("fig6", lambda m: m._summarize_fig6),
    "fig7": ("fig7", lambda m: m._summarize_fig7),
    "fig8": ("fig8", lambda m: m._summarize_fig8),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("what", list(SUMMARIES))
def test_summary_matches_reference(what, seed):
    grid_name, fn = SUMMARIES[what]
    rows = _rows(grid_name, seed)
    one = [r for r in rows if r["trace"]["name"] == "sift_like"]
    want = list(fn(JX)(one))
    assert want and list(fn(X)(one)) == want
    # summary_lines: one run of the summary a trace, in row order
    lines = X.summary_lines(X.GRIDS[grid_name], rows)
    assert lines == [(f"{grid_name}/{t}/{label}", v)
                     for t in ("sift_like", "amazon_like")
                     for label, v in JX.GRIDS[grid_name].summarize(
                         [r for r in rows if r["trace"]["name"] == t])]


def test_fig7_tie_for_second_best_breaks_as_reference():
    """Two plain baselines share the best NAG: the first in row order names
    the augmented twin (the reference's `max`), whichever twin is better."""
    rows = [r for r in _rows("fig7", 3) if r["trace"]["name"] == "sift_like"]
    plain = [r for r in rows if r["policy"]["policy"] != "acai"
             and not r["policy"].get("augmented")]
    cls = next(r for r in plain if r["policy"]["policy"] == "cls_lru")
    top = max(r["nag"] for r in rows if r["policy"]["policy"] != "acai") + 0.01
    plain[0]["nag"] = cls["nag"] = top                    # sim_lru first, cls_lru later
    for r in rows:
        if r["policy"].get("augmented"):
            r["nag"] = top + (0.05 if r["policy"]["policy"] == "cls_lru" else 0.02)
        elif r["policy"]["policy"] == "acai":
            r["nag"] = top + 0.1
    want = list(JX._summarize_fig7(rows))
    assert want[0][1].startswith("sim_lru:")
    assert list(X._summarize_fig7(rows)) == want
    assert list(X._summarize_fig7(rows[::-1])) == list(JX._summarize_fig7(rows[::-1]))


@pytest.mark.parametrize("trace", [None, "sift", "amazon", "amazon_like", "flash_crowd",
                                   "rolling_catalog", "no_such_scenario"])
@pytest.mark.parametrize("name", ["fig1", "fig8"])
def test_run_named_resolves_traces_as_reference(monkeypatch, name, trace):
    """Aliases, a scenario outside the grid's traces (run on its default
    TraceSpec) and an unknown scenario's error, as the reference's."""
    seen = {}

    def fake(which):
        def run_grid(grid, full=False, trace_filter=None, **kw):
            seen[which] = ([t.to_dict() for t in grid.traces], trace_filter, full)
            return []
        return run_grid

    monkeypatch.setattr(JX, "run_grid", fake("ref"))
    monkeypatch.setattr(X, "run_grid", fake("port"))
    try:
        JX.run_named(name, True, trace)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            X.run_named(name, True, trace)
        assert str(got.value) == str(e)
        return
    assert X.run_named(name, True, trace) == []
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------------------
# Tiny replays against the reference's run_grid
# ---------------------------------------------------------------------------

REPLAYS = {"fig3": ("sift_like", {"cf_kths": (2, 10)}), "fig6": ("sift_like", {}),
           "fig7": ("sift_like", {}), "fig8": ("amazon_like", {})}


def _not_default_acai(spec):
    """fig6's and fig8's cells but the one each shares with the default
    AÇAI cell of fig3 and fig7 (negentropy at eta 0.05 / c_f, coupled
    rounding every step): the replays' time is the reference's compiles."""
    p = spec.params
    return not (p.get("mirror", "negentropy") == "negentropy"
                and p.get("rounding", "coupled") == "coupled"
                and p["eta"] == 0.05 / p["c_f"])


def _tiny(grid, tspec, over):
    policies = grid.policies
    if grid.name in ("fig6", "fig8"):
        over = {**over, "policies": lambda *a: [s for s in policies(*a)
                                                if _not_default_acai(s)]}
    return dataclasses.replace(grid, traces=(tspec,), h=16, k=4, **over)


def _uniforms(key, n, steps, rounding):
    """The reference's rounding draws, step by step: one split of the
    state's key a step, n uniforms (n - 1 for DepRound, 0-padded)."""
    out = np.zeros((steps, n), np.float32)
    m = n - 1 if rounding == "depround" else n
    for i in range(steps):
        key, k_round = jax.random.split(key)
        out[i, :m] = np.asarray(jax.random.uniform(k_round, (m,), dtype=jnp.float32))
    return out


def prepare(pol, spec):
    """AÇAI cells: the reference's initial state (its AcaiCache's, seed 0)
    and rounding uniforms."""
    if spec.name != "acai":
        return {}
    n = pol.cache.catalog.shape[0]
    st = jpolicy.init_state(n, jpolicy.AcaiConfig(h=pol.h), seed=0)
    pol.cache.state = convert.cache_state_from_numpy(np.asarray(st.y), np.asarray(st.x),
                                                     int(st.t), device="cpu")
    return {"uniforms": _uniforms(st.key, n, SIZES["t"] // pol.batch, pol.cfg.oma.rounding)}


def reference_run(name):
    """The reference's rows of a tiny grid, each cell's unrounded NAG
    (from the reference's own NAG curve, one a cell) and each c_f it
    calibrated, by kth."""
    tname, over = REPLAYS[name]
    jgrid = _tiny(JX.GRIDS[name], JTraceSpec(tname, {"d": 16}), over)
    finals, cfs = [], {}
    nag, calibrate = JX.B.nag, JX.calibrate_fetch_cost

    def recording_nag(gains, k, c_f):
        curve = nag(gains, k, c_f)
        finals.append(float(curve[-1]))
        return curve

    def recording_calibrate(catalog, kth, sample):
        cfs[kth] = float(calibrate(catalog, kth=kth, sample=sample))
        return cfs[kth]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JX.B, "nag", recording_nag)
        mp.setattr(JX, "calibrate_fetch_cost", recording_calibrate)
        rows = JX.run_grid(jgrid, sizes=SIZES)
    assert len(finals) == len(rows)
    return rows, finals, cfs


@pytest.mark.parametrize("name", list(REPLAYS))
def test_tiny_replay_matches_reference(name):
    jrows, finals, cfs = reference_run(name)
    tname, over = REPLAYS[name]
    grid = _tiny(X.GRIDS[name], TraceSpec(tname, {"d": 16}), over)
    rows = X.run_grid(grid, sizes=SIZES, device="cpu",
                      calibrate=lambda cat, kth: cfs[min(kth, cat.shape[0] - 1)],
                      prepare=prepare)
    assert [r["label"] for r in rows] == [r["label"] for r in jrows]
    assert len(rows) == {"fig3": 38, "fig6": 5, "fig7": 39, "fig8": 4}[name]
    for r, j, full in zip(rows, jrows, finals):
        assert r["policy"] == j["policy"] and r["trace"] == j["trace"]
        for key in ("requests", "h", "k", "cf_kth", "c_f"):
            assert r[key] == j[key], (r["label"], key)
        tol = 1e-3 if r["policy"]["policy"] == "acai" else 1e-6
        assert abs(r["nag_full"] - full) <= tol, (r["label"], r["nag_full"], full)
        if r["policy"]["policy"] != "acai":
            for key in ("hit_ratio", "local_share", "fetches_per_req", "occupancy_mean",
                        "occupancy_p99_dev", "t90"):
                assert r[key] == j[key], (r["label"], key)
    if name == "fig3":
        assert sorted({r["cf_kth"] for r in rows}) == [2, 10]
    if name == "fig8":
        # what fig8 reports: update traffic and occupancy concentration, on
        # the reference's rounding schedule step for step
        for r, j in zip(rows, jrows):
            for key in ("fetches_per_req", "occupancy_mean", "occupancy_p99_dev"):
                assert r[key] == j[key], (r["label"], key, r[key], j[key])
