"""Port parity of the experiment harness: `repro_torch.experiments.run_grid`
against `benchmarks.experiments.run_grid` on a tiny grid (the canonical
six policies, sift_like n 400, d 16, 96 requests, h 16, k 4, B 8), with
c_f as the reference calibrates it.  Baseline NAG to 1e-6 of the
reference's unrounded NAG; AÇAI, started
from the reference's state with its rounding uniforms injected, to 1e-3.
`--from-bench` replays a results file's rows with their own policy dicts.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import experiments as JX
from repro.core import baselines as JB
from repro.core import policy_api as JPA
from repro.core import trace as jtrace
from repro.core.costs import CostModel as JCostModel
from repro.core.costs import calibrate_fetch_cost as j_calibrate
from repro.core.trace import TraceSpec as JTraceSpec
from repro_torch import convert
from repro_torch import experiments as X
from repro_torch.core.trace import TraceSpec

SIZES = dict(n=400, t=96)


def _uniforms(key, n, steps):
    out = np.empty((steps, n), np.float32)
    for i in range(steps):
        key, k_round = jax.random.split(key)
        out[i] = np.asarray(jax.random.uniform(k_round, (n,), dtype=jnp.float32))
    return out


def prepare(pol, spec):
    """AÇAI cells: the reference's initial state and rounding uniforms."""
    if spec.name != "acai":
        return {}
    catalog = pol.cache.catalog.numpy()
    jpol = JPA.build_policy(JPA.PolicySpec.from_dict(spec.to_dict()), catalog,
                            JCostModel(c_f=pol.c_f), seed=0)
    st = jpol.cache.state
    pol.cache.state = convert.cache_state_from_numpy(np.asarray(st.y), np.asarray(st.x),
                                                     int(st.t), device="cpu")
    return {"uniforms": _uniforms(st.key, catalog.shape[0], SIZES["t"] // pol.batch)}


def j_cf(catalog, kth):
    return float(j_calibrate(jnp.asarray(catalog), kth=min(kth, catalog.shape[0] - 1),
                             sample=256))


@pytest.fixture(scope="module")
def grids():
    jgrid = JX.Grid("tiny", "tiny grid", traces=(JTraceSpec("sift_like", {"d": 16}),),
                    policies=JX._grid_experiments, h=16, k=4, batch=8)
    tgrid = X.Grid("tiny", "tiny grid", traces=(TraceSpec("sift_like", {"d": 16}),),
                   policies=X._grid_experiments, h=16, k=4, batch=8)
    jrows = JX.run_grid(jgrid, sizes=SIZES)
    # the reference's rows keep NAG to 4 digits: replay its baseline cells
    # again, as its run_grid does, for the unrounded value
    cat, reqs, _ = jtrace.build_trace(JTraceSpec("sift_like", {"d": 16}), **SIZES)
    c_f = j_cf(cat, 50)
    oracle = JB.ServerOracle(cat, reqs, kmax=128)
    full = {}
    for j in jrows[1:]:
        pol = JPA.build_policy(JPA.PolicySpec.from_dict(j["policy"]), cat,
                               JCostModel(c_f=c_f), oracle=oracle, seed=0)
        res = JPA.replay_trace(pol, reqs, np.arange(SIZES["t"]), batch=8)
        full[j["label"]] = pol.normalized_gain(res["gain"].sum(), res["requests"])
        assert round(full[j["label"]], 4) == j["nag"]
    return jrows, tgrid, full


def _check(rows, jrows, full):
    """Baselines: NAG to 1e-6 of the reference's unrounded NAG; AÇAI to
    1e-3 of its row."""
    assert [r["label"] for r in rows] == [r["label"] for r in jrows]
    for r, j in zip(rows, jrows):
        assert r["policy"] == j["policy"] and r["trace"] == j["trace"]
        if r["policy"]["policy"] == "acai":
            assert abs(r["nag_full"] - j["nag"]) <= 1e-3 + 5e-5, (r["nag_full"], j["nag"])
        else:
            assert abs(r["nag_full"] - full[r["label"]]) <= 1e-6, (
                r["label"], r["nag_full"], full[r["label"]])
        for key in ("requests", "h", "k", "cf_kth"):
            assert r[key] == j[key], key
        if r["policy"]["policy"] != "acai":
            for key in ("hit_ratio", "local_share", "fetches_per_req", "occupancy_mean", "t90"):
                assert r[key] == j[key], (r["label"], key)


def test_run_grid_matches_reference(grids):
    jrows, tgrid, full = grids
    rows = X.run_grid(tgrid, sizes=SIZES, device="cpu", calibrate=j_cf, prepare=prepare)
    assert len(rows) == 6
    _check(rows, jrows, full)
    assert rows[0]["c_f"] == jrows[0]["c_f"]


def test_from_bench_replays_each_row_with_its_own_policy(grids, tmp_path):
    """A results file in BENCH_experiments.json's form: each row's policy
    dict on its trace at the file's n and t, c_f from the acai row."""
    jrows, _, full = grids
    bench = {"n": SIZES["n"], "t": SIZES["t"], "rows": jrows}
    rows = X.from_bench(bench, device="cpu", prepare=prepare)
    _check(rows, jrows, full)
    assert [r["reference_nag"] for r in rows] == [r["nag"] for r in jrows]
    # the CLI: rows and the device into --out
    path, out = tmp_path / "bench.json", tmp_path / "out.json"
    path.write_text(json.dumps(bench))
    cli = X.main(["--from-bench", str(path), "--device", "cpu", "--out", str(out)])
    written = json.loads(out.read_text())
    assert written["device"] == "cpu" and written["card"] == "cpu"
    assert len(written["rows"]) == len(cli) == 6
    assert written["n"] == SIZES["n"] and written["traces"] == ["sift_like"]
    # baselines take no injected randomness: the CLI's rows are the same
    for r in cli:
        if r["policy"]["policy"] != "acai":
            assert abs(r["nag_full"] - full[r["label"]]) <= 1e-6


def test_from_bench_needs_an_acai_row_for_c_f(grids):
    jrows = grids[0]
    with pytest.raises(ValueError, match="no acai row"):
        X.from_bench({"n": 400, "t": 96, "rows": jrows[1:]}, device="cpu")


def test_sweep_matches_reference():
    kw = dict(k_prime=[10, 20], c_theta=[1.0, 1.5])
    got = [s.label for s in X.sweep("sim_lru", {"h": 200}, **kw)]
    assert got == [s.label for s in JX.sweep("sim_lru", {"h": 200}, **kw)]
    assert len(got) == 4


def test_bench_file_rows_parse():
    """Every row of BENCH_experiments.json resolves to a registered policy
    and scenario, and each trace has the acai row its c_f comes from."""
    bench = json.load(open(JX.BENCH_JSON))
    specs = [X.PolicySpec.from_dict(r["policy"]) for r in bench["rows"]]
    assert {s.name for s in specs} == set(X.PA.registered_policies())
    for name in bench["traces"]:
        rows = [r for r in bench["rows"] if r["trace"]["name"] == name]
        assert sum(r["policy"]["policy"] == "acai" for r in rows) == 1
        TraceSpec.from_dict(rows[0]["trace"])
