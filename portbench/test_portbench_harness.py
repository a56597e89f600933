"""CPU tests of the benchmark's harness: cells found by name, generators that
repeat from the seed, the rooflines' counts, the result line's shape, and
the guard against JAX modules."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import bench, cost, reference, run, tracing, traffic

BENCH = bench.load_json(bench.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = bench.Spec(cell)
    assert spec.workload["name"] == cell
    assert spec.config["name"] == spec.workload["config"]
    assert spec.config_entry["file"].startswith("portbench/configs/")
    for group in (False, True):
        for m in spec.metrics(group):
            assert callable(bench.reader(m["name"]))
    names = {m["name"] for m in spec.metrics(False)}
    assert "setup_s" in names and len(names) >= 2 and spec.metrics(True)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        bench.Spec("no_such.cell")


def test_metrics_follow_their_workloads():
    assert [m["name"] for m in bench.Spec("sift1m_flat.poisson").metrics(False)] == [
        "latency_p95_ms", "setup_s"]
    ivf = [m["name"] for m in bench.Spec("sift1m_ivf.batch512").metrics(True)]
    assert "ivf_scan_lists_roofline" in ivf and "l2_topk_roofline" not in ivf


@pytest.mark.parametrize("mix", ["batch512", "poisson", "drift512"])
def test_traffic_repeats_from_the_seed(mix):
    spec = bench.load_json(bench.HERE / "mixes" / f"{mix}.json")
    spec["max_requests"] = 5000
    if "rate_rps" in spec["arrivals"]:
        spec["arrivals"]["rate_rps"] = 2000.0
    conf = {"n": 2000, "d": 16, "distribution": "uniform01", "seed": 0}
    seed = 2 ** 33 + 7
    cat = traffic.make_catalog(conf, "cpu")
    assert torch.equal(cat, traffic.make_catalog(conf, "cpu"))
    assert not torch.equal(cat, traffic.make_catalog(dict(conf, seed=1), "cpu"))
    t0, t1, t2 = (traffic.make_traffic(spec, cat, s, 1.0) for s in (seed, seed, seed + 1))
    assert np.array_equal(t0.ids, t1.ids) and not np.array_equal(t0.ids, t2.ids)
    assert t0.ids.min() >= 0 and t0.ids.max() < conf["n"]
    if t0.due_s is not None:
        assert np.array_equal(t0.due_s, t1.due_s)
        assert np.all(np.diff(t0.due_s) >= 0) and t0.due_s[-1] < 1.0
        assert abs(t0.due_s.shape[0] - 2000) < 200
    else:
        assert t0.ids.shape[0] == 5000


def test_drift_moves_the_hot_cluster():
    pop = {"kind": "cluster_drift", "clusters": 10, "sigma": 0.5, "zipf_a": 0.9, "walk_seed": 0}
    cat = traffic.make_catalog({"n": 3000, "d": 8, "distribution": "uniform01", "seed": 3},
                               "cpu")
    ids = bench.plugin("popularity", "cluster_drift").draw(cat, 20000, pop, 3,
                                                           chunk=4096).numpy()
    first = np.bincount(ids[:2000], minlength=3000)
    last = np.bincount(ids[-2000:], minlength=3000)
    assert np.argmax(first) != np.argmax(last)
    irm = bench.plugin("popularity", "irm_barycentric").draw(cat, 20000, {"zipf_a": 0.9},
                                                             3).numpy()
    counts = np.sort(np.bincount(irm, minlength=3000))[::-1]
    assert counts[0] > 10 * np.median(counts)


def test_work_formulas_by_hand():
    w = cost.l2_topk(512, 1_000_000, 128, 64)
    assert w.flops == 2 * 512 * 1_000_000 * 128
    assert w.bytes == 4 * (1_000_000 * 128 + 512 * 128) + 8 * 512 * 64
    t, kind = cost.bound_s(w)
    assert kind == "operations" and t == pytest.approx(w.flops / 165e12)
    w = cost.ivf_scan_lists(2, 2, 4, 1, nlist=3, nvalid=10, ndistinct=7)
    assert w.flops == 80 and w.bytes == 4 * (7 * 5 + 2 * 2 + 3 + 2 * 4) + 16
    assert cost.bound_s(w) == (w.bytes / 3.35e12, "bytes")
    # one yardstick: the same products counted alike by both kernels
    assert cost.ivf_scan_lists(512, 1, 128, 64, nlist=1, nvalid=512 * 1000,
                               ndistinct=1000).flops == cost.l2_topk(512, 1000, 128, 64).flops


def test_roofline_reader_counts_the_probed_lists():
    # two lists, centroids at 0 and 10 on one axis; a batch of three queries
    # near list 0 probing one list: 3 * len(list 0) slots, one distinct list
    cents = torch.tensor([[0.0, 0.0], [10.0, 0.0]])
    system = type("S", (), {"ivf": {"centroids": cents, "nprobe": 1,
                                    "lens": np.array([5, 9])},
                            "cfg": {"c_remote": 2}})()
    q = np.array([[0.1, 0.0], [0.2, 0.0], [1.0, 1.0]], np.float32)
    trace = tracing.Trace(1, 1.0, [("void ivf_scan_lists_kernel<true>(float)", 0.0, 2.0),
                                   ("void at::native::sort", 2.0, 3.0)], [])
    ctx = run.Ctx(system=system, trace=trace, trace_records=[(0, 0, 3, 0.0, q)])
    w = cost.ivf_scan_lists(3, 1, 2, 2, nlist=2, nvalid=15, ndistinct=5)
    want = 100.0 * cost.bound_s(w)[0] / 2e-6
    assert bench.reader("ivf_scan_lists_roofline")(ctx) == pytest.approx(want)
    assert bench.reader("kernel_device_ms.sat")(ctx) == pytest.approx(2e-3)
    assert bench.reader("torch_device_ms.sat")(ctx) == pytest.approx(1e-3)
    assert bench.reader("l2_topk_roofline")(ctx) is None


def test_traffic_kinds_found_by_name():
    cat = traffic.make_catalog({"n": 64, "d": 4, "distribution": "uniform01", "seed": 0},
                               "cpu")
    for group, kind in (("catalogs", "uniform01"), ("popularity", "irm_barycentric"),
                        ("popularity", "cluster_drift"), ("arrivals", "closed"),
                        ("arrivals", "poisson")):
        assert bench.plugin(group, kind) is bench.plugin(group, kind)
    mix = {"popularity": {"kind": "no_such_kind"},
           "arrivals": {"kind": "closed", "batch": 4}, "max_requests": 8}
    with pytest.raises(ValueError, match="no_such_kind"):
        traffic.make_traffic(mix, cat, 1, 1.0)
    with pytest.raises(ValueError, match="no_such_arrivals"):
        traffic.make_traffic(dict(mix, arrivals={"kind": "no_such_arrivals"}), cat, 1, 1.0)
    with pytest.raises(ValueError):
        traffic.make_catalog({"n": 4, "d": 2, "distribution": "normal", "seed": 0}, "cpu")


@pytest.mark.parametrize("within", [6, 750])
def test_picked_steps_chain_to_the_start(within):
    for seed in (1, 2 ** 33 + 3):
        picked = run._picked_steps(seed, {"steps": 4}, within)
        assert len(picked) == 4 and {0, 1} <= picked and max(picked) < within
        assert all(s - 1 in picked or s + 1 in picked for s in picked)
    assert run._picked_steps(1, {"steps": 4}, 750) == run._picked_steps(1, {"steps": 4}, 750)


def test_reference_marks_near_ties():
    # four rows on a line; a query at 0: rows 1 and 2 at squared distances
    # 1 and 1 + 1e-9 tie at k = 1, rows 1 and 3 at 1 and 4 do not
    rows = torch.tensor([[5.0, 0.0], [1.0, 0.0], [0.0, 1.0 + 5e-10], [2.0, 0.0]])
    q = torch.zeros(1, 2)
    d, i, gap = reference.nearest(q, rows, 1)
    assert i.tolist() == [[1]] and gap.item() < 1e-8
    d, i, gap = reference.nearest(q, rows[[0, 1, 3]], 1)
    assert i.tolist() == [[1]] and gap.item() == pytest.approx(3.0)
    d, i, gap = reference.nearest(q, rows[:1], 1)
    assert gap.item() == float("inf")


def test_trace_union_and_gaps():
    t = tracing.Trace(2, 1e-5, [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0)],
                      [("aten::sort", 2.5, 5.5), ("step", 0.0, 9.0)])
    assert t.union() == [(0.0, 3.0), (5.0, 6.0)]
    assert t.busy_s == pytest.approx(4e-6)
    assert t.idle_gaps() == [["aten::sort", pytest.approx(2e-6)]]
    assert t.device_ops()[0] == ["a", pytest.approx(2e-6)]


@pytest.mark.parametrize("cell,trace", [("sift1m_ivf.batch512", 0), ("sift1m_flat.poisson", 1)])
def test_result_line_shape(cell, trace, small):
    spec = small(cell)
    res = run.execute(spec, 2 ** 31 + 11, 0.2, bool(trace), torch.device("cpu"),
                      time.perf_counter())
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name] and np.isfinite(m["value"])
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    else:
        assert set(res["metrics"]) == {m["name"] for m in spec.metrics(False)}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_main_refuses_without_the_cards(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "sift1m_flat.batch512", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["repro_torch.core.policy", "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "jax._src", "repro_torch"]) == ["jax", "repro"]


def test_nothing_loads_jax_or_the_jax_package():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(bench.ROOT)!r}, {str(bench.ROOT / 'src')!r}]\n"
        "from portbench import run, bench, control, sweep, reference, traffic, tracing, cost\n"
        "from portbench.systems import acai\n"
        "for m in bench.load_json(bench.ROOT / 'BENCHMARK.json')['per_layer']"
        " + bench.load_json(bench.ROOT / 'BENCHMARK.json')['end_to_end']:\n"
        "    bench.reader(m['name'])\n"
        "import repro_torch.core.policy, repro_torch.index.ivf, repro_torch.index.exact\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro', 'benchmarks'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
