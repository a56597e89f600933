"""Port parity of the Theorem IV.1 regret check: `repro_torch.regret`
against `benchmarks.regret` and `benchmarks.common` at n 400, d 32, 96
requests, h 16, k 10, horizons 48 and 96.

The c_f table (the reference's calibration sample) to 1e-6 relative, the
static allocation exactly, the static comparator's mean gain to 1e-5
relative, eta* to 1e-6 relative; AÇAI's mean gain and the psi-regret rate,
replayed one request a step from the reference's initial state with its
rounding uniforms (one split of the state's key a step), to 1e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as JC
from benchmarks import regret as JR
from repro.core import oma as joma
from repro.core import policy as jpolicy
from repro_torch import convert
from repro_torch import regret as R
from repro_torch.core import oma

N, T, H, K = 400, 96, 16, 10
HORIZONS = (48, 96)


def _sample():
    """calibrate_fetch_cost's sample rows in the reference (seed 0)."""
    return np.array(jax.random.choice(jax.random.PRNGKey(0), N, shape=(256,),
                                        replace=False))


@pytest.fixture(scope="module")
def setups():
    ref = JC.get_setup("sift", n=N, t=T)
    port = R.get_setup("sift", N, T, device="cpu", idx=_sample())
    return ref, port


@pytest.fixture(scope="module")
def ref_static(setups):
    """The reference's static comparator's mean gain at each horizon."""
    ref = setups[0]
    return {t_len: JR._static_best_gain(ref, _x_static(ref), K, ref.cf_table[50],
                                        ref.requests[:t_len]) for t_len in HORIZONS}


def _x_static(ref):
    near = ref.oracle.ids[:, 0]
    top = np.bincount(near, minlength=N).argsort()[::-1][:H]
    x = np.zeros(N, np.float32)
    x[top] = 1.0
    return x


def test_setup_and_cf_table_match_reference(setups):
    ref, port = setups
    np.testing.assert_array_equal(port.catalog, ref.catalog)
    np.testing.assert_array_equal(port.requests, ref.requests)
    assert sorted(port.cf_table) == sorted(ref.cf_table) == [2, 10, 50, 100]
    for kth, want in ref.cf_table.items():
        assert abs(port.cf_table[kth] - want) <= 1e-6 * abs(want), (kth, port.cf_table[kth], want)


def test_static_allocation_matches_reference(setups):
    ref, port = setups
    x = R.static_allocation(port, H)
    np.testing.assert_array_equal(x, _x_static(ref))
    assert x.sum() == H


@pytest.mark.parametrize("t_len", HORIZONS)
def test_static_best_gain_matches_reference(setups, ref_static, t_len):
    ref, port = setups
    c_f = ref.cf_table[50]
    want = ref_static[t_len]
    got = R._static_best_gain(port, R.static_allocation(port, H), K, c_f,
                              port.requests[:t_len])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("args", [(2.5, 6.25, 16, 400, 48), (0.7, 0.49, 100, 4000, 4000),
                                  (3.1, 9.6, 1000, 20000, 30000), (1.0, 1.0, 1, 1, 1)])
def test_theoretical_eta_matches_reference(args):
    want = joma.theoretical_eta(*args)
    assert abs(oma.theoretical_eta(*args) - want) <= 1e-6 * abs(want)


def _inject(ref, c_f):
    """inject(T): the reference's run_acai start (init_state, seed 0) and
    the uniforms its sequential replay draws, one split a request."""
    cfg = jpolicy.AcaiConfig(h=H, k=K, c_f=c_f, c_remote=64, c_local=16)
    st = jpolicy.init_state(N, cfg)
    key, us = st.key, np.empty((T, N), np.float32)
    for i in range(T):
        key, k_round = jax.random.split(key)
        us[i] = np.asarray(jax.random.uniform(k_round, (N,), dtype=jnp.float32))

    def inject(t_len):
        state = convert.cache_state_from_numpy(np.asarray(st.y), np.asarray(st.x), 0,
                                               device="cpu")
        return {"state": state, "uniforms": us[:t_len]}

    return inject


def test_acai_gain_and_regret_rates_match_reference(setups, ref_static):
    ref, port = setups
    c_f = ref.cf_table[50]
    inject = _inject(ref, c_f)
    want = {}
    for t_len in HORIZONS:
        reqs = ref.requests[:t_len]
        eta = joma.theoretical_eta(float(np.sqrt(c_f)), c_f, H, N, t_len)
        m, _ = JC.run_acai(ref, h=H, k=K, c_f=c_f, requests=reqs, eta=eta)
        got, _ = R.run_acai(port, h=H, k=K, c_f=c_f, requests=port.requests[:t_len],
                            eta=oma.theoretical_eta(float(np.sqrt(c_f)), c_f, H, N, t_len),
                            **inject(t_len))
        assert abs(got["gain"].mean() - m["gain"].mean()) <= 1e-3, t_len
        want[t_len] = (1 - 1 / np.e) * ref_static[t_len] - m["gain"].mean()
    rates = R.main(kind="sift", n=N, t=T, h=H, k=K, horizons=HORIZONS, device="cpu",
                   idx=_sample(), inject=inject)
    assert sorted(rates) == list(HORIZONS)
    for t_len in HORIZONS:
        assert abs(rates[t_len] - want[t_len]) <= 1e-3, (t_len, rates[t_len], want[t_len])


def test_cli_writes_rates_under_regret(tmp_path, monkeypatch):
    """`--out` adds the rates under "regret", keeping the file's other keys."""
    out = tmp_path / "figures.json"
    out.write_text('{"grid": "all"}')
    monkeypatch.setattr(R, "main", lambda full, kind, device: {500: 0.5, 1500: 0.25})
    assert R.cli(["--device", "cpu", "--out", str(out)]) == {500: 0.5, 1500: 0.25}
    doc = json.loads(out.read_text())
    assert doc["grid"] == "all"
    assert doc["regret"]["psi_regret_per_step"] == {"500": 0.5, "1500": 0.25}
    assert doc["regret"]["decays"] and doc["regret"]["card"] == "cpu"
    assert doc["regret"]["n"] == 4000 and doc["regret"]["h"] == 100


def test_entry_points_default_to_the_card(monkeypatch):
    """No card and no device='cpu': the regret check and the figure grids
    raise, never running quietly on the CPU."""
    from repro_torch import experiments as X

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: R.cli([]), lambda: R.main(n=N, t=T, h=H),
                 lambda: X.main(["--grid", "fig1"]), lambda: X.run_named("fig8")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
