"""Port parity of the dry-run's analytic record (`repro_torch.launch.dryrun`)
against `repro.launch.dryrun`.

For every runnable cell (ten archs x four shapes) on the single- and the
multi-pod production mesh, in the baseline and the opt variant, the
record's per-device bytes of the parameters and of the cache, and its
accumulation steps, equal to the byte what the reference's
`sharded_bytes` gives over the reference's own shapes and specs.  Those
are computed in a subprocess: importing `repro.launch.dryrun` sets
`XLA_FLAGS` to 512 host devices before JAX starts, which this process
must not inherit.

The optimizer state's bytes equal the reference's, AdamW's and
Adafactor's (kept on the reference's stacked leaves,
`optimizer.param_groups`), with nothing swapped; the stacked body
vectors' share of Adafactor's is checked on its own too.

Also the AÇAI retrieval cell's provenance (the reference's
tests/test_policy_api.py::test_dryrun_records_policy_spec) and the CLI's
resumability.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.configs import ARCHS
from repro_torch.core import policy, trace
from repro_torch.core.policy_api import PolicySpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import init_params
from repro_torch.sharding import specs as S
from repro_torch.train.optimizer import init_opt, param_groups

VARIANTS = ["baseline", "opt"]

_CHILD = textwrap.dedent("""
    import json
    from functools import partial
    from repro.launch import dryrun as R   # XLA_FLAGS: 512 host devices, here only
    import jax
    from repro.configs import ARCHS, SHAPES, runnable
    from repro.models import init_cache, init_params
    from repro.sharding import specs as S
    from repro.train.optimizer import init_opt

    meshes = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}
    out = {}
    for arch, base in ARCHS.items():
        params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), base))
        opt = jax.eval_shape(partial(init_opt, base.optimizer), params)
        caches = {n: jax.eval_shape(partial(init_cache, base, s.global_batch, s.seq_len))
                  for n, s in SHAPES.items() if s.kind != "train" and runnable(base, s)[0]}
        stacked = [p for p, leaf in jax.tree_util.tree_flatten_with_path(params["body"])[0]
                   if leaf.ndim == 2]
        for variant in ("baseline", "opt"):
            for mk, ms in meshes.items():
                cfg = R.apply_variant(base, variant, mk == "multi")
                pspecs = S.param_pspecs(cfg, params, ms)
                pbytes = R.sharded_bytes(params, pspecs, ms)
                for name, shape in SHAPES.items():
                    if not runnable(cfg, shape)[0]:
                        continue
                    rec = {"params": pbytes}
                    if shape.kind == "train":
                        ospecs = S.opt_pspecs(cfg.optimizer, params, pspecs, cfg, ms)
                        rec["opt"] = R.sharded_bytes(opt, ospecs, ms)
                        rec["accum"] = R._accum_for(cfg, shape)
                        vec = 0
                        if cfg.optimizer == "adafactor":
                            for path in stacked:
                                st, sp = opt["v"]["body"], ospecs["v"]["body"]
                                for key in path:
                                    st, sp = st[key.key], sp[key.key]
                                vec += R.sharded_bytes(st, sp, ms)
                        rec["stacked_vectors"] = vec
                    else:
                        cspecs = S.cache_pspecs(cfg, caches[name], ms, mk == "multi")
                        rec["cache"] = R.sharded_bytes(caches[name], cspecs, ms)
                    out[f"{arch}|{name}|{mk}|{variant}"] = rec
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(the reference's bytes by "arch|shape|mesh|variant", the port's
    records by the same key, the port's output directories by variant);
    the port's run while the reference's subprocess computes."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _CHILD], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port, dirs = {}, {}
        for variant in VARIANTS:
            dirs[variant] = tmp_path_factory.mktemp(f"dryrun_{variant}")
            for rec in dryrun.main(["--all", "--mesh", "both", "--variant", variant,
                                    "--out", str(dirs[variant])]):
                port[f"{rec['arch']}|{rec['shape']}|{rec['mesh']}|{variant}"] = rec
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), port, dirs


def _port_stacked_vectors(arch, variant, mesh_kind) -> int:
    """Bytes a device of the port's Adafactor state of the body layers'
    1-D parameters (their groups' vr and vc)."""
    multi = mesh_kind == "multi"
    cfg = dryrun.apply_variant(ARCHS[arch], variant, multi)
    ms = production_mesh_shape(multi)
    params = dict(init_params(cfg, device="meta").named_parameters())
    groups = {k: g for k, g in param_groups(cfg, params).items()
              if g.stacked and params[g.names[0]].dim() == 1}
    state = init_opt("adafactor", params, groups)
    specs = S.opt_pspecs("adafactor", S.param_pspecs(cfg, params, ms), groups)
    return S.sharded_bytes(state["v"], specs["v"], ms)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_bytes_per_device_match_reference(records, arch, variant):
    ref, port, _ = records
    cells = [k for k in ref if k.startswith(arch + "|") and k.endswith("|" + variant)]
    assert len(cells) >= 4
    for key in cells:
        want, got = ref[key], port[key]
        assert got["status"] == "ok", key
        assert got["params_bytes_per_device"] == want["params"], key
        if "cache" in want:
            assert got["cache_bytes_per_device"] == want["cache"], key
            assert "opt_bytes_per_device" not in got
            continue
        assert got["accum"] == want["accum"], key
        assert got["opt_bytes_per_device"] == want["opt"], key
        if ARCHS[arch].optimizer == "adafactor":
            _, _, mesh_kind, _ = key.split("|")
            vec = _port_stacked_vectors(arch, variant, mesh_kind)
            assert want["stacked_vectors"] > 0 and vec == want["stacked_vectors"], key
    # the unrunnable cells are recorded as skipped, with the reference's reason
    for key, rec in port.items():
        if key.startswith(arch + "|") and key not in ref:
            assert rec["status"] == "skipped" and rec["reason"], key


def test_record_fields_and_resume(records):
    _, port, dirs = records
    rec = port["mixtral-8x22b|train_4k|multi|opt"]
    assert {"arch", "shape", "mesh", "kind", "seq_len", "global_batch", "variant",
            "params_total", "params_active", "status", "params_bytes_per_device",
            "opt_bytes_per_device", "accum", "n_devices"} <= set(rec)
    assert rec["n_devices"] == 512 and rec["accum"] == 8
    assert rec["params_total"] == ARCHS["mixtral-8x22b"].param_count()
    dec = port["qwen1.5-0.5b|decode_32k|single|baseline"]
    assert "cache_bytes_per_device" in dec and dec["n_devices"] == 256
    with open(dryrun.cell_path(str(dirs["opt"]), "mixtral-8x22b", "train_4k", "multi")) as f:
        assert json.load(f) == rec
    # a second run reads every cell back
    again = dryrun.main(["--arch", "mixtral-8x22b", "--mesh", "both", "--variant", "opt",
                         "--out", str(dirs["opt"])])
    assert again == [port[f"mixtral-8x22b|{s}|{m}|opt"] for s in
                     ("train_4k", "prefill_32k", "decode_32k", "long_500k")
                     for m in ("single", "multi")]


def test_acai_cell_records_policy_spec(tmp_path):
    """The reference's test_dryrun_records_policy_spec: policy_spec next
    to index_spec and shard_map_impl, round-tripping into an AcaiCache."""
    meta = dryrun.acai_cell_meta("single", n_catalog=1024, d=8, batch=16, k=4, h=64,
                                 eta=0.01, variant="baseline")
    assert meta["index_spec"] == {"backend": "exact"}
    assert "torch.distributed" in meta["shard_map_impl"]
    spec = PolicySpec.from_dict(meta["policy_spec"])
    assert spec.name == "acai"
    assert spec.params["h"] == 64 and spec.params["batch"] == 16
    catalog, _, _ = trace.sift_like(n=128, d=8, t=8, seed=0)
    cache = policy.AcaiCache(np.asarray(catalog), spec, device="cpu")
    assert cache.cfg.h == 64 and cache.cfg.c_f == 1.0
    # the full cell: the catalog split over the model axis
    (rec,) = dryrun.main(["--arch", "acai-retrieval", "--mesh", "multi",
                          "--out", str(tmp_path)])
    assert rec["params_bytes_per_device"] == 2 ** 27 * 128 * 4 // 16
    assert rec["n_devices"] == 512 and rec["status"] == "ok"
