"""Spawned torch.distributed worlds for the port's sharded tests, and the
work their ranks do.

`run_world(fn, shape, tmp_path, *args)` starts one process a rank of a
(data, model) = `shape` mesh (or (pod, data, model) for a 3-tuple): a gloo world on the CPU whose store is a
file under `tmp_path` (so concurrent test workers never share a port),
calls `fn(mesh, rank, *args)` in each and returns the ranks' results.  A
world that has not finished within its time limit is killed and the test
fails; a rank that raises fails it with the rank's traceback.

The rank functions live here, not in the test modules, so a rank imports
torch and the port only (never JAX: the parent computes the reference's
side and passes numpy arrays in).
"""

from __future__ import annotations

import contextlib
import io
import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import pytest

WORLD_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def host_mesh(tmp_path_factory):
    """A one-rank gloo world in the test's own process and its (1, 1) mesh,
    left at the module's end."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    store = tmp_path_factory.mktemp("store") / "s"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


def _entry(fn, rank: int, world: int, shape, store: str, out: str, args,
           fake: bool = False) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from repro_torch.launch.mesh import POD_AXES, SERVING_AXES, fake_world, make_mesh

        if fake:
            fake_world(world, rank)
        else:
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world)

        names = POD_AXES if len(shape) == 3 else SERVING_AXES
        res = ("ok", fn(make_mesh(shape, names), rank, *args))
        dist.destroy_process_group()
    except (Exception, SystemExit):  # the parent reports it
        res = ("error", traceback.format_exc())
    with open(f"{out}/rank{rank}.tmp", "wb") as f:
        pickle.dump(res, f)
    Path(f"{out}/rank{rank}.tmp").rename(f"{out}/rank{rank}.pkl")


def run_world(fn, shape, tmp_path, *args, timeout: float = WORLD_TIMEOUT_S,
              fake: bool = False) -> list:
    """With `fake`, one process only: rank 0 of a world of the mesh's size
    with no peers (`launch.mesh.fake_world`, meta tensors), its result
    alone in the list."""
    world = int(np.prod(shape))
    base = Path(tmp_path) / (f"{'fake' if fake else 'world'}_{fn.__name__}_"
                             f"{'x'.join(map(str, shape))}")
    base.mkdir(parents=True, exist_ok=False)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tuple(shape),
                                              str(base / "store"), str(base), args, fake),
                         daemon=True) for r in range(1 if fake else world)]
    world = len(procs)
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results: dict = {}
    try:
        while len(results) < world:
            for r in range(world):
                f = base / f"rank{r}.pkl"
                if r not in results and f.exists():
                    with open(f, "rb") as fh:
                        results[r] = pickle.load(fh)
                    if results[r][0] == "error":
                        raise AssertionError(f"rank {r} of the {shape} world:\n"
                                             f"{results[r][1]}")
            if len(results) == world:
                break
            dead = [r for r, p in enumerate(procs)
                    if not p.is_alive() and r not in results
                    and not (base / f"rank{r}.pkl").exists()]
            if dead:
                raise AssertionError(f"ranks {dead} of the {shape} world exited "
                                     f"({[procs[r].exitcode for r in dead]}) without a "
                                     f"result")
            if time.monotonic() > deadline:
                raise AssertionError(f"the {shape} world did not finish within "
                                     f"{timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r][1] for r in range(world)]


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------

def jobs_rank(mesh, rank, jobs) -> dict:
    """Several rank functions in one world (a world costs a torch import a
    rank): [(name, data), ...] -> {name: result}."""
    fns = {"retrieval": retrieval_rank, "budgets": budgets_rank, "replay": replay_rank,
           "slab": slab_rank, "serving": serving_rank, "churn": churn_rank,
           "moe_ep": moe_ep_rank, "moe_forward": moe_forward_rank, "tp_serve": tp_serve_rank,
           "tp_train": tp_train_rank, "two_axis": two_axis_rank,
           "seq_cache": seq_cache_rank, "moe_rows": moe_rows_rank}
    return {name: fns[name](mesh, rank, data) for name, data in jobs}

def _np(t):
    return t.detach().cpu().numpy()


def retrieval_rank(mesh, rank, data: dict) -> dict:
    """make_retrieval_step plain, at scan_chunk 50 and (given the
    reference's structures) on the sharded IVF; y gathered whole."""
    import torch

    from repro_torch import convert
    from repro_torch.core import distributed as D

    cat, y0, reqs = (torch.from_numpy(data[k]) for k in ("cat", "y0", "reqs"))
    kw = data["kw"]
    n_model = D._axis_size(mesh, "model")
    blk, yb = D.block_of(cat, mesh), D.block_of(y0, mesh)
    out = {}
    variants = {"plain": {}, "chunk": {"scan_chunk": 50}}
    if data.get("ivf") is not None:
        c, inv, nlist, nprobe = data["ivf"]
        variants["ivf"] = {"ivf": convert.sharded_ivf_from_numpy(c, inv, nlist, nprobe,
                                                                 device="cpu")}
    for name, extra in variants.items():
        step = D.make_retrieval_step(mesh, n_shard=cat.shape[0] // n_model, **kw, **extra)
        D.reset_collectives()
        y1, ans, m = step(blk, yb, reqs)
        counts = dict(D.COLLECTIVES)
        out[name] = {"y": _np(D.gather_rows(y1, mesh)), "ans": _np(ans),
                     "gain": float(m["gain"]), "counts": counts}
    return out


def two_axis_rank(mesh, rank, data: dict) -> dict:
    """The batch over two mesh axes, ("pod", "data"): make_retrieval_step
    (plain and at scan_chunk 50) with y gathered whole, and one step of
    make_step_sharded and of make_mutable_step_sharded beside the
    single-device make_step_batched / make_mutable_step on the whole
    catalog (the whole batch's metrics, in request order, and y)."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core import oma, policy

    axes = ("pod", "data")
    cat, y0, reqs = (torch.from_numpy(data[k]) for k in ("cat", "y0", "reqs"))
    n_model = D._axis_size(mesh, "model")
    blk, yb = D.block_of(cat, mesh), D.block_of(y0, mesh)
    out = {}
    for name, extra in {"plain": {}, "chunk": {"scan_chunk": 50}}.items():
        step = D.make_retrieval_step(mesh, n_shard=cat.shape[0] // n_model, **data["kw"],
                                     batch_axes=axes, **extra)
        D.reset_collectives()
        y1, ans, m = step(blk, yb, reqs)
        out[name] = {"y": _np(D.gather_rows(y1, mesh)), "ans": _np(ans),
                     "gain": float(m["gain"]), "local": float(m["served_local"]),
                     "counts": dict(D.COLLECTIVES),
                     "sites": {f"{p}:{s}": v for (p, s), v in D.COLLECTIVE_SITES.items()}}
    n, b = cat.shape[0], reqs.shape[0]
    cfg = policy.AcaiConfig(h=16, k=4, c_f=1.0, c_remote=16, c_local=8,
                            oma=oma.OMAConfig(eta=0.05, projection_topk=48))
    s0 = policy.init_state(n, cfg, device="cpu")
    fnb = policy.exact_candidate_fn_batched(cat, cfg.c_remote, cfg.c_local)
    u = torch.rand(n, generator=torch.Generator().manual_seed(3))
    sa, ma = policy.make_step_batched(cfg, fnb, b)(policy.copy_state(s0), reqs, u)
    sb = policy.CacheState(D.block_of(s0.y, mesh).clone(), D.block_of(s0.x, mesh).clone(),
                           0, s0.gen)
    D.reset_collectives()
    st, mb = D.make_step_sharded(cfg, mesh, blk, b, batch_axes=axes, top_a=48)(sb, reqs, u)
    out["step"] = {"counts": dict(D.COLLECTIVES), "y": _np(D.gather_rows(st.y, mesh)),
                   "y_ref": _np(sa.y)}
    alive = torch.ones(n, dtype=torch.bool)
    ids, dd, valid = policy.exact_mutable_candidates(reqs, s0.x, cat, alive, cfg.c_remote,
                                                     cfg.c_local)
    sm, mm = policy.make_mutable_step(cfg, b)(policy.copy_state(s0), ids, dd, valid, alive,
                                              u)
    sc, mc = D.make_mutable_step_sharded(cfg, mesh, b, batch_axes=axes, top_a=48)(
        policy.CacheState(D.block_of(s0.y, mesh).clone(), D.block_of(s0.x, mesh).clone(),
                          0, s0.gen), reqs, blk, D.block_of(alive, mesh), u)
    out["mutable"] = {"y": _np(D.gather_rows(sc.y, mesh)), "y_ref": _np(sm.y)}
    for key, (want, got) in {"step": (ma, mb), "mutable": (mm, mc)}.items():
        for f in ("gain_int", "gain_frac", "cost", "served_local"):
            out[key][f] = (_np(getattr(want, f)), _np(getattr(got, f)))
    return out


def _budget(fn, *args):
    from repro_torch.core import distributed as D

    return D.collectives_per_step(fn, *args)


def budgets_rank(mesh, rank, data: dict) -> dict:
    """Collectives a step of every sharded step on this mesh (the
    reference's tests/test_collectives.py cases)."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core import oma, policy

    n, d, b = data["n"], data["d"], 8
    cat = torch.from_numpy(data["cat"])
    cfg = policy.AcaiConfig(h=16, k=4, c_f=1.0, c_remote=16, c_local=8,
                            oma=oma.OMAConfig(eta=0.01, projection_topk=48))
    wide = policy.AcaiConfig(h=16, k=4, c_f=1.0, c_remote=48, c_local=24,
                             oma=oma.OMAConfig(eta=0.01, projection_topk=48))
    p = D._axis_size(mesh, "model")
    blk = D.block_of(cat, mesh)
    whole = policy.init_state(n, cfg, device="cpu")
    state = policy.CacheState(D.block_of(whole.y, mesh).clone(),
                              D.block_of(whole.x, mesh).clone(), 0, whole.gen)
    rs = torch.zeros((b, d))
    out = {"exact": _budget(D.make_step_sharded(cfg, mesh, blk, b), state, rs),
           "wide": _budget(D.make_step_sharded(wide, mesh, blk, b), state, rs),
           "chunk": _budget(D.make_step_sharded(cfg, mesh, blk, b, scan_chunk=64), state,
                            rs),
           "mutable": _budget(D.make_mutable_step_sharded(cfg, mesh, b), state, rs, blk,
                              torch.ones(blk.shape[0], dtype=torch.bool))}
    ivf = D.build_sharded_ivf(cat, p, nlist=8, nprobe=4, device="cpu")
    out["ivf"] = _budget(D.make_step_sharded(cfg, mesh, blk, b, ivf=ivf), state, rs)
    step = D.make_retrieval_step(mesh, n_shard=n // p, d=d, c=16, k=4, c_f=1.0, h=16,
                                 eta=0.01, top_a=32)
    out["retrieval"] = _budget(step, blk, torch.full((n // p,), 0.1), rs)
    return out


def replay_rank(mesh, rank, data: dict) -> dict:
    """make_replay_sharded against the single-device batched replay (the
    reference's (2, 4) NAG check), and the sharded step on the IVF."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core import oma, policy, trace

    n, d, t, h, k = data["n"], data["d"], data["t"], data["h"], data["k"]
    cat, reqs, _ = trace.sift_like(n=n, d=d, t=t, seed=0)
    cat, reqs = torch.from_numpy(cat), torch.from_numpy(reqs)
    cfg = policy.AcaiConfig(h=h, k=k, c_f=1.0, c_remote=24, c_local=8,
                            oma=oma.OMAConfig(eta=0.05, projection_topk=2 * h + 64))
    s0 = policy.init_state(n, cfg, device="cpu")
    fnb = policy.exact_candidate_fn_batched(cat, cfg.c_remote, cfg.c_local)
    _, m_b = policy.make_replay_batched(cfg, fnb, 8)(policy.copy_state(s0), reqs)
    blk = D.block_of(cat, mesh)
    sb = policy.CacheState(D.block_of(s0.y, mesh).clone(), D.block_of(s0.x, mesh).clone(),
                           0, torch.Generator().manual_seed(0))
    _, m_s = D.make_replay_sharded(cfg, mesh, blk, 8)(sb, reqs)
    out = {"nag_batched": float(m_b.gain_int.sum()) / (k * t),
           "nag_sharded": float(m_s.gain_int.sum()) / (k * t),
           "metrics_shape": tuple(m_s.gain_int.shape)}
    # the serving step on the sharded IVF (the reference's structures)
    from repro_torch import convert

    c, inv, nlist, nprobe = data["ivf"]
    ivf = convert.sharded_ivf_from_numpy(c, inv, nlist, nprobe, device="cpu")
    step = D.make_step_sharded(cfg, mesh, blk, 8, ivf=ivf)
    st = sb
    for i in range(0, 64, 8):
        st, m = step(st, reqs[i:i + 8])
    out["ivf_y_sum"] = float(D.gather_rows(st.y, mesh).sum())
    out["ivf_gain_finite"] = bool(torch.isfinite(m.gain_int).all())
    return out


def slab_rank(mesh, rank, data: dict) -> dict:
    """sharded_slab_append on this rank's blocks, gathered whole (growth
    included)."""
    import torch

    from repro_torch.core import distributed as D

    emb, valid = torch.from_numpy(data["emb"]), torch.from_numpy(data["valid"])
    eb, vb = D.block_of(emb, mesh).clone(), D.block_of(valid, mesh).clone()
    y = torch.arange(emb.shape[0], dtype=torch.float32)
    e2, v2, ids, (y2,) = D.sharded_slab_append(eb, vb, data["n_slots"],
                                               torch.from_numpy(data["vecs"]), mesh,
                                               carry=(D.block_of(y, mesh).clone(),))
    return {"emb": _np(D.gather_rows(e2, mesh)), "valid": _np(D.gather_rows(v2, mesh)),
            "ids": ids, "y": _np(D.gather_rows(y2, mesh)), "sites": dict(D.COLLECTIVE_SITES)}


def serving_rank(mesh, rank, data: dict) -> dict:
    """SemanticCachedLM on the mesh beside the single-device tier, and the
    launcher's --mesh-shards in this world (rank 0 prints)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    from repro_torch.serve import SemanticCachedLM, embed_prompt

    out = {}
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    params = init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (64, 8), generator=g)
    cat = embed_prompt(params, toks)
    reqs = [toks[int(i)] for i in torch.randint(0, 64, (32,), generator=g)]
    nags = {}
    for name, mesh_arg in (("mesh", mesh), ("single", None)):
        lm = SemanticCachedLM(params, cfg, cat, list(range(64)), lambda p: None, h=8, k=2,
                              c_f=0.5, seed=0, mesh=mesh_arg)
        served = []
        for i in range(0, 32, 8):
            m = lm.query_batch(reqs[i:i + 8])
            served.append(_np(m.served_local))
        lm.query(reqs[0])
        nags[name] = lm.nag
        out[f"{name}_served"] = np.concatenate(served)
        out[f"{name}_requests"] = lm.stats.requests
    out["nags"] = nags
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        figs = {}
        for label, extra in data["launcher_runs"].items():
            figs[label] = serve.main(["--smoke", "--device", "cpu", "--mesh-shards", "2",
                                      "--requests", "4", "--batch", "4", "--query-batches",
                                      "2", "--catalog", "64", "--cache-size", "8", *extra])
    out["launcher"] = {k: {"nag": f["semantic"]["nag"], "requests":
                           f["semantic"]["requests"], "shards": f["mesh_shards"],
                           "churn_events": f["semantic"]["churn_events"],
                           "index": f["semantic"]["index"]} for k, f in figs.items()}
    out["printed"] = buf.getvalue()
    return out


def churn_rank(mesh, rank, data: dict) -> dict:
    """The sharded churn invariants on this mesh (the reference's
    multi-device tests/test_sharded_churn.py cases)."""
    import torch

    from repro_torch.core import churn, oma, policy
    from repro_torch.core.distributed import owner_shard
    from repro_torch.serve.answer_cache import AnswerCache, AnswerCacheSpec

    cfg = policy.AcaiConfig(h=16, k=4, c_f=1.0, c_remote=16, c_local=8,
                            oma=oma.OMAConfig(eta=0.01, projection_topk=48))
    d = 8
    out = {}
    # removed rows from both shards hold zero y / x through every update
    rng = np.random.default_rng(5)
    cat = rng.standard_normal((128, d)).astype(np.float32)
    rq = torch.from_numpy(rng.standard_normal((40, d)).astype(np.float32))
    cache = policy.AcaiCache(cat, cfg, seed=0, mesh=mesh)
    removed = data["removed"]
    out["owners"] = sorted(set(owner_shard(removed, 128, 2).tolist()))
    cache.remove_objects(removed)
    lo = cache._block_lo()
    mine = torch.tensor([r - lo for r in removed if lo <= r < lo + 64], dtype=torch.long)
    zero = True
    for s in range(0, 40, 8):
        m = cache.serve_update_batch(rq[s:s + 8])
        zero &= float(cache.state.y[mine].abs().sum()) == 0.0
        zero &= float(cache.state.x[mine].abs().sum()) == 0.0
    out["removed_zero"] = zero
    out["occupancy"] = float(m.occupancy[0])
    out["live"] = cache.live_count
    out["cached"] = _np(cache.cached_ids)
    # one shard all tombstoned, the other below top-A
    rng = np.random.default_rng(7)
    cat = rng.standard_normal((128, d)).astype(np.float32)
    rq = torch.from_numpy(rng.standard_normal((16, d)).astype(np.float32))
    cache = policy.AcaiCache(cat, cfg, seed=0, mesh=mesh)
    cache.remove_objects(list(range(56, 128)))
    cache.remove_objects(list(range(8, 56)))
    out["edge_live"] = cache.live_count
    for s in range(0, 16, 8):
        m = cache.serve_update_batch(rq[s:s + 8])
    from repro_torch.convert import gather_state

    y, _ = gather_state(cache.state, mesh)
    out["edge_y"] = y
    out["edge_gain_finite"] = bool(torch.isfinite(m.gain_int).all())
    out["edge_occupancy"] = float(m.occupancy[0])
    # the rolling-catalog churn replay with compaction
    catalog, reqs, events, n0 = data["rolling"]
    cache = policy.AcaiCache(catalog[:n0], cfg, seed=0, mesh=mesh)
    res = churn.replay_with_churn(cache, catalog, reqs, events, batch=8, compact_every=24)
    out["replay"] = {"events_applied": res["events_applied"],
                     "compactions": res["compactions"], "live": cache.live_count,
                     "cap": cache.catalog.shape[0] * 2,
                     "gain_finite": bool(np.isfinite(res["gain"]).all()),
                     "gain": res["gain"]}
    # compaction's remap through the answer cache's inverted map
    rng = np.random.default_rng(11)
    cat = rng.standard_normal((128, d)).astype(np.float32)
    cache = policy.AcaiCache(cat, cfg, seed=0, mesh=mesh)
    ac = AnswerCache(AnswerCacheSpec(capacity=16))
    qs = rng.standard_normal((3, d)).astype(np.float32)
    stored = np.array([[2, 90, 31], [64, 5, 100], [31, 2, 127]], np.int32)
    ac.store_batch(qs, 3, np.ones((3, 3), np.float32), stored)
    removed = [0, 7, 40, 70, 111]
    cache.remove_objects(removed)
    out["ac_invalidated"] = ac.invalidate_removed(removed)
    from repro_torch.core.distributed import gather_rows

    old_emb = _np(gather_rows(cache.catalog, mesh))
    remap = cache.compact()
    ac.remap_ids(remap)
    new_emb = _np(gather_rows(cache.catalog, mesh))
    entries = list(ac._store.values())
    out["ac_ok"] = all(np.array_equal(remap[e_old], e_new.ids)
                       and np.array_equal(old_emb[e_old], new_emb[e_new.ids])
                       for e_old, e_new in zip(stored, entries))
    out["ac_inv_ok"] = (all(all(oid in ac._store[k].ids for k in keys)
                            for oid, keys in ac._inv.items())
                        and set(ac._inv) == {int(i) for e in entries for i in e.ids})
    out["compact_cap"] = cache.catalog.shape[0] * 2
    # mutation guards: the scan_chunk path refuses mutation, untouched
    chunked = policy.AcaiCache(cat, cfg, seed=0, mesh=mesh, sharded_kwargs={"scan_chunk": 64})
    try:
        chunked.add_objects(np.zeros((2, d), np.float32))
        out["guard"] = None
    except NotImplementedError as e:
        out["guard"] = str(e)
    out["guard_untouched"] = not chunked._mutated
    # sharded_slab_append at P = 2 on the reference's case
    out["slab"] = slab_rank(mesh, rank, data["slab"])
    return out


def moe_from_numpy(leaves: dict, cfg):
    """A whole MoE layer of the port holding `leaves` (name -> numpy array
    by the layer's parameter names: router, wi, wg, wo, shared.*), frozen."""
    import torch

    from repro_torch.models import moe as M

    layer = M.init_moe(torch.Generator().manual_seed(0), cfg, "cpu").requires_grad_(False)
    for name, t in layer.named_parameters():
        t.copy_(torch.from_numpy(np.asarray(leaves[name], np.float32)).to(t.dtype))
    return layer


def _batch_axes(mesh) -> tuple:
    """The axes the batch splits over: ("pod", "data") on a mesh with a pod
    axis, else ("data",)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _data_shard(x: np.ndarray, mesh) -> np.ndarray:
    """This rank's shard of a whole batch over the batch axes (rows r B / n
    ..., r the row-major coordinate); the whole batch where the axes do
    not divide it (`specs.batch_whole`, as `batch_pspecs` lays it out)."""
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import mesh_shape_dict
    from repro_torch.sharding.specs import batch_whole

    axes = _batch_axes(mesh)
    if batch_whole(x.shape[0], mesh_shape_dict(mesh), axes):
        return x
    n, r = D._axis_size(mesh, axes), D._axis_rank(mesh, axes)
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def _batch_shard(batch: dict, mesh) -> dict:
    """This rank's `data` shard of every input of a whole batch
    (positions3 (3, B, S) on its axis 1)."""
    return {k: (np.ascontiguousarray(_data_shard(v.swapaxes(0, 1), mesh).swapaxes(0, 1))
                if k == "positions3" else _data_shard(v, mesh)) for k, v in batch.items()}


def moe_ep_rank(mesh, rank, cases: list) -> dict:
    """The MoE under the mesh on this rank: [(name, cfg, leaves, x), ...]
    with x the whole (B, S, d) batch -> {name: {"out": this rank's data
    shard of the output, "aux", "counts": its collectives, "wi_shape":
    the rank's block of wi}}."""
    import torch

    from repro_torch import convert
    from repro_torch.core import distributed as D
    from repro_torch.models import moe as M
    from repro_torch.sharding.ctx import mesh_context

    out = {}
    for name, cfg, leaves, x in cases:
        layer = convert.moe_block(moe_from_numpy(leaves, cfg), cfg, mesh)
        D.reset_collectives()
        with mesh_context(mesh, ("data",)):
            y, aux = M.moe_ffn(layer, torch.from_numpy(_data_shard(x, mesh)), cfg)
        out[name] = {"out": _np(y), "aux": float(aux), "counts": dict(D.COLLECTIVES),
                     "wi_shape": list(layer.wi.shape)}
    return out


def moe_forward_rank(mesh, rank, cases: list) -> dict:
    """A whole LM forward on this rank's data shard of the tokens under the
    mesh context: [(name, cfg, reference numpy tree, tokens), ...] ->
    {name: {"logits" (over the whole vocab), "aux"}}."""
    import torch

    from repro_torch import convert
    from repro_torch.models import forward
    from repro_torch.sharding.ctx import mesh_context

    out = {}
    for name, cfg, params, tokens in cases:
        model = convert.lm_params_block(params, cfg, mesh, device="cpu")
        with mesh_context(mesh, _batch_axes(mesh)):
            res = forward(model, cfg, tokens=torch.from_numpy(_data_shard(tokens, mesh)))
        out[name] = {"logits": _whole_vocab(res.logits, cfg, mesh), "aux": float(res.aux_loss)}
    return out


def _probe_calls(module, name: str, sink: list, what):
    """Wrap `module.name` so each call appends what(args) to `sink`."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        sink.append(what(a, k))
        return fn(*a, **k)

    setattr(module, name, wrapped)


def seq_cache_rank(mesh, rank, cases: list) -> dict:
    """Serving a global batch that does not divide the batch axes (every
    rank holds the whole batch, its slice of the KV / latent sequence):
    [(name, cfg, reference numpy tree, tokens (B, S), decode steps,
    s_max, through ServeEngine too?), ...] -> {name: {"prefill": the prefill's logits over the whole
    vocab, "steps": each decode step's, "tokens": the greedy tokens
    (prefill's, then each step's), "generate": `generate`'s, "cache":
    {layer: {leaf: (shape, pspec)}}, "prefill_sites" / "step_sites": the collectives by site of
    the prefill and of one decode step, "flash": the flash calls of the
    prefill, "whole": the context's batch_whole, "engine": {"whole" /
    "divides": a batch-1 ServeEngine's tokens and first cache layer's
    shapes at global batch 1 / n_batch}}.  Steps 0 gives the prefill
    alone."""
    import torch

    from repro_torch import convert
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache
    from repro_torch.models.model import vocab_lo
    from repro_torch.serve.engine import (ServeEngine, argmax_tokens, generate,
                                          make_decode_step, make_prefill)
    from repro_torch.sharding import ctx as mesh_ctx
    from repro_torch.sharding.ctx import mesh_context

    flash: list = []
    _probe_calls(ops, "flash_attention", flash, lambda a, k: tuple(a[1].shape))
    out = {}
    for name, cfg, params, tokens, steps, s_max, engine in cases:
        model = convert.lm_params_block(params, cfg, mesh, device="cpu")
        toks = torch.from_numpy(tokens)
        rec = {"steps": []}
        with mesh_context(mesh, _batch_axes(mesh), global_batch=tokens.shape[0]):
            rec["whole"] = mesh_ctx.current().batch_whole
            cache = init_cache(cfg, tokens.shape[0], s_max, device="cpu")
            rec["cache"] = {i: {n: (list(t.shape), t.pspec) for n, t in layer.items()}
                            for i, layer in enumerate(cache)}
            D.reset_collectives()
            flash.clear()
            logits, cache = make_prefill(cfg, s_max)(model, {"tokens": toks}, cache)
            rec["prefill_sites"] = _sites(D.COLLECTIVE_SITES)
            rec["flash"] = list(flash)
            rec["prefill"] = _whole_vocab(logits, cfg, mesh)
            last = argmax_tokens(logits[:, -1], vocab_lo=vocab_lo(model, cfg))
            last = last[:, None].to(torch.int32)
            got = [_np(last)]
            decode = make_decode_step(cfg)
            for i in range(steps):
                D.reset_collectives()
                last, step_logits, cache = decode(model, cache, last, tokens.shape[1] + i)
                if i == 0:
                    rec["step_sites"] = _sites(D.COLLECTIVE_SITES)
                rec["steps"].append(_whole_vocab(step_logits, cfg, mesh))
                got.append(_np(last))
            rec["tokens"] = np.concatenate(got, axis=1)
            rec["generate"] = _np(generate(model, cfg, toks, steps + 1, s_max=s_max))
        if engine:
            rec["engine"] = {}
            n_batch = D._axis_size(mesh, _batch_axes(mesh))
            # ServeEngine at batch 1: the whole batch (global 1), and a rank's
            # slot of a batch that divides (global n_batch, every rank the
            # same prompt): its one-row prefill keeps the batch cache's layout
            for label, global_batch in (("whole", 1), ("divides", n_batch)):
                with mesh_context(mesh, _batch_axes(mesh), global_batch=global_batch):
                    eng = ServeEngine(model, cfg, 1, s_max)
                    eng.submit(0, toks[0], steps)
                    while eng.step():
                        pass
                    rec["engine"][label] = {
                        "tokens": eng.done[0],
                        "slots": {n: list(t.shape) for n, t in eng.cache[0].items()}}
        out[name] = rec
    return out


def moe_rows_rank(mesh, rank, cases: list) -> dict:
    """The MoE under the mesh, recording the expert buffers the rank
    multiplies: [(name, cfg, leaves, x the whole (B, S, d) batch), ...] ->
    {name: {"out": this rank's data shard of the output, "buffers": the
    (E_rank, rows, d) shape of every expert buffer, "me": its batch
    coordinate}}."""
    import torch

    from repro_torch import convert
    from repro_torch.core import distributed as D
    from repro_torch.models import moe as M
    from repro_torch.sharding.ctx import mesh_context

    buffers: list = []
    _probe_calls(M, "expert_ffn", buffers, lambda a, k: list(a[3].shape))
    axes = _batch_axes(mesh)
    out = {}
    for name, cfg, leaves, x in cases:
        layer = convert.moe_block(moe_from_numpy(leaves, cfg), cfg, mesh)
        buffers.clear()
        with mesh_context(mesh, axes):
            y, _ = M.moe_ffn(layer, torch.from_numpy(_data_shard(x, mesh)), cfg)
        out[name] = {"out": _np(y), "buffers": list(buffers),
                     "me": D._axis_rank(mesh, axes)}
    return out


def _whole_vocab(logits, cfg, mesh) -> np.ndarray:
    """The rank's logits over the whole vocab: its vocab shard gathered over
    `model` (a test-side gather, not counted)."""
    import torch

    from repro_torch.core import distributed as D

    if logits.shape[-1] == cfg.vocab:
        return _np(logits)
    g = D.all_gather(logits.contiguous(), mesh, "model", "test")
    return _np(torch.cat(list(g.unbind(0)), dim=-1))


def _sites(counter) -> dict:
    """COLLECTIVE_SITES as {"primitive|site": calls}."""
    return {f"{p}|{s}": n for (p, s), n in sorted(counter.items())}


def tp_serve_rank(mesh, rank, cases: list) -> dict:
    """Serving under the specs' layout on this rank: [(name, cfg, reference
    numpy tree, inputs (the whole batch: tokens, and embeds / positions3
    where the architecture takes them), decode steps), ...] -> {name:
    {"logits": the prefill's logits of the rank's data shard over the
    whole vocab, "sites": the forward's collectives by site, "tokens":
    `generate`'s greedy tokens (decode steps > 0), "gen_sites", "sampled":
    its temperature-0.7 tokens from seeded uniforms (unless a sixth
    element of the case is False), "heads": the head
    counts the prefill's attention cores and SSD scans ran over, "cache":
    the shapes of `init_cache`'s first layer under the mesh, "blocks": the
    rank's parameter shapes by name}}."""
    import torch

    from repro_torch import convert
    from repro_torch.core import distributed as D
    from repro_torch.models import forward, init_cache
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.serve.engine import generate
    from repro_torch.sharding.ctx import mesh_context

    heads = {"attention": [], "ssd": []}

    def probe(fn, what):
        def wrapped(*a, **k):
            heads[what].append(int(a[0].shape[2]))
            return fn(*a, **k)
        return wrapped

    L.attention_core = probe(L.attention_core, "attention")
    SSM.ssd_chunked = probe(SSM.ssd_chunked, "ssd")
    out = {}
    for name, cfg, params, inputs, steps, *sample in cases:
        kw = {k: torch.from_numpy(v) for k, v in _batch_shard(inputs, mesh).items()}
        model = convert.lm_params_block(params, cfg, mesh, device="cpu")
        with mesh_context(mesh, ("data",)):
            D.reset_collectives()
            for v in heads.values():
                v.clear()
            res = forward(model, cfg, **kw)
            sites = _sites(D.COLLECTIVE_SITES)
            rec = {"logits": _whole_vocab(res.logits, cfg, mesh), "sites": sites,
                   "aux": float(res.aux_loss), "heads": {k: list(v) for k, v in heads.items()},
                   "cache": {k: list(t.shape)
                             for k, t in init_cache(cfg, 1, 8, device="cpu")[0].items()},
                   "blocks": {n: list(p.shape) for n, p in model.named_parameters()}}
            if steps:
                D.reset_collectives()
                rec["tokens"] = _np(generate(model, cfg, kw["tokens"], steps))
                rec["gen_sites"] = _sites(D.COLLECTIVE_SITES)
                if sample and not sample[0]:
                    out[name] = rec
                    continue
                # temperature draws from the global batch's (steps - 1, B,
                # vocab) uniforms: this rank's rows, all vocab ids
                u = np.random.default_rng(11).random(
                    (steps - 1, inputs["tokens"].shape[0], cfg.vocab), dtype=np.float32)
                u = _data_shard(u.swapaxes(0, 1), mesh).swapaxes(0, 1)
                rec["sampled"] = _np(generate(model, cfg, kw["tokens"], steps,
                                              temperature=0.7,
                                              uniforms=torch.from_numpy(u.copy())))
        out[name] = rec
    return out


def tp_train_rank(mesh, rank, cases: list) -> dict:
    """Training under the specs' layout: [(name, cfg, reference numpy tree,
    [batch a step (the whole batch)], accum), ...] -> {name: {"losses",
    "grad_norms": each step's, "params": each step's leaves after it, the
    rank's blocks by name, "specs": their specs, "sites": the first step's
    collectives by site}}."""
    import torch

    from repro_torch import convert
    from repro_torch.core import distributed as D
    from repro_torch.sharding.ctx import mesh_context
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.data import to_device

    out = {}
    for name, cfg, params, batches, accum in cases:
        model = convert.lm_params_block(params, cfg, mesh, device="cpu").train_mode()
        named = dict(model.named_parameters())
        state = opt_lib.init_opt(cfg.optimizer, named, opt_lib.param_groups(cfg, named))
        step = make_train_step(cfg, OptConfig(name=cfg.optimizer), accum=accum)
        rec = {"losses": [], "grad_norms": [], "params": [],
               "specs": {n: p.pspec for n, p in named.items()}}
        with mesh_context(mesh, ("data",)):
            for i, batch in enumerate(batches):
                D.reset_collectives()
                model, state, m = step(model, state,
                                       to_device(_batch_shard(batch, mesh), cfg, "cpu"), i)
                if i == 0:
                    rec["sites"] = _sites(D.COLLECTIVE_SITES)
                rec["losses"].append(float(m.loss))
                rec["grad_norms"].append(float(m.grad_norm))
                # copies: the step updates the parameters in place
                rec["params"].append({n: _np(p).copy() for n, p in model.named_parameters()})
        out[name] = rec
    return out


def cost_rank(mesh, rank, cases: list) -> dict:
    """The cost record of this rank's step (`launch.dryrun.build_lowering`
    and `analyse`) on the mesh's device: CPU tensors on a gloo world, meta
    on a fake one.  cases: [(name, SMOKE arch, SMOKE shape, overrides of
    its config), ...], and "acai" runs `make_retrieval_step` at n 256, d 8,
    a batch of 8 -> {name: {"flops", "coll_bytes", "coll_counts",
    "kernels"}}."""
    import dataclasses

    import torch

    from repro_torch.configs import SMOKE_ARCHS, SMOKE_SHAPES
    from repro_torch.core import distributed as D
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import CostMode

    def summary(s):
        return {"flops": s.flops, "coll_bytes": s.coll_bytes, "coll_counts": s.coll_counts,
                "kernels": {k: v["launches"] for k, v in s.kernels.items()}}

    multi = "pod" in mesh.mesh_dim_names
    out = {}
    for name, arch, shape, over in cases:
        if arch == "acai":
            dev = D.mesh_device(mesh)
            n_s = 256 // D._axis_size(mesh, "model")
            step = D.make_retrieval_step(mesh, n_shard=n_s, d=8, c=16, k=4, c_f=1.0, h=32,
                                         eta=0.01, top_a=32, batch_axes=_batch_axes(mesh))
            g = torch.Generator().manual_seed(0)
            args = [torch.rand(n_s, 8, generator=g).to(dev),
                    torch.full((n_s,), 0.1).to(dev), torch.rand(8, 8, generator=g).to(dev)]
            with CostMode(args) as mode:
                step(*args)
            out[name] = summary(mode.summary)
            continue
        cfg = dataclasses.replace(SMOKE_ARCHS[arch], **over)
        run, args, info = dryrun.build_lowering(cfg, SMOKE_SHAPES[shape], mesh, multi)
        with CostMode(args) as mode:
            run()
        out[name] = summary(mode.summary)
    return out
