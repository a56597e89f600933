"""Dry-run of every (arch x shape x mesh) cell (port of `repro.launch.dryrun`):
the analytic bytes a rank holds, and the cost record of the step it runs.

Each cell's record holds the reference's cell fields (arch, shape, mesh,
kind, seq_len, global_batch, variant, params_total, params_active,
status) and the per-device bytes of the parameters, and of the optimizer
state (train shapes, with the accumulation steps) or the cache (prefill
and decode), over the production mesh (`launch.mesh.production_mesh_shape`:
(data 16, model 16), or (pod 2, data 16, model 16) across pods).  The
bytes come from the model, optimizer state and cache built on the meta
device and laid out by `sharding.specs` (`cell_bytes`): what a rank holds
when the model runs laid out this way (`convert.shard_module`,
`sharding.tp`), the Adafactor state on the reference's stacked leaves
(`optimizer.param_groups`).

The cost record is the counterpart of the reference's compile-derived
fields (`analyse`, src/repro/launch/dryrun.py:140-178).  The reference
compiles the step for 512 placeholder devices and reads the per-device
HLO; the port opens a world with no peers (`launch.mesh.fake_world`: this
process is rank 0 of 256, or 512 across pods), builds the production
mesh over it, lays rank 0 out on the meta device (`build_lowering`: its
blocks of the weights, its slice of the batch, its optimizer state or
cache) and runs its step once under `launch.cost.CostMode`, which counts
(`analyse`):
  - `hlo.flops_per_device`: dot FLOPs, as `hlo_analysis` counts them (the
    aten matmul family, forward, backward and remat recomputation), plus
    each kernel's formula (`kernels.cost`; the kernels' meta calls launch
    nothing);
  - `hlo.hbm_bytes_per_device`: the output bytes of every operation that
    materialises a tensor, plus the kernels' outputs.  The port runs
    eagerly where XLA fuses, so this sits above the reference's;
  - `hlo.collective_bytes_per_shard` / `collective_counts`, and their
    total `collective_bytes_per_shard_total`: the counted collectives of
    `core.distributed` by the reference's five classes (all-to-all and
    collective-permute stay 0), a shard's operand bytes per call;
  - `live_memory`, in place of `memory_analysis`: the argument bytes (the
    rank's parameters, optimizer state or cache, batch), the peak of the
    storages the step allocated and still held, their sum;
  - `counted_ops`: aten operations seen, the matmul family's FLOPs, each
    kernel's launches, FLOPs and bytes;
  - `run_seconds` (the counterpart of `compile_seconds`), `lower_seconds`
    (the layout's build), `n_devices`, `batch_per_device`.
The reference's `loops` has no counterpart: an eager run executes every
layer, microbatch and chunk, so nothing is multiplied by a trip count.
Where the batch does not divide the batch axes (long_500k's global batch
1) every rank holds the whole batch and its slice S / (pod x data) of the
sequence of every KV and latent cache, as the reference's layout
(`specs.batch_whole`, `cache_pspecs`): `live_memory`'s argument bytes
are the rank's parameters, that cache (`cache_bytes_per_device`) and the
batch; a decode step writes the new token on the rank that owns its slot
and gathers each attention layer's softmax partials over the batch axes
(site "attn_seq"); its MoE routes the whole batch as the unmeshed layer.
A cell the layout cannot run is written `failed` with its error and
traceback.

The fake world is the process's, so the cost record is computed only
where the caller asks (`main(argv, cost=True)`, as the command line
does), and each cell opens and closes its world; `main(argv)` from
another program writes the analytic half.

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single \\
        --out DIR
    python -m repro_torch.launch.dryrun --all --mesh both --variant opt --out DIR
    python -m repro_torch.launch.dryrun --all --smoke --out DIR   # SMOKE, a (1, 1) mesh

One JSON a cell (`DIR/{arch}__{shape}__{mesh}.json`); cells already in
DIR are skipped (resumable), `--force` redoes them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPES, SMOKE_ARCHS, SMOKE_SHAPES, runnable
from repro_torch.core import distributed as D
from repro_torch.launch.cost import CostMode
from repro_torch.launch.mesh import (POD_AXES, SERVING_AXES, batch_axes, fake_world,
                                     make_mesh, mesh_shape_dict, production_mesh_shape)
from repro_torch.models import init_cache, init_params
from repro_torch.serve.engine import make_decode_step, make_prefill
from repro_torch.sharding import specs as S
from repro_torch.sharding.ctx import mesh_context
from repro_torch.train.batching import input_specs, synthetic_batch
from repro_torch.train.optimizer import OptConfig, init_opt, param_groups
from repro_torch.train.train_step import TrainStep

ACAI_ARCH, ACAI_SHAPE = "acai-retrieval", "retrieval_b4096"


def _accum_for(shape) -> int:
    return 8 if shape.kind == "train" and shape.global_batch >= 64 else 1


def cell_bytes(cfg, shape, mesh_shape: dict, multi_pod: bool) -> dict:
    """Per-device bytes of one cell over `mesh_shape`: params, then the
    optimizer state and accum (train) or the cache (prefill, decode)."""
    model = init_params(cfg, device="meta")
    params = dict(model.named_parameters())
    pspecs = S.param_pspecs(cfg, params, mesh_shape)
    info = {"params_bytes_per_device": S.sharded_bytes(params, pspecs, mesh_shape)}
    if shape.kind == "train":
        groups = param_groups(cfg, params)
        opt = init_opt(cfg.optimizer, params, groups)
        ospecs = S.opt_pspecs(cfg.optimizer, pspecs, groups)
        info["opt_bytes_per_device"] = S.sharded_bytes(opt, ospecs, mesh_shape)
        info["accum"] = _accum_for(shape)
    else:
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        cspecs = S.cache_pspecs(cfg, cache, mesh_shape, multi_pod)
        info["cache_bytes_per_device"] = S.sharded_bytes(cache, cspecs, mesh_shape)
    return info


def apply_variant(cfg, variant: str, multi_pod: bool):
    """"opt" = the reference's confirmed beyond-baseline configuration: the
    expert-parallel MoE (moe_dp 16 on one pod, 32 across pods), MLA's
    absorbed decode, data-only sharding for attention matrices whose head
    counts do not divide the model axis."""
    if variant != "opt":
        return cfg
    dp = 32 if multi_pod else 16
    return dataclasses.replace(cfg, moe_dp=dp if cfg.n_experts else 0,
                               mla_absorbed_decode=cfg.attn_type == "mla",
                               replicate_misaligned_heads=True)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for v in tree for t in _tensors(v)] if isinstance(tree, (list, tuple)) else []


def build_lowering(cfg, shape, mesh, multi_pod: bool, seed: int = 0):
    """One rank of `mesh` laid out as the layout runs it, on the mesh's
    device (`core.distributed.mesh_device`: meta on a world-less mesh):
    its model (drawn from `seed`, cut by `convert.shard_module`), its slice
    of the batch (`batch_pspecs`' rule: global / the batch axes, whole
    where they do not divide it; `input_specs` on meta, `synthetic_batch`
    elsewhere), its optimizer state (train) or cache (prefill, decode:
    `init_cache` under the mesh context, the rank's kv heads, conv
    channels and ssm heads).  Returns (run, args, info): run() takes the
    rank's step once (train: `TrainStep` with `_accum_for`'s accumulation
    and cfg.remat; prefill: `engine.make_prefill`; decode:
    `engine.make_decode_step` at the cache's last slot, with positions3
    under M-RoPE), args the tensors it is handed, info the analytic
    bytes (`cell_bytes`) and `batch_per_device`."""
    dev = D.mesh_device(mesh)
    mesh_shape = mesh_shape_dict(mesh)
    info = cell_bytes(cfg, shape, mesh_shape, multi_pod)
    axes = batch_axes(multi_pod)
    whole = S.batch_whole(shape.global_batch, mesh_shape, axes)
    b = shape.global_batch if whole else shape.global_batch // S.axis_size(mesh_shape, axes)
    info["batch_per_device"] = b
    rank_shape = dataclasses.replace(shape, global_batch=b)
    batch = (input_specs(cfg, rank_shape) if dev.type == "meta"
             else synthetic_batch(cfg, rank_shape, seed, device=dev))
    model = convert.shard_module(init_params(cfg, seed=seed, device=dev), cfg, mesh)
    if shape.kind == "train":
        model.train_mode()
        params = dict(model.named_parameters())
        state = init_opt(cfg.optimizer, params, param_groups(cfg, params))
        step = TrainStep(cfg, OptConfig(name=cfg.optimizer), info["accum"])

        def run():
            with mesh_context(mesh, axes, shape.global_batch):
                step(model, state, batch, 0)
    else:
        with mesh_context(mesh, axes, shape.global_batch):
            state = init_cache(cfg, b, shape.seq_len, device=dev)
        if shape.kind == "prefill":
            prefill = make_prefill(cfg, shape.seq_len)

            def run():
                with mesh_context(mesh, axes, shape.global_batch), torch.no_grad():
                    prefill(model, batch, state)
        else:
            decode = make_decode_step(cfg)

            def run():
                with mesh_context(mesh, axes, shape.global_batch), torch.no_grad():
                    decode(model, state, batch["tokens"], shape.seq_len - 1,
                           positions3=batch.get("positions3"))
    args = _tensors(dict(model.named_parameters())) + _tensors(state) + _tensors(batch)
    return run, args, info


def analyse(run, args, info: dict, n_devices: int) -> dict:
    """Run a rank's step once under `launch.cost.CostMode` and return its
    record: `info`, the cost record's fields (`CostSummary.record`, the
    module's docstring), `run_seconds` and `n_devices`."""
    out = dict(info)
    t0 = time.time()
    with CostMode(args) as mode:
        run()
    out["run_seconds"] = time.time() - t0
    out.update(mode.summary.record())
    out["n_devices"] = n_devices
    return out


@contextlib.contextmanager
def world_less_mesh(multi_pod: bool, smoke: bool = False):
    """The production mesh (`production_mesh_shape`) over a fake world of
    its size, this process its rank 0 (`launch.mesh.fake_world`), or with
    `smoke` the (1, 1) mesh of a one-rank fake world (the reference's host
    mesh); the world is closed on exit."""
    shape = {"data": 1, "model": 1} if smoke else production_mesh_shape(multi_pod)
    fake_world(int(S.axis_size(shape, tuple(shape))))
    try:
        yield make_mesh(tuple(shape.values()),
                        POD_AXES if len(shape) == 3 else SERVING_AXES)
    finally:
        dist.destroy_process_group()


def _failed(record: dict, e: Exception) -> None:
    record["status"] = "failed"
    record["error"] = f"{type(e).__name__}: {e}"
    record["traceback"] = traceback.format_exc()[-4000:]


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str = "baseline", *,
             smoke: bool = False, cost: bool = False) -> dict:
    """One cell's record: the reference's cell fields and the analytic
    bytes over the production mesh, and with `cost` the cost record of
    rank 0's step on a world-less mesh (opened and closed here).  With
    `smoke`, a SMOKE arch and shape on a one-rank (1, 1) mesh, as the
    reference's --smoke runs them."""
    cfg = (SMOKE_ARCHS if smoke else ARCHS)[arch]
    shape = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    multi_pod = mesh_kind == "multi" and not smoke
    cfg = apply_variant(cfg, variant, multi_pod)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind,
              "seq_len": shape.seq_len, "global_batch": shape.global_batch,
              "variant": variant, "params_total": cfg.param_count(),
              "params_active": cfg.active_param_count()}
    ok, reason = runnable(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        return record
    t0 = time.time()
    mesh_shape = {"data": 1, "model": 1} if smoke else production_mesh_shape(multi_pod)
    try:
        if cost:
            with world_less_mesh(multi_pod, smoke) as mesh:
                run, args, info = build_lowering(cfg, shape, mesh, multi_pod)
                record["lower_seconds"] = time.time() - t0
                record.update(analyse(run, args, info, mesh.size()))
        else:
            record.update(cell_bytes(cfg, shape, mesh_shape, multi_pod))
            record["n_devices"] = int(S.axis_size(mesh_shape, tuple(mesh_shape)))
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001  (the record says what failed)
        _failed(record, e)
    record["total_seconds"] = time.time() - t0
    return record


def acai_cell_meta(mesh_kind: str, *, n_catalog: int, d: int, batch: int, k: int, h: int,
                   eta: float, variant: str) -> dict:
    """Static provenance fields of the AÇAI retrieval cell: the collective
    layer the sharded step runs on (`shard_map_impl`, the reference's
    shard_map), the index (`index_spec`: the exact per-shard scan) and the
    policy (`policy_spec`, in `PolicySpec.to_dict`'s form, c_f included,
    so the record round-trips into `AcaiCache(catalog, spec)`)."""
    from repro_torch.core.distributed import COLLECTIVE_LAYER
    from repro_torch.core.policy_api import PolicySpec

    return {"arch": ACAI_ARCH, "shape": f"retrieval_b{batch}", "mesh": mesh_kind,
            "kind": "serve", "variant": variant, "seq_len": n_catalog,
            "global_batch": batch, "params_total": n_catalog * d,
            "params_active": n_catalog * d, "shard_map_impl": COLLECTIVE_LAYER,
            "index_spec": {"backend": "exact"},
            "policy_spec": PolicySpec("acai", {"h": h, "k": k, "eta": eta, "c_f": 1.0,
                                               "batch": batch}).to_dict()}


def run_acai_cell(mesh_kind: str, *, n_catalog: int = 2 ** 27, d: int = 128,
                  batch: int = 4096, c: int = 64, k: int = 10, h: int = 2 ** 20,
                  top_a: int = 4096, variant: str = "baseline", cost: bool = False) -> dict:
    """The paper-representative cell: one sharded AÇAI retrieval + OMA step
    (`core.distributed.make_retrieval_step`, the exact scan: scan_chunk 0)
    over a 134M-object float32 catalog split over the mesh's `model` axis,
    the requests over the batch axes, with the reference's c, k, h, top_a
    and eta (src/repro/launch/dryrun.py:274-318): the record of one rank
    on a world-less mesh, its catalog block (n / 16, d), y block and the
    4096 requests on the meta device (with `cost`; else its per-device
    catalog bytes only).  The local scan is `pairwise_l2` (its formula),
    the merge, routing, projection and metrics collectives the
    primitives' counts."""
    multi_pod = mesh_kind == "multi"
    mesh_shape = production_mesh_shape(multi_pod)
    eta = 1e-2
    record = acai_cell_meta(mesh_kind, n_catalog=n_catalog, d=d, batch=batch, k=k, h=h,
                            eta=eta, variant=variant)
    n_shard = n_catalog // mesh_shape["model"]
    info = {"params_bytes_per_device": n_shard * d * 4}
    t0 = time.time()
    if not cost:
        record.update(info, n_devices=int(S.axis_size(mesh_shape, tuple(mesh_shape))),
                      status="ok")
        return record
    try:
        with world_less_mesh(multi_pod) as mesh:
            step = D.make_retrieval_step(mesh, n_shard=n_shard, d=d, c=c, k=k, c_f=1.0, h=h,
                                         eta=eta, top_a=top_a,
                                         batch_axes=batch_axes(multi_pod), scan_chunk=0)
            cat = torch.empty((n_shard, d), device="meta")
            y = torch.empty((n_shard,), device="meta")
            reqs = torch.empty((batch, d), device="meta")
            record["lower_seconds"] = time.time() - t0
            record.update(analyse(lambda: step(cat, y, reqs), [cat, y, reqs], info,
                                  mesh.size()))
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001  (the record says what failed)
        _failed(record, e)
    record["total_seconds"] = time.time() - t0
    return record


def cell_path(out_dir, arch, shape, mesh_kind) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json")


def _cached(path: str, force: bool) -> dict | None:
    if force or not os.path.exists(path):
        return None
    with open(path) as f:
        prev = json.load(f)
    return prev if prev.get("status") in ("ok", "skipped") else None


def _write(path: str, record: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1)
    os.replace(tmp, path)


def main(argv=None, *, cost: bool = False) -> list:
    """Write every asked cell's record; returns the records (cached ones
    read back).  `cost` adds the cost record (the command line's default):
    each cell then opens a fake world in this process, so a caller that
    holds a world of its own must leave it False."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help=f"an arch, or {ACAI_ARCH}")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="SMOKE archs and shapes on a one-rank (1, 1) mesh")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "opt"])
    args = ap.parse_args(argv)
    if args.arch not in (None, ACAI_ARCH) and args.arch not in ARCHS:
        ap.error(f"unknown arch {args.arch!r}; known: {sorted(ARCHS)} and {ACAI_ARCH}")
    if args.shape is not None and args.shape not in (SMOKE_SHAPES if args.smoke else SHAPES):
        ap.error(f"unknown shape {args.shape!r}; known: {sorted(SHAPES)}")

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    records = []
    if args.arch == ACAI_ARCH or args.all:
        for mesh_kind in meshes:
            path = cell_path(args.out, ACAI_ARCH, ACAI_SHAPE, mesh_kind)
            rec = _cached(path, args.force)
            if rec is None:
                rec = run_acai_cell(mesh_kind, variant=args.variant, cost=cost)
                _write(path, rec)
            records.append(rec)
            print(f"[{rec['status']:7s}] {ACAI_ARCH} {mesh_kind} "
                  f"({rec.get('total_seconds', 0):.1f}s) {rec.get('error', '')}", flush=True)
        if args.arch == ACAI_ARCH:
            return records
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = cell_path(args.out, arch, shape, mesh_kind)
                rec = _cached(path, args.force)
                cached = rec is not None
                if not cached:
                    rec = run_cell(arch, shape, mesh_kind, variant=args.variant,
                                   smoke=args.smoke, cost=cost)
                    _write(path, rec)
                records.append(rec)
                print(f"[{'cached' if cached else rec['status']:7s}] {arch} {shape} "
                      f"{mesh_kind} ({rec.get('total_seconds', 0):.1f}s) "
                      f"{rec.get('reason') or rec.get('error', '')}", flush=True)
    return records


if __name__ == "__main__":
    main(sys.argv[1:], cost=True)
