"""Dry-run of every (arch x shape x mesh) cell, the analytic half (port of
`repro.launch.dryrun`).

Each cell's record holds the reference's cell fields (arch, shape, mesh,
kind, seq_len, global_batch, variant, params_total, params_active,
status) and the per-device bytes of the parameters, and of the optimizer
state (train shapes, with the accumulation steps) or the cache (prefill
and decode), over the production mesh (`launch.mesh.production_mesh_shape`:
(data 16, model 16), or (pod 2, data 16, model 16) across pods).  The
bytes come from the model, optimizer state and cache built on the
meta device and laid out by `sharding.specs`: no world, no weights, no
card.  The AÇAI retrieval cell records its per-device catalog bytes and
its provenance (`acai_cell_meta`).

The bytes are what a rank holds when the model runs laid out this way
(`convert.lm_params_block`, `sharding.tp`): its blocks of the parameters,
the Adafactor state of the reference's stacked leaves
(`optimizer.param_groups`), its cache.  The reference's compile-derived
fields (`cost_analysis`, `memory_analysis`, `hlo_analysis.summarize`'s
FLOPs, bytes and collective bytes, `src/repro/launch/dryrun.py:140-178`)
have no counterpart here yet: the cost record, the second half of
ROADMAP A12c.

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single \\
        --out DIR
    python -m repro_torch.launch.dryrun --all --mesh both --variant opt --out DIR

One JSON a cell (`DIR/{arch}__{shape}__{mesh}.json`); cells already in
DIR are skipped (resumable), `--force` redoes them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs import ARCHS, SHAPES, runnable
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import init_cache, init_params
from repro_torch.sharding import specs as S
from repro_torch.train.optimizer import init_opt, param_groups

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


def run_cell(arch: str, shape_name: str, mesh_kind: str, variant: str = "baseline") -> dict:
    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    multi_pod = mesh_kind == "multi"
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
    mesh_shape = production_mesh_shape(multi_pod)
    record.update(cell_bytes(cfg, shape, mesh_shape, multi_pod))
    record["n_devices"] = int(S.axis_size(mesh_shape, tuple(mesh_shape)))
    record["status"] = "ok"
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
                  batch: int = 4096, k: int = 10, h: int = 2 ** 20,
                  variant: str = "baseline") -> dict:
    """The paper-representative cell: one sharded AÇAI retrieval + OMA step
    over a 134M-object float32 catalog split over the mesh's `model` axis;
    its per-device catalog bytes."""
    mesh_shape = production_mesh_shape(mesh_kind == "multi")
    record = acai_cell_meta(mesh_kind, n_catalog=n_catalog, d=d, batch=batch, k=k, h=h,
                            eta=1e-2, variant=variant)
    record["params_bytes_per_device"] = n_catalog * d * 4 // mesh_shape["model"]
    record["n_devices"] = int(S.axis_size(mesh_shape, tuple(mesh_shape)))
    record["status"] = "ok"
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


def main(argv=None) -> list:
    """Write every asked cell's record; returns the records (cached ones
    read back)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help=f"an arch, or {ACAI_ARCH}")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=["baseline", "opt"])
    args = ap.parse_args(argv)
    if args.arch not in (None, ACAI_ARCH) and args.arch not in ARCHS:
        ap.error(f"unknown arch {args.arch!r}; known: {sorted(ARCHS)} and {ACAI_ARCH}")
    if args.shape is not None and args.shape not in SHAPES:
        ap.error(f"unknown shape {args.shape!r}; known: {sorted(SHAPES)}")

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    records = []
    if args.arch == ACAI_ARCH or args.all:
        for mesh_kind in meshes:
            path = cell_path(args.out, ACAI_ARCH, ACAI_SHAPE, mesh_kind)
            rec = _cached(path, args.force)
            if rec is None:
                rec = run_acai_cell(mesh_kind, variant=args.variant)
                _write(path, rec)
            records.append(rec)
            print(f"[{rec['status']:7s}] {ACAI_ARCH} {mesh_kind}", flush=True)
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
                    rec = run_cell(arch, shape, mesh_kind, variant=args.variant)
                    _write(path, rec)
                records.append(rec)
                print(f"[{'cached' if cached else rec['status']:7s}] {arch} {shape} "
                      f"{mesh_kind} {rec.get('reason', '')}", flush=True)
    return records


if __name__ == "__main__":
    main()
