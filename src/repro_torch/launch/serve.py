"""Serving driver of the port (port of the LM path of `repro.launch.serve`):
continuous-batching prefill and decode, then the AÇAI semantic cache in
front of generation (the paper's edge-inference deployment).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --smoke --device cpu

Weights come from a seed at the architecture's published widths (the
reference serves from `init_params(PRNGKey(0))` too).  Flags beyond the
reference's LM path:

  --s-max N           KV cache length of the engine and of each semantic-
                      tier generation (default: the reference's,
                      prompt-len + max-tokens + 8 for the engine and
                      prompt-len + 4 for a generation)
  --prompt-len LO:HI  engine prompt lengths drawn from [LO, HI] (the
                      semantic tier's prompts take LO)
  --query-batches N   after the --requests single queries, serve N
                      batches of --batch prompts by `query_batch`
  --catalog 0         skips the semantic tier
  --device cpu        run on the CPU (the card is the default)

`--churn-rate R` mutates the semantic tier's catalog online, as the
reference does: the tier starts on the first `--churn-warm` share of the
catalog, and R insert + expire events a request (a rolling window) add the
next row and drop the oldest one before the requests they precede
(`SemanticCachedLM.add_documents` / `remove_documents`).

`--policy` selects the semantic tier's cache policy through the policy
registry (AÇAI by default, or a baseline, e.g. `--policy sim_lru
--policy-opt k_prime=8 --policy-opt augmented=true`); a baseline serves
from the exact server oracle, so it takes no `--remote-index`.

The semantic tier's traffic is the paper's (Sec. V-A, `core/trace.py`):
the catalog holds the results of --catalog earlier prompts (row i is
`embed_prompt` of prompt i), and each request repeats the prompt of a
catalog object drawn with Zipf(0.9) popularity, objects nearer the
catalog barycenter more popular (`semantic_traffic`).  The reference
draws a random catalog and fresh random prompts instead: no prompt lies
near any object there, so every request is served from the store and
nothing generates.

`--answer-cache CAP` fronts AÇAI's index with the exact answer memo
(repeated queries serve their memoized top-k without the index scan,
bitwise equal to the uncached path) and `--answer-cache-opt key=value`
passes `AnswerCacheSpec` fields, as the reference's:

  ... --remote-index flat --answer-cache 4096
  ... --remote-index ivf --answer-cache 1024 --answer-cache-opt hit_ms=0.1
  ... --remote-index nsw --answer-cache 512 --answer-cache-opt idle_unload_ms=50

The `--remote-fault-*` flags inject a deterministic fault schedule into
the remote tier and route every request through the resilient path
(retries with capped backoff, optional hedging `--hedge-ms`, deadlines
`--deadline-ms`, a circuit breaker, degradation to local answers), for
any policy:

  ... --remote-fault-rate 0.2 --deadline-ms 250
  ... --remote-fault-outage 10:30 --policy sim_lru
  ... --remote-fault-latency-ms 40 --hedge-ms 80 --retries 3

`--arrival` then drives --requests more requests of the same traffic
through the online serving engine: they arrive on the virtual clock,
queue and are coalesced by the batch former (`--batch` max size,
`--batch-window-ms` max wait), at `--offered-load` times the service
model's capacity; admission control sheds on `--queue-cap` and
`--shed-deadline-ms`, and `--slo-ms` reports goodput at that SLO:

  ... --arrival poisson --offered-load 0.8 --batch-window-ms 5 --slo-ms 25
  ... --arrival flash_crowd --offered-load 1.2 --queue-cap 64
  ... --arrival closed_loop --slo-ms 25

`--mesh-shards P` (P > 1) shards the semantic tier's catalog and AÇAI's
state over a (1, P) mesh, one process a shard, as torchrun starts them:

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --smoke \
      --device cpu --mesh-shards 2 [--remote-index ivf_sharded]

The world's size must be P.  `--device cpu` runs a gloo world; on the
card each rank takes `cuda:$LOCAL_RANK` in an NCCL world.  Every rank
runs the whole launcher on the same seeds; rank 0 prints.  A caller that
has initialised the world itself (`torch.distributed.init_process_group`)
keeps it; otherwise the launcher joins torchrun's and leaves it at the end.

`main(argv)` prints one line a tier and returns the figures as a dict.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.policy_api import PolicySpec, parse_policy_opts, registered_policies
from repro_torch.index.base import IndexSpec, parse_index_opts, registered_backends
from repro_torch.models import init_params
from repro_torch.serve import SemanticCachedLM, ServeEngine, embed_prompt, generate
from repro_torch.serve.answer_cache import AnswerCacheSpec, parse_answer_cache_opts
from repro_torch.serve.arrivals import ARRIVAL_KINDS, ArrivalSpec
from repro_torch.serve.queue import (AdmissionConfig, BatchFormerConfig, ServiceModel,
                                     serve_trace_online)
from repro_torch.serve.remote import FaultSpec, FaultyRemote, parse_outage_windows
from repro_torch.serve.resilience import ResilienceConfig, RetryConfig

SEED = 0  # weights, prompts and catalog
ZIPF_A = 0.9  # the paper's popularity exponent (core/trace.py)
_EMBED_ROWS = 512  # catalog prompts embedded a chunk


def _prompt_lens(spec: str) -> tuple[int, int]:
    lo, sep, hi = spec.partition(":")
    lo, hi = int(lo), int(hi) if sep else int(lo)
    if not 0 < lo <= hi:
        raise argparse.ArgumentTypeError(f"--prompt-len {spec!r}: want N or LO:HI")
    return lo, hi


class _Timer:
    """Wraps a function; sums its wall seconds, synchronising the card
    around each call so that the time is the work's, not the enqueue's."""

    def __init__(self, fn, device: torch.device):
        self.fn, self.device = fn, device
        self.seconds, self.calls = 0.0, 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, *a, **kw):
        self._sync()
        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        self._sync()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def run_engine(params, cfg, args, rng, device) -> dict:
    """Continuous batching of --requests prompts; prefill and decode timed
    apart, through the engine's `wrap` hook.  Every prefill's logits are
    checked finite after its timer stops."""
    lo, hi = args.prompt_len
    s_max = args.s_max or (hi + args.max_tokens + 8)
    timers, finite = {}, []

    def wrap(name, fn):
        timed = timers[name] = _Timer(fn, device)
        if name != "prefill":
            return timed

        def prefill(*a):
            logits, cache = timed(*a)
            finite.append(bool(torch.isfinite(logits).all()))
            return logits, cache

        return prefill

    engine = ServeEngine(params, cfg, batch=args.batch, s_max=s_max, wrap=wrap)
    pre, dec = timers["prefill"], timers["decode"]
    lens = rng.integers(lo, hi + 1, args.requests)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, n)).to(device) for n in lens]
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        engine.submit(i, p, args.max_tokens)
    steps = 0
    while engine.step():
        steps += 1
    dt = time.perf_counter() - t0
    tokens = sum(len(t) for t in engine.done.values())
    decoded = tokens - len(engine.done)  # each request's first token is the prefill's
    out = {"requests": len(engine.done), "tokens": tokens, "engine_steps": steps,
           "seconds": dt, "s_max": s_max, "prompt_tokens": int(lens.sum()),
           "prefills": pre.calls,
           "prefill_ms_per_request": pre.seconds / max(pre.calls, 1) * 1e3,
           "decode_steps": dec.calls, "decode_tokens": decoded,
           "decode_tokens_per_s": decoded / dec.seconds if dec.seconds else 0.0,
           "logits_finite": all(finite)}
    print(f"continuous batching: {out['requests']} requests, {tokens} tokens in "
          f"{dt:.1f}s, {steps} engine steps; prefill "
          f"{out['prefill_ms_per_request']:.1f} ms/request over "
          f"{out['prompt_tokens']} prompt tokens (s_max {s_max}), decode "
          f"{out['decode_tokens_per_s']:.1f} tok/s", flush=True)
    return out


def semantic_traffic(params, cfg, n: int, prompt_len: int, n_req: int, rng,
                     device) -> tuple[torch.Tensor, list, np.ndarray]:
    """The semantic tier's catalog and requests, after the paper's
    Independent Reference Model (Sec. V-A; `core/trace.py`'s `sift_like`).

    The catalog holds the results of n earlier prompts of prompt_len
    tokens, drawn on the device from SEED: row i is `embed_prompt` of
    prompt i.  A request is for a catalog object, as `sift_like`'s are
    (no jitter): it repeats that object's prompt.  Objects nearer the
    catalog barycenter are more popular, with a Zipf(ZIPF_A) ranked tail.
    The ranks are imposed directly: the barycentric distances of
    mean-pooled prompt embeddings differ only by parts in 1e4 to 1e5, and
    there `_barycentric_popularity`'s power-law fit clamps (beta = 900) to
    a near-uniform law.

    Returns the catalog (n, d_model) float32, the requests' prompts (int64)
    and the requested object ids, drawn with `rng`."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    tokens = torch.empty((n, prompt_len), dtype=torch.int32, device=device)
    catalog = torch.empty((n, cfg.d_model), dtype=torch.float32, device=device)
    for i in range(0, n, _EMBED_ROWS):
        j = min(n, i + _EMBED_ROWS)
        t = torch.randint(0, cfg.vocab, (j - i, prompt_len), generator=gen,
                          device=device)
        tokens[i:j] = t
        catalog[i:j] = embed_prompt(params, t)
    dist = torch.linalg.vector_norm(catalog - catalog.mean(dim=0), dim=1)
    rank = torch.empty(n, dtype=torch.float64, device=device)
    rank[torch.argsort(dist)] = torch.arange(1, n + 1, dtype=torch.float64,
                                             device=device)
    lam = rank ** -ZIPF_A
    ids = rng.choice(n, size=n_req, p=(lam / lam.sum()).cpu().numpy())
    return catalog, [tokens[i].long() for i in ids], ids


def run_semantic(params, cfg, args, rng, device, index_spec, policy_spec,
                 answer_cache=None, remote=None, resilience=None, mesh=None) -> dict:
    """The semantic tier over a --catalog x d_model catalog of earlier
    prompts' embeddings (`semantic_traffic`): --requests single queries,
    then --query-batches batches of --batch, then (with --arrival)
    --requests more through the online serving engine."""
    prompt_len = args.prompt_len[0]
    n_req = args.requests + args.query_batches * args.batch
    n_online = args.requests if args.arrival != "off" else 0
    t0 = time.perf_counter()
    catalog, prompts, ids = semantic_traffic(params, cfg, args.catalog, prompt_len,
                                             n_req + n_online, rng, device)
    online_prompts, prompts, ids = prompts[n_req:], prompts[:n_req], ids[:n_req]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    traffic_s = time.perf_counter() - t0
    payloads = [f"cached-result-{i}" for i in range(args.catalog)]
    s_max = args.s_max or (prompt_len + 4)

    def gen_fn(prompt_tokens):
        return generate(params, cfg, prompt_tokens.to(device)[None], steps=4,
                        s_max=s_max)

    gen_timer = _Timer(gen_fn, device)
    # under churn the tier starts on the warm prefix and the rest streams in
    n_warm = (max(int(round(args.churn_warm * args.catalog)), 1) if args.churn_rate > 0
              else args.catalog)
    t0 = time.perf_counter()
    lm = SemanticCachedLM(params, cfg, catalog[:n_warm], payloads[:n_warm], gen_timer,
                          h=args.cache_size, k=4, index_spec=index_spec,
                          policy_spec=policy_spec, remote=remote,
                          resilience=resilience, answer_cache=answer_cache, mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    churn = {"insert": n_warm, "expire": 0, "acc": 0.0, "events": 0, "seconds": 0.0}

    def churn_before(n_requests: int) -> None:
        """The rolling window's events due before the next n_requests:
        each adds the next catalog row and expires the oldest live one."""
        t_m = time.perf_counter()
        for _ in range(n_requests):
            churn["acc"] += args.churn_rate
            while churn["acc"] >= 1.0 and churn["insert"] < args.catalog:
                i = churn["insert"]
                lm.add_documents(catalog[i][None], [payloads[i]])
                lm.remove_documents([churn["expire"]])
                churn["insert"] += 1
                churn["expire"] += 1
                churn["events"] += 1
                churn["acc"] -= 1.0
        churn["seconds"] += time.perf_counter() - t_m

    if args.churn_rate == 0:
        del catalog
    t0 = time.perf_counter()
    for p in prompts[:args.requests]:
        churn_before(1)
        lm.query(p)
    for j in range(args.query_batches):
        i0 = args.requests + j * args.batch
        churn_before(args.batch)
        lm.query_batch(prompts[i0:i0 + args.batch])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    s = lm.stats
    out = {"policy": lm.policy_spec.to_dict(),
           "index": index_spec.to_dict() if index_spec else "exact",
           "requests": s.requests, "distinct_objects": len(set(ids.tolist())),
           "served_local": s.served_local, "objects": s.requests * lm.k,
           "generations": s.generated, "generate_share": s.generated / s.requests,
           "nag": lm.nag, "c_f": lm.policy.c_f, "traffic_s": traffic_s,
           "build_s": build_s, "seconds": dt, "generate_seconds": gen_timer.seconds,
           "us_per_request": dt / s.requests * 1e6,
           "us_per_request_without_generation":
               (dt - gen_timer.seconds) / s.requests * 1e6,
           "churn_rate": args.churn_rate, "churn_events": churn["events"],
           "mutation_s": churn["seconds"], "warm": n_warm}
    tier = f"policy={out['policy']}"
    if lm.policy_spec.name == "acai":
        tier += f", index={out['index']}"
    if mesh is not None:
        tier += f", mesh=(1, {args.mesh_shards})"
    if args.churn_rate > 0:
        tier += (f", churn={args.churn_rate:g} ({churn['events']} insert/expire events, "
                 f"{churn['seconds']:.3f} s)")
    print(f"semantic cache ({tier}, h={args.cache_size}, "
          f"catalog {args.catalog} x {cfg.d_model}): {s.requests} requests for "
          f"{out['distinct_objects']} objects, {s.served_local}/{out['objects']} "
          f"objects local, {s.generated} generations "
          f"({out['generate_share']:.2f} of requests), NAG={lm.nag:.4f}, "
          f"{out['us_per_request']:.0f} us/request "
          f"({out['us_per_request_without_generation']:.0f} without generation)",
          flush=True)
    if lm.answer_cache is not None:
        st = out["answer_cache"] = lm.answer_cache.stats()
        print(f"answer cache (capacity={st['capacity']}): hit rate "
              f"{st['hit_rate']:.3f} ({st['hits']}/{st['hits'] + st['misses']}), "
              f"{st['entries']} entries, {st['invalidations']} invalidations "
              f"(remove={st['inv_remove']} add={st['inv_add']} "
              f"refresh={st['inv_refresh']}), {st['scans_skipped']} scans skipped "
              f"of {st['scans'] + st['scans_skipped']}, unloads={st['unloads']} "
              f"reloads={st['reloads']}", flush=True)
    if remote is not None:
        ses = lm.policy.session
        c = out["resilience"] = ses.counters.to_dict()
        pct = ses.latency_percentiles()
        out["resilience"].update(pct, breaker_transitions=ses.breaker.transitions)
        print(f"resilience (fault={remote.spec.to_dict()}): "
              f"{c['remote_failures']} remote failures, {c['retries']} retries, "
              f"{c['degraded']} degraded, {c['shed']} shed, "
              f"{c['deadline_misses']} deadline misses, {c['hedges']} hedges, "
              f"{c['fast_fails']} breaker fast-fails, "
              f"{ses.breaker.transitions} breaker transitions, "
              f"p50={pct['p50_ms']:.1f}ms p99={pct['p99_ms']:.1f}ms", flush=True)
    if n_online:
        out["online"] = run_online(lm, args, params, online_prompts)
    return out


def run_online(lm, args, params, prompts) -> dict:
    """--requests requests of the semantic traffic through the online
    serving engine (virtual clock, the reference's service model); the
    embeddings go to the engine on the host."""
    service = ServiceModel()
    rate = args.offered_load * service.capacity_rps(args.batch)
    try:
        arrival = ArrivalSpec(kind=args.arrival, rate_rps=max(rate, 1.0),
                              seed=args.arrival_seed)
    except ValueError as e:
        raise SystemExit(str(e))
    reqs = embed_prompt(params, torch.stack(prompts).to(lm.device)).cpu().numpy()
    res = serve_trace_online(
        lm.policy, reqs, arrival,
        former=BatchFormerConfig(max_batch=args.batch,
                                 max_wait_ms=(args.batch_window_ms
                                              if args.batch_window_ms > 0 else None)),
        admission=AdmissionConfig(queue_cap=args.queue_cap,
                                  deadline_ms=args.shed_deadline_ms),
        service=service, slo_ms=args.slo_ms)
    out = {k: res[k] for k in ("requests", "served", "shed_total", "shed_share",
                               "mean_batch", "p50_ms", "p99_ms", "p999_ms",
                               "queue_p50_ms", "answer_hit_rate", "p50_step_s")}
    out["batch_hist"] = res["batch_hist"]
    out["nag"] = lm.policy.normalized_gain(float(res["gain"].sum()), res["requests"])
    line = (f"online serving (arrival={args.arrival} load={args.offered_load:g} "
            f"window={args.batch_window_ms:g}ms): {res['served']}/{res['requests']} "
            f"served, {res['shed_total']} shed, mean batch {res['mean_batch']:.2f}, "
            f"p50={res['p50_ms']:.1f}ms p99={res['p99_ms']:.1f}ms "
            f"p999={res['p999_ms']:.1f}ms (queue p50={res['queue_p50_ms']:.1f}ms), "
            f"NAG={out['nag']:.4f}")
    if args.slo_ms is not None:
        out["goodput_slo"] = res["goodput_slo"]
        line += f", goodput@{args.slo_ms:g}ms={res['goodput_slo']:.3f}"
    print(line, flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=_prompt_lens, default=(16, 16))
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--catalog", type=int, default=512)
    ap.add_argument("--cache-size", type=int, default=64)
    ap.add_argument("--remote-index", default="exact",
                    choices=("exact",) + registered_backends(),
                    help="remote-catalog index backend for the semantic "
                         "cache ('exact' = perfect-recall candidates)")
    ap.add_argument("--index-opt", action="append", default=[], metavar="KEY=VALUE",
                    help="index builder kwarg (repeatable), e.g. nlist=256")
    ap.add_argument("--policy", default="acai", choices=registered_policies(),
                    help="semantic-cache policy (the policy registry)")
    ap.add_argument("--policy-opt", action="append", default=[], metavar="KEY=VALUE",
                    help="policy spec param (repeatable), e.g. k_prime=8 "
                         "augmented=true")
    ap.add_argument("--churn-rate", type=float, default=0.0,
                    help="catalog churn: insert + expire events a request (a "
                         "rolling window over the catalog; 0 = frozen catalog)")
    ap.add_argument("--churn-warm", type=float, default=0.5,
                    help="share of --catalog live at the start under churn (the "
                         "rest is inserted over the run)")
    ap.add_argument("--mesh-shards", type=int, default=1,
                    help="shard the semantic tier over a (1, P) mesh, one process a "
                         "shard under torchrun --nproc-per-node P (1 = the "
                         "single-device tier)")
    ap.add_argument("--answer-cache", type=int, default=None, metavar="CAP",
                    help="answer-cache entry budget: memoize exact top-k index "
                         "answers in front of the index scan (0 = pass-through; "
                         "needs --remote-index, acai only)")
    ap.add_argument("--answer-cache-opt", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="AnswerCacheSpec field (repeatable), e.g. hit_ms=0.1 "
                         "idle_unload_ms=50")
    ap.add_argument("--query-batches", type=int, default=0)
    ap.add_argument("--s-max", type=int, default=0)
    ap.add_argument("--device", default=None)
    srv = ap.add_argument_group(
        "online serving (--arrival serves --requests more requests through the "
        "queued engine with dynamic batch formation)")
    srv.add_argument("--arrival", default="off", choices=("off",) + ARRIVAL_KINDS,
                     help="arrival process driving the request queue ('off' = "
                          "no online phase)")
    srv.add_argument("--offered-load", type=float, default=0.8,
                     help="open-loop arrival rate as a fraction of the service "
                          "model's max-batch capacity (1.0 = critically loaded)")
    srv.add_argument("--batch-window-ms", type=float, default=5.0,
                     help="batch former max wait (virtual ms) before a partial "
                          "batch dispatches; 0 = pure size trigger")
    srv.add_argument("--slo-ms", type=float, default=None,
                     help="latency SLO (virtual ms): report goodput = served "
                          "share meeting it")
    srv.add_argument("--queue-cap", type=int, default=None,
                     help="admission control: shed arrivals beyond this queue depth")
    srv.add_argument("--shed-deadline-ms", type=float, default=None,
                     help="admission control: shed queued requests whose estimated "
                          "completion would exceed this budget")
    srv.add_argument("--arrival-seed", type=int, default=0,
                     help="arrival-schedule seed (same seed = same schedule)")
    res = ap.add_argument_group(
        "resilient serving (any flag here routes the semantic tier through the "
        "resilient remote path)")
    res.add_argument("--remote-fault-rate", type=float, default=0.0,
                     help="per-attempt transient error probability")
    res.add_argument("--remote-fault-corrupt", type=float, default=0.0,
                     help="per-attempt corrupt-payload (NaN) probability")
    res.add_argument("--remote-fault-latency-ms", type=float, default=5.0,
                     help="median remote fetch latency (virtual ms)")
    res.add_argument("--remote-fault-outage", action="append", default=[],
                     metavar="START:END",
                     help="hard outage window in request indices (repeatable)")
    res.add_argument("--remote-fault-seed", type=int, default=0,
                     help="fault-schedule seed (same seed = same faults)")
    res.add_argument("--deadline-ms", type=float, default=None,
                     help="per-request deadline budget (virtual ms); a late "
                          "success counts as a miss")
    res.add_argument("--hedge-ms", type=float, default=None,
                     help="fire a hedged second request this far into a slow "
                          "attempt")
    res.add_argument("--retries", type=int, default=None,
                     help="extra attempts after the first (default 2)")
    args = ap.parse_args(argv)

    sharded = args.mesh_shards > 1
    if args.churn_rate < 0 or not 0.0 < args.churn_warm <= 1.0:
        raise SystemExit("--churn-rate must be >= 0 and --churn-warm in (0, 1]")
    try:
        policy_spec = PolicySpec(args.policy, parse_policy_opts(args.policy_opt))
    except ValueError as e:
        raise SystemExit(str(e))
    if args.policy != "acai":
        if args.remote_index != "exact":
            raise SystemExit(f"--policy {args.policy} serves from the exact server "
                             f"oracle; --remote-index only applies to acai")
        if sharded:
            raise SystemExit(f"--policy {args.policy} is a sequential baseline; "
                             f"--mesh-shards only applies to acai")
    index_spec = None
    if args.remote_index != "exact":
        try:
            index_spec = IndexSpec(args.remote_index, parse_index_opts(args.index_opt))
        except ValueError as e:
            raise SystemExit(str(e))
        if args.remote_index in registered_backends(sharded=True) and not sharded:
            raise SystemExit(f"--remote-index {args.remote_index} is a sharded backend: "
                             f"pass --mesh-shards P (P > 1)")
        if args.remote_index not in registered_backends(sharded=True) and sharded:
            raise SystemExit(f"--remote-index {args.remote_index} is single-device; with "
                             f"--mesh-shards use one of "
                             f"{('exact',) + registered_backends(sharded=True)}")
    elif args.index_opt:
        raise SystemExit("--index-opt needs --remote-index")
    if sharded and args.answer_cache is not None:
        raise SystemExit("--answer-cache needs the single-device cache (the sharded step "
                         "owns candidate generation)")
    answer_cache = _answer_cache_spec(args, index_spec)
    if args.churn_rate > 0 and sharded and index_spec is not None:
        raise SystemExit("--churn-rate on a sharded mesh serves through the exact masked "
                         "scan: drop --remote-index (mutating a sharded index backend "
                         "online is not implemented)")
    remote, resilience = _resilience(args)
    if sharded and remote is not None:
        raise SystemExit("the resilient serving path needs the single-device cache (a "
                         "fault-aware sharded step is not implemented)")
    if sharded and args.catalog % args.mesh_shards:
        raise SystemExit("--catalog must divide by --mesh-shards")
    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    own_world = False
    mesh = None
    if sharded:
        own_world = _join_world(args)
        device = resolve_device("cuda" if args.device in (None, "cuda") else args.device)
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((1, args.mesh_shards), device_type=device.type)
    else:
        device = resolve_device(args.device)
    quiet = mesh is not None and torch.distributed.get_rank() != 0
    try:
        with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
            params = init_params(cfg, seed=SEED, device=device)
            rng = np.random.default_rng(SEED)
            figures = {"arch": cfg.name, "device": str(device),
                       "engine": run_engine(params, cfg, args, rng, device)}
            if mesh is not None:
                figures["mesh_shards"] = args.mesh_shards
            if args.catalog > 0:
                figures["semantic"] = run_semantic(params, cfg, args, rng, device,
                                                   index_spec, policy_spec, answer_cache,
                                                   remote, resilience, mesh)
    finally:
        if own_world:
            torch.distributed.destroy_process_group()
    return figures


def _join_world(args) -> bool:
    """Make sure this process is a rank of a world of --mesh-shards ranks:
    the caller's, or torchrun's (joined here, the card's device by
    LOCAL_RANK).  Returns whether the launcher joined it (and so leaves it)."""
    dist = torch.distributed
    p = args.mesh_shards
    joined = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(
                f"--mesh-shards {p} runs one process a shard: start the launcher under "
                f"torchrun --nproc-per-node {p} (this process is in no "
                f"torch.distributed world)")
        cuda = args.device in (None, "cuda")
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if cuda else "gloo")
        joined = True
    if dist.get_world_size() != p:
        world = dist.get_world_size()
        if joined:
            dist.destroy_process_group()
        raise SystemExit(f"--mesh-shards {p} needs a world of {p} ranks, one a shard; "
                         f"this one has {world} (torchrun --nproc-per-node {p})")
    return joined


def _answer_cache_spec(args, index_spec):
    """The answer tier's spec from the flags (None when off), with the
    reference's validation."""
    if args.answer_cache is None:
        if args.answer_cache_opt:
            raise SystemExit("--answer-cache-opt needs --answer-cache")
        return None
    if args.policy != "acai":
        raise SystemExit(f"--policy {args.policy} serves oracle-exact (memoized) "
                         f"answers by construction; --answer-cache only applies "
                         f"to acai")
    if index_spec is None:
        raise SystemExit("--answer-cache fronts an index backend: pass "
                         "--remote-index (flat = the exact fused scan)")
    try:
        return AnswerCacheSpec(capacity=args.answer_cache,
                               **parse_answer_cache_opts(args.answer_cache_opt))
    except (TypeError, ValueError) as e:
        raise SystemExit(str(e))


def _resilience(args):
    """(remote, resilience) from the fault / deadline / hedge / retry
    flags, both None when none is given (the reference's rule: any of
    them routes the tier through the resilient path)."""
    faulty = (args.remote_fault_rate > 0 or args.remote_fault_corrupt > 0
              or args.remote_fault_outage or args.remote_fault_latency_ms != 5.0
              or args.remote_fault_seed != 0)
    if not (faulty or args.deadline_ms is not None or args.hedge_ms is not None
            or args.retries is not None):
        return None, None
    try:
        fault = FaultSpec(error_rate=args.remote_fault_rate,
                          corrupt_rate=args.remote_fault_corrupt,
                          latency_ms=args.remote_fault_latency_ms,
                          outages=parse_outage_windows(args.remote_fault_outage),
                          seed=args.remote_fault_seed)
    except ValueError as e:
        raise SystemExit(str(e))
    retry = RetryConfig(max_retries=args.retries) if args.retries is not None else RetryConfig()
    return FaultyRemote(fault), ResilienceConfig(deadline_ms=args.deadline_ms, retry=retry,
                                                 hedge_ms=args.hedge_ms)


if __name__ == "__main__":
    main(sys.argv[1:])
