"""State-of-the-art similarity-caching baselines (paper Sec. II and Sec. V).

Port of `repro.core.baselines`.  All baselines maintain an ordered list of
key->value pairs (key = a past request embedding, value = its k' closest
catalog objects) and update it LRU-style; the cache size is h objects,
i.e. h // k' entries (the paper's inefficiency (i): overlapping value sets
still consume separate slots).

  LRU      — exact-match only (k' = k): hit iff the request equals a key.
  SIM-LRU  — l = 1: hit iff the closest key is within C_theta.
  CLS-LRU  — SIM-LRU + hypersphere-center updates (medoid of served history).
  RND-LRU  — SIM-LRU with randomised miss: P(miss | d) increasing in d.
  QCACHE   — k' = k, l > 1: merge the l closest entries' values; hit iff
             >= 2 selected objects are *guaranteed* true neighbours (ball
             containment argument of Falchi et al.) or the distance profile
             matches the stored entries' profiles.

The *update* logic is sequential plain python over numpy float32, as in
the reference (these are order-dependent data-structure policies), and so
are the per-batch distance tables (`KeyValueCache.step_batch`: one (B, M)
float32 GEMM over every object the batch can touch plus one (B, E) key
GEMM, in the reference's expression order): given the same oracle answers
every hit decision is the reference's.  What scales with the catalog is
the server oracle's exact kNN scan, and that runs on the device:
`ServerOracle` keeps the catalog twice, a host copy for the tables and a
device copy scanned by `ops.topk_l2_fused` (the `l2_topk` kernel on the
card, the chunked plain version on the CPU), so a 1M-row catalog never
forms a (B, N) matrix.

`augmented=True` gives every policy AÇAI's serving rule (Fig. 7/11-13 of the
paper): the answer is composed per-object from the union of cached objects
(cost c_d) and the server's kNN (cost c_d + c_f), while the cache-update
logic stays untouched.

Geometric tests (QCACHE) run in *Euclidean* distance (triangle inequality);
costs are whatever the CostModel says (squared Euclidean by default), as in
the paper's experiments.  `step_degraded` is the resilient tier's
local-only serve under a remote failure (`repro_torch.serve.resilience`).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops


def host_f32(a) -> np.ndarray:
    """A C-contiguous float32 numpy copy of an array or a tensor on any
    device (no copy when it already is one)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float32)


def answer_d2(q: np.ndarray, catalog: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """(B, k) float32 squared distances of queries q (B, d) to the catalog
    rows `ids` (B, k), +inf at id -1: ||q||^2 - 2 q.x + ||x||^2 clamped at
    0, the expression of the reference's scan and of `_dist2_cross`."""
    xs = catalog[np.maximum(ids, 0)]                       # (B, k, d)
    qn = (q * q).sum(1)[:, None]
    d2 = np.maximum(qn - 2.0 * np.einsum("bd,bkd->bk", q, xs) + (xs * xs).sum(-1), 0.0)
    return np.where(ids >= 0, d2, np.float32(np.inf)).astype(np.float32)


# --------------------------------------------------------------------------
# Server oracle: exact kNN answers for every trace request.
# --------------------------------------------------------------------------

class ServerOracle:
    """Exact kNN answers from the remote server.

    Trace mode (`requests` given): every answer is precomputed in blocks of
    512 queries through the fused scan and `knn(t, k)` is a table lookup.

    Online mode (`requests=None`, the serving tier): `extend(rs)` computes
    answers for newly arriving requests on demand — one scan per
    mini-batch — appends them to the table and returns their trace
    positions, so the policies' `knn(t, k)` contract is identical in both
    modes.  With `retain_all=False` only the latest extend's block is kept
    (policies never re-read past positions): `knn(t, k)` then only accepts
    positions from the most recent block.

    The scan runs on `device` (the card by default) over a device copy of
    the catalog, made at the first scan; `chunk` (derived from
    `mem_budget_mb` as in the reference) is the plain version's catalog
    rows a step on the CPU, the kernel takes the whole catalog.

    Mutable catalog: `add_objects(embs)` appends rows and
    `remove_objects(ids)` tombstones them through a validity mask the scan
    honors (`valid`), so a removed object never appears in a kNN answer
    again; `compact()` drops the dead rows.  Each mutation invalidates the
    retained answer table: stale `knn(t)` reads raise KeyError, and
    callers re-answer through `extend` / the online ts=None path or
    repair them with `ensure`.
    """

    _QUERY_BLOCK = 512

    def __init__(self, catalog, requests=None, kmax: int = 128,
                 chunk: Optional[int] = None, mem_budget_mb: int = 64,
                 retain_all: bool = True, device=None):
        self.catalog = host_f32(catalog)
        self.device = resolve_device(device)
        n = self.catalog.shape[0]
        self.kmax = min(kmax, n)
        if chunk is None:
            budget_rows = (mem_budget_mb * 2 ** 20) // (self._QUERY_BLOCK * 4)
            chunk = int(np.clip(budget_rows, 256, max(n, 256)))
        self.chunk = chunk
        self.retain_all = retain_all
        self._cat_dev = None  # device catalog, made at the first scan
        self._valid_dev = None
        self.valid = np.ones(n, bool)  # liveness mask (tombstones)
        self._mutated = False
        self.t = 0
        self._base = 0  # trace position of table row 0
        self.ids = np.empty((0, self.kmax), np.int32)
        self.d2 = np.empty((0, self.kmax), np.float32)  # squared euclidean
        # stale-read repair block: per-position recomputed answers from
        # `ensure`, each booked as a remote call
        self._repaired: dict[int, tuple] = {}
        self.remote_recomputes = 0
        if requests is not None:
            self.extend(requests)

    def _scan(self, q: np.ndarray):
        """One fused top-kmax scan of the catalog: (B, d) float32 queries ->
        (ids (B, kmax) int32, d2 (B, kmax) float32 ascending).

        The device scan (`ops.topk_l2_fused`: the kernel takes any N, so
        the device catalog is never padded; a mutated catalog passes its
        tombstones as `valid`) picks the ids; `answer_d2` then evaluates
        their distances on the host in float32, in the expression the
        distance tables use.  The policies compare these distances with
        the tables' (QCACHE's ball-containment and profile tests sit on
        such ties, a request's distance to itself among them), so both
        must carry the same rounding whichever device scanned; the
        kernel's own distances carry its 3xTF32 rounding."""
        if self._cat_dev is None:
            self._cat_dev = torch.from_numpy(self.catalog).to(self.device)
            self._valid_dev = (torch.from_numpy(self.valid).to(self.device)
                               if self._mutated else None)
        _, ids = ops.topk_l2_fused(
            torch.from_numpy(np.ascontiguousarray(q)).to(self.device), self._cat_dev,
            self.kmax, chunk=min(self.chunk, self._cat_dev.shape[0]),
            valid=self._valid_dev)
        ids = ids.cpu().numpy().astype(np.int32)
        return ids, answer_d2(q, self.catalog, ids)

    # -- online catalog mutation (DESIGN.md §10) ----------------------------

    def _invalidate_answers(self) -> None:
        """Precomputed answers are stale against a mutated catalog: drop
        the retained block so stale positions raise instead of silently
        serving removed/outdated kNN sets."""
        self._mutated = True
        self._cat_dev = None
        self._base = self.t
        self.ids = np.empty((0, self.kmax), np.int32)
        self.d2 = np.empty((0, self.kmax), np.float32)
        self._repaired = {}  # repairs answer the *old* catalog: stale too

    def add_objects(self, embs: np.ndarray) -> np.ndarray:
        """Append new catalog rows; returns their (monotonic) ids."""
        embs = np.atleast_2d(host_f32(embs))
        ids = np.arange(self.catalog.shape[0],
                        self.catalog.shape[0] + embs.shape[0], dtype=np.int32)
        self.catalog = np.concatenate([self.catalog, embs])
        self.valid = np.concatenate([self.valid, np.ones(len(ids), bool)])
        self.kmax = min(max(self.kmax, 1), self.catalog.shape[0])
        self._invalidate_answers()
        return ids

    def remove_objects(self, ids) -> None:
        """Tombstone catalog rows: they vanish from every future answer."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if len(ids) == 0:
            return
        if ids.min() < 0 or ids.max() >= self.catalog.shape[0]:
            raise ValueError(
                f"remove_objects: ids outside [0, {self.catalog.shape[0]})")
        if not self.valid[ids].all():
            raise ValueError("remove_objects: some rows are already dead")
        self.valid[ids] = False
        self._invalidate_answers()

    def compact(self) -> np.ndarray:
        """Epoch compaction (DESIGN.md §14): drop tombstoned rows and
        renumber the survivors in ascending-id order, so the catalog stops
        growing with total-ever-seen.  Returns the (old_n,) int32 remap
        (new row id, or -1 for dead rows); the caller owns pushing it to
        every id holder (cache entries, payload stores).  Precomputed
        answers hold old ids and are invalidated wholesale."""
        live = np.nonzero(self.valid)[0]
        remap = np.full(self.catalog.shape[0], -1, np.int32)
        remap[live] = np.arange(live.size, dtype=np.int32)
        self.catalog = np.ascontiguousarray(self.catalog[live])
        self.valid = np.ones(live.size, bool)
        self.kmax = min(max(self.kmax, 1), max(self.catalog.shape[0], 1))
        self._invalidate_answers()
        return remap

    def extend(self, requests: np.ndarray) -> np.ndarray:
        """Answer kNN for `requests` (B, d), append to the table, and
        return their trace positions (B,)."""
        # cast BEFORE the gemm: float64 request streams must not promote
        # the (block, chunk) distance intermediates
        q = np.ascontiguousarray(requests, dtype=np.float32)
        b = q.shape[0]
        ids = np.empty((b, self.kmax), np.int32)
        d2 = np.empty((b, self.kmax), np.float32)
        for s in range(0, b, self._QUERY_BLOCK):
            ids[s:s + self._QUERY_BLOCK], d2[s:s + self._QUERY_BLOCK] = \
                self._scan(q[s:s + self._QUERY_BLOCK])
        ts = np.arange(self.t, self.t + b)
        if self.retain_all:
            self.ids = np.concatenate([self.ids, ids]) if self.t else ids
            self.d2 = np.concatenate([self.d2, d2]) if self.t else d2
        else:  # keep only this block: O(B) memory on unbounded streams
            self._base = self.t
            self.ids, self.d2 = ids, d2
        self.t += b
        return ts

    def _row(self, t: int) -> int:
        row = t - self._base
        if row < 0 or row >= self.ids.shape[0]:
            raise KeyError(
                f"trace position {t} is outside the retained answer block "
                f"[{self._base}, {self.t}) — precompute it (constructor "
                f"requests= / extend) or pass ts=None for online mode")
        return row

    def ensure(self, ts: np.ndarray, rs: np.ndarray) -> int:
        """Repair stale answer-table reads (DESIGN.md §11): recompute the
        answers for any of `ts` outside the retained block from the
        request embeddings `rs` (aligned with `ts`) and hold them in a
        per-batch repair block that `knn`/`knn_block`/`empty_cost`
        consult first.  Each recomputed position is booked as a remote
        call in `remote_recomputes` — this IS a server fetch, just an
        explicit one — so churned baselines compose with the fault model
        instead of crashing on a stale KeyError.  Returns the number of
        positions recomputed (0 = everything was already retained)."""
        ts = np.atleast_1d(np.asarray(ts, np.int64))
        rs = np.atleast_2d(np.ascontiguousarray(rs, np.float32))
        rows = ts - self._base
        need = np.nonzero((rows < 0) | (rows >= self.ids.shape[0]))[0]
        if need.size == 0:
            return 0
        # repairs are per-batch: policies never re-read past positions,
        # so the block is reset instead of growing without bound
        self._repaired = {}
        for s in range(0, need.size, self._QUERY_BLOCK):
            blk = need[s:s + self._QUERY_BLOCK]
            ids, d2 = self._scan(rs[blk])
            for j, pos in enumerate(blk):
                self._repaired[int(ts[pos])] = (ids[j], d2[j])
        self.remote_recomputes += int(need.size)
        return int(need.size)

    def knn(self, t: int, k: int):
        rep = self._repaired.get(int(t))
        if rep is not None:
            return rep[0][:k], rep[1][:k]
        row = self._row(t)
        return self.ids[row, :k], self.d2[row, :k]

    def knn_block(self, ts: np.ndarray, k: int) -> np.ndarray:
        """Answer ids for a whole batch of trace positions: (B, k)."""
        ts = np.asarray(ts)
        rows = ts - self._base
        retained = (rows >= 0) & (rows < self.ids.shape[0])
        if retained.all():
            return self.ids[rows, :k]
        # stale positions resolve through the repair block (or raise,
        # via knn -> _row, when no ensure() repaired them)
        out = np.empty((len(ts), k), np.int32)
        for j, t in enumerate(ts):
            out[j] = self.knn(int(t), k)[0]
        return out

    def empty_cost(self, t: int, k: int, c_f: float, metric: str = "sqeuclidean"):
        rep = self._repaired.get(int(t))
        if rep is not None:
            d2 = rep[1][:k]
        else:
            d2 = self.d2[self._row(t), :k]
        d = d2 if metric == "sqeuclidean" else np.sqrt(d2)
        return float(d.sum() + k * c_f)


def _dist2(q: np.ndarray, pts: np.ndarray) -> np.ndarray:
    diff = pts - q[None, :]
    return np.maximum((diff * diff).sum(1), 0.0)


def _dist2_cross(qs: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(B, d) x (M, d) -> (B, M) squared distances, one float32 GEMM."""
    qs = qs.astype(np.float32, copy=False)
    pts = pts.astype(np.float32, copy=False)
    qn = (qs * qs).sum(1)[:, None]
    pn = (pts * pts).sum(1)[None, :]
    return np.maximum(qn - 2.0 * qs @ pts.T + pn, 0.0)


@dataclasses.dataclass
class StepResult:
    cost: float
    gain: float
    hit: bool
    served_local: int
    fetched: int  # objects fetched into the cache this step


class _Entry:
    __slots__ = ("key_emb", "value_ids", "value_d2_key", "history", "key_tag")

    def __init__(self, key_emb, value_ids, value_d2_key, key_tag=None):
        self.key_emb = key_emb
        self.value_ids = value_ids            # (k',) catalog ids
        self.value_d2_key = value_d2_key      # (k',) squared dist to key
        self.history: deque = deque(maxlen=16)
        # provenance of key_emb for the batched distance tables:
        # ("req", j) = request j of the active mini-batch,
        # ("cat", i) = catalog object i (CLS-LRU medoid), None = older.
        self.key_tag = key_tag


class _BatchCtx:
    """Per-mini-batch distance tables (see KeyValueCache.step_batch)."""

    __slots__ = ("b", "key_tab", "eid_col", "req_gram", "cat_tab", "cat_ids")

    def __init__(self, b, key_tab, eid_col, req_gram, cat_tab, cat_ids):
        self.b = b                  # current request position in the batch
        self.key_tab = key_tab      # (B, E0) d2 to batch-start entry keys
        self.eid_col = eid_col      # eid -> column of key_tab
        self.req_gram = req_gram    # (B, B) d2 between batch requests
        self.cat_tab = cat_tab      # (B, M) d2 to the candidate object set
        self.cat_ids = cat_ids      # (M,) sorted catalog ids of cat_tab

    def obj_d2(self, ids: np.ndarray):
        if not len(self.cat_ids):
            return None
        pos = np.searchsorted(self.cat_ids, ids)
        pos = np.minimum(pos, len(self.cat_ids) - 1)
        hit = self.cat_ids[pos] == ids
        if not hit.all():  # safety net; the candidate set should cover ids
            return None
        return self.cat_tab[self.b, pos]


class KeyValueCache:
    """Shared machinery for the LRU-family policies."""

    name = "base"

    def __init__(self, catalog: np.ndarray, oracle: ServerOracle, *, h: int,
                 k: int, c_f: float, k_prime: Optional[int] = None,
                 c_theta: Optional[float] = None, metric: str = "sqeuclidean",
                 augmented: bool = False, seed: int = 0):
        self.catalog = catalog
        self.oracle = oracle
        self.h, self.k = h, k
        self.k_prime = k_prime or k
        self.max_entries = max(h // self.k_prime, 1)
        self.c_f = c_f
        self.c_theta = c_theta if c_theta is not None else 1.5 * c_f
        self.metric = metric
        self.augmented = augmented
        self.rng = np.random.default_rng(seed)
        self.entries: "OrderedDict[int, _Entry]" = OrderedDict()  # MRU first
        self._next_id = 0
        self._ctx: Optional[_BatchCtx] = None

    # -- cost helpers -------------------------------------------------------

    def _cost(self, d2: np.ndarray) -> np.ndarray:
        return d2 if self.metric == "sqeuclidean" else np.sqrt(d2)

    def cached_object_ids(self) -> np.ndarray:
        if not self.entries:
            return np.empty((0,), np.int32)
        return np.unique(np.concatenate([e.value_ids for e in self.entries.values()]))

    def drop_objects(self, ids) -> int:
        """Invalidate cached entries referencing removed catalog objects
        (mutable catalog, DESIGN.md §10): an entry whose value set lost a
        member no longer answers its key correctly, so the whole entry is
        evicted — the LRU logic refetches on the next miss.  Returns the
        number of entries dropped."""
        dead = set(int(i) for i in np.atleast_1d(np.asarray(ids)))
        doomed = [eid for eid, e in self.entries.items()
                  if dead.intersection(int(v) for v in e.value_ids)]
        for eid in doomed:
            del self.entries[eid]
        return len(doomed)

    def remap_objects(self, remap: np.ndarray) -> None:
        """Rewrite every entry's value ids through a compaction remap
        (DESIGN.md §14).  Entries only hold live objects (drop_objects
        evicts on removal), so all ids must land on a new row; a -1 here
        means the caller compacted without draining removals first."""
        for e in self.entries.values():
            new_ids = remap[e.value_ids]
            if (new_ids < 0).any():
                raise ValueError(
                    "remap_objects: cached entry references a dead row — "
                    "drop_objects must run before compaction")
            e.value_ids = new_ids.astype(e.value_ids.dtype)

    # -- batched distance tables -------------------------------------------

    def _obj_d2(self, r_emb: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Squared distances request -> catalog[ids]; table lookup when a
        mini-batch context is active, direct numpy otherwise."""
        if self._ctx is not None:
            d2 = self._ctx.obj_d2(np.asarray(ids))
            if d2 is not None:
                return d2
        return _dist2(r_emb, self.catalog[ids])

    def _key_d2(self, r_emb: np.ndarray) -> np.ndarray:
        """Squared distances request -> every entry key (entry order)."""
        ctx = self._ctx
        if ctx is None:
            keys = np.stack([e.key_emb for e in self.entries.values()])
            return _dist2(r_emb, keys)
        out = np.empty(len(self.entries), np.float32)
        missing = []
        for j, (eid, e) in enumerate(self.entries.items()):
            col = ctx.eid_col.get(eid)
            if col is not None and e.key_tag is None:
                out[j] = ctx.key_tab[ctx.b, col]
            elif e.key_tag is not None and e.key_tag[0] == "req":
                out[j] = ctx.req_gram[ctx.b, e.key_tag[1]]
            elif e.key_tag is not None and e.key_tag[0] == "cat":
                d2 = ctx.obj_d2(np.asarray([e.key_tag[1]]))
                if d2 is None:
                    missing.append(j)
                else:
                    out[j] = d2[0]
            else:
                missing.append(j)
        if missing:  # safety net — keys the tables do not cover
            vals = list(self.entries.values())
            for j in missing:
                out[j] = _dist2(r_emb, vals[j].key_emb[None, :])[0]
        return out

    def step_batch(self, ts: np.ndarray, rs: np.ndarray) -> list:
        """Serve a request mini-batch: the distance math runs as two
        float32 GEMMs over everything the batch can touch, then the
        sequential hit/update loop consumes the tables.  Returns the
        per-request StepResult list (same semantics as calling `step` in
        a loop, with GEMM- instead of per-row-accumulated distances)."""
        rs = np.ascontiguousarray(rs, dtype=np.float32)
        b = rs.shape[0]
        # hit tests: distances to the keys existing at batch start + the
        # request gram (keys inserted during the batch are batch requests)
        eid_col = {eid: j for j, eid in enumerate(self.entries)}
        if eid_col:
            keys = np.stack([e.key_emb for e in self.entries.values()])
            key_tab = _dist2_cross(rs, keys)
        else:
            key_tab = np.empty((b, 0), np.float32)
        req_gram = _dist2_cross(rs, rs)
        # serving costs: every object the batch can cache or serve = the
        # batch-start cache content + each request's k' server answers;
        # positions the (possibly churned) oracle no longer retains are
        # repaired first — each a booked remote recompute (DESIGN.md §11)
        self.oracle.ensure(np.asarray(ts), rs)
        cached = self.cached_object_ids()
        srv = self.oracle.knn_block(ts, max(self.k, self.k_prime))
        cat_ids = np.unique(np.concatenate([cached.ravel(), srv.ravel()]))
        cat_tab = _dist2_cross(rs, self.catalog[cat_ids])
        # entries created before this batch resolve via eid_col
        for e in self.entries.values():
            if e.key_tag is not None and e.key_tag[0] == "req":
                e.key_tag = None
        ctx = _BatchCtx(0, key_tab, eid_col, req_gram, cat_tab, cat_ids)
        self._ctx = ctx
        try:
            out = []
            for j, (t, r) in enumerate(zip(np.asarray(ts), rs)):
                ctx.b = j
                out.append(self.step(int(t), r))
        finally:
            self._ctx = None
        return out

    # -- LRU bookkeeping ----------------------------------------------------

    def _touch(self, eid: int):
        self.entries.move_to_end(eid, last=False)

    def _insert(self, r_emb: np.ndarray, ids: np.ndarray, d2: np.ndarray) -> int:
        eid = self._next_id
        self._next_id += 1
        tag = None
        if self._ctx is not None:
            tag = ("req", self._ctx.b)
        self.entries[eid] = _Entry(r_emb.copy(), ids.copy(), d2.copy(),
                                   key_tag=tag)
        self.entries.move_to_end(eid, last=False)
        evicted = 0
        while len(self.entries) > self.max_entries:
            self.entries.popitem(last=True)
            evicted += 1
        return evicted

    # -- serving ------------------------------------------------------------

    def _serve_from_ids(self, t: int, r_emb: np.ndarray, local_ids: np.ndarray
                        ) -> StepResult:
        """AÇAI-style per-object composition over local_ids + server kNN."""
        srv_ids, srv_d2 = self.oracle.knn(t, self.k)
        if local_ids.size:
            loc_d2 = self._obj_d2(r_emb, local_ids)
            costs = np.concatenate([self._cost(loc_d2), self._cost(srv_d2) + self.c_f])
            obj = np.concatenate([local_ids, srv_ids])
            is_local = np.concatenate([np.ones(local_ids.size, bool),
                                       np.zeros(self.k, bool)])
        else:
            costs = self._cost(srv_d2) + self.c_f
            obj = srv_ids
            is_local = np.zeros(self.k, bool)
        # dedup: a cached object also in the server answer keeps the cheap copy
        order = np.argsort(costs, kind="stable")
        seen, pick = set(), []
        for p in order:
            if int(obj[p]) in seen:
                continue
            seen.add(int(obj[p]))
            pick.append(p)
            if len(pick) == self.k:
                break
        pick = np.array(pick)
        cost = float(costs[pick].sum())
        served_local = int(is_local[pick].sum())
        gain = self.oracle.empty_cost(t, self.k, self.c_f, self.metric) - cost
        return StepResult(cost, gain, served_local > 0, served_local, 0)

    def _answer_cost_local(self, t: int, r_emb: np.ndarray, ids: np.ndarray
                           ) -> StepResult:
        """Serve k objects entirely from `ids` (approximate hit)."""
        d2 = self._obj_d2(r_emb, ids)
        order = np.argsort(d2, kind="stable")[: self.k]
        cost = float(self._cost(d2[order]).sum())
        gain = self.oracle.empty_cost(t, self.k, self.c_f, self.metric) - cost
        return StepResult(cost, gain, True, self.k, 0)

    def _answer_cost_miss(self, t: int) -> StepResult:
        cost = self.oracle.empty_cost(t, self.k, self.c_f, self.metric)
        return StepResult(cost, 0.0, False, 0, self.k_prime)

    def step_degraded(self, r_emb: np.ndarray, *, ceiling: float = 2.0):
        """Remote-failure serve of the resilient tier: answer from cached
        objects only.  No oracle read and no entry insert or touch — the
        LRU state must not learn from a request whose fetch failed.
        Cached objects within `ceiling x` the request's best healthy-serve
        cost (nearest catalog dissimilarity + c_f, the ceiling of
        `repro_torch.serve.resilience.degraded_serve`) are eligible; with
        none the request is shed.  The empty-cache reference cost is
        computed locally against the live catalog (distances are
        edge-local metadata), so gains stay comparable with the healthy
        path's.

        Returns (StepResult, shed: bool)."""
        r_emb = np.asarray(r_emb, np.float32)
        valid = getattr(self.oracle, "valid", None)
        cat = (self.catalog if valid is None
               else self.catalog[valid[: len(self.catalog)]])
        d_all = self._cost(np.sort(_dist2(r_emb, cat))[: self.k])
        empty_slots = d_all + self.c_f  # j-th cheapest all-remote answer
        empty_cost = float(empty_slots.sum())
        ids = self.cached_object_ids()
        if ids.size == 0:
            return StepResult(empty_cost, 0.0, False, 0, 0), True
        d_loc = self._cost(np.sort(_dist2(r_emb, self.catalog[ids])))
        d_loc = d_loc[d_loc <= ceiling * (d_all[0] + self.c_f)][: self.k]
        if d_loc.size == 0:
            return StepResult(empty_cost, 0.0, False, 0, 0), True
        # per-slot pairing against the empty-cache answer, clamped at 0
        gain = float(np.maximum(empty_slots[: d_loc.size] - d_loc, 0.0).sum())
        return StepResult(float(d_loc.sum()), gain, True, int(d_loc.size),
                          0), False

    # -- per-policy hooks ---------------------------------------------------

    def _closest_entry(self, r_emb: np.ndarray):
        if not self.entries:
            return None, np.inf
        eids = list(self.entries.keys())
        d2 = self._key_d2(r_emb)
        j = int(np.argmin(d2))
        return eids[j], self._cost(np.array([d2[j]]))[0]

    def _is_hit(self, t: int, r_emb: np.ndarray):
        raise NotImplementedError

    def _on_hit(self, t, r_emb, eid):
        self._touch(eid)

    def step(self, t: int, r_emb: np.ndarray) -> StepResult:
        hit, eid = self._is_hit(t, r_emb)
        if hit:
            self._on_hit(t, r_emb, eid)
            entry = self.entries[eid]
            if self.augmented:
                res = self._serve_from_ids(t, r_emb, self.cached_object_ids())
            else:
                res = self._answer_cost_local(t, r_emb, entry.value_ids)
            return res
        ids, d2 = self.oracle.knn(t, self.k_prime)
        self._insert(r_emb, ids, d2)
        if self.augmented:
            res = self._serve_from_ids(t, r_emb, self.cached_object_ids())
            return StepResult(res.cost, res.gain, res.hit, res.served_local,
                              self.k_prime)
        return self._answer_cost_miss(t)


class LRU(KeyValueCache):
    """Naive exact-match similarity cache (paper Sec. V-B)."""

    name = "LRU"

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("k_prime", kwargs.get("k", None))
        super().__init__(*args, **kwargs)
        self._key_lookup: dict[bytes, int] = {}

    def _is_hit(self, t, r_emb):
        eid = self._key_lookup.get(r_emb.tobytes())
        return (eid is not None and eid in self.entries), eid

    def _insert(self, r_emb, ids, d2):
        evicted = super()._insert(r_emb, ids, d2)
        eid = next(iter(self.entries))
        self._key_lookup[r_emb.tobytes()] = eid
        return evicted


class SimLRU(KeyValueCache):
    name = "SIM-LRU"

    def _is_hit(self, t, r_emb):
        eid, d = self._closest_entry(r_emb)
        return (eid is not None and d <= self.c_theta), eid


class RndLRU(SimLRU):
    """SIM-LRU with randomised hit decision: P(miss) grows with d."""

    name = "RND-LRU"

    def _is_hit(self, t, r_emb):
        eid, d = self._closest_entry(r_emb)
        if eid is None:
            return False, None
        p_miss = min(1.0, float(d) / max(self.c_theta, 1e-12))
        return (self.rng.random() >= p_miss), eid


class ClsLRU(SimLRU):
    """SIM-LRU + center updates: on a hit the entry's key moves to the medoid
    of its served-request history (pushes intersecting hyperspheres apart)."""

    name = "CLS-LRU"

    def _on_hit(self, t, r_emb, eid):
        super()._on_hit(t, r_emb, eid)
        e = self.entries[eid]
        e.history.append(r_emb.copy())
        if len(e.history) >= 2:
            hist = np.stack(e.history)
            cand = self.catalog[e.value_ids]
            # medoid: cached object minimising total distance to the history
            tot = ((cand[:, None, :] - hist[None, :, :]) ** 2).sum(-1).sum(1)
            j = int(np.argmin(tot))
            new_center = cand[j]
            e.key_emb = new_center.copy()
            e.key_tag = ("cat", int(e.value_ids[j]))
            e.value_d2_key = _dist2(new_center, cand)


class QCache(KeyValueCache):
    """QCACHE (Falchi et al. 2012): k' = k, search the l closest entries."""

    name = "QCACHE"

    def __init__(self, *args, l: Optional[int] = None, theta_guaranteed: int = 2,
                 profile_tol: float = 1.25, **kwargs):
        kwargs.setdefault("k_prime", kwargs.get("k"))
        super().__init__(*args, **kwargs)
        self.l = l  # None => all entries (paper: l = h/k)
        self.theta_guaranteed = theta_guaranteed
        self.profile_tol = profile_tol

    def _is_hit(self, t, r_emb):
        if not self.entries:
            return False, None
        eids = list(self.entries.keys())
        dk = np.sqrt(self._key_d2(r_emb))  # euclidean for geometry
        take = np.argsort(dk, kind="stable")
        if self.l is not None:
            take = take[: self.l]
        merged_ids, merged_guard = [], []
        for j in take:
            e = self.entries[eids[int(j)]]
            rho = float(np.sqrt(e.value_d2_key.max()))  # covering radius
            guard = rho - dk[int(j)]  # guarantee margin for this entry
            merged_ids.append(e.value_ids)
            merged_guard.append(np.full(e.value_ids.shape, guard))
        ids = np.concatenate(merged_ids)
        guard = np.concatenate(merged_guard)
        d_obj = np.sqrt(self._obj_d2(r_emb, ids))
        # keep best copy per object id
        order = np.argsort(d_obj, kind="stable")
        seen, pick = set(), []
        for p in order:
            if int(ids[p]) in seen:
                continue
            seen.add(int(ids[p]))
            pick.append(p)
            if len(pick) == self.k:
                break
        if len(pick) < self.k:
            return False, take[0] if len(take) else None
        pick = np.array(pick)
        guaranteed = int((d_obj[pick] <= guard[pick] + 1e-12).sum())
        if guaranteed >= self.theta_guaranteed:
            return True, eids[int(take[0])]
        # distance-profile test: mean distance of the selected k vs the mean
        # key->value distance profile of the stored entries
        prof = np.mean([np.sqrt(e.value_d2_key).mean()
                        for e in self.entries.values()])
        if d_obj[pick].mean() <= self.profile_tol * prof:
            return True, eids[int(take[0])]
        return False, eids[int(take[0])]

    def _on_hit(self, t, r_emb, eid):
        # touch every contributing entry (paper: pairs that contributed move
        # to the front); we touch the closest one — the dominant contributor.
        self._touch(eid)

    def step(self, t, r_emb):
        # QCACHE serves from the merged value sets, not a single entry.
        hit, eid = self._is_hit(t, r_emb)
        if hit:
            self._on_hit(t, r_emb, eid)
            ids = self.cached_object_ids()
            if self.augmented:
                return self._serve_from_ids(t, r_emb, ids)
            return self._answer_cost_local(t, r_emb, ids)
        ids, d2 = self.oracle.knn(t, self.k_prime)
        self._insert(r_emb, ids, d2)
        if self.augmented:
            res = self._serve_from_ids(t, r_emb, self.cached_object_ids())
            return StepResult(res.cost, res.gain, res.hit, res.served_local,
                              self.k_prime)
        return self._answer_cost_miss(t)


POLICIES = {p.name: p for p in (LRU, SimLRU, ClsLRU, RndLRU, QCache)}


def run_policy(policy: KeyValueCache, requests: np.ndarray):
    """Replay a trace; returns dict of per-step metric arrays."""
    t_total = requests.shape[0]
    gain = np.zeros(t_total)
    cost = np.zeros(t_total)
    hits = np.zeros(t_total, bool)
    fetched = np.zeros(t_total, np.int32)
    for t in range(t_total):
        res = policy.step(t, requests[t])
        gain[t], cost[t], hits[t], fetched[t] = res.gain, res.cost, res.hit, res.fetched
    return {"gain": gain, "cost": cost, "hit": hits, "fetched": fetched}


def nag(gains: np.ndarray, k: int, c_f: float) -> np.ndarray:
    """Normalised average gain curve, Eq. (11)."""
    return np.cumsum(gains) / (k * c_f * np.arange(1, gains.shape[0] + 1))
