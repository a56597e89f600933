"""Answer-cache tier: exact top-k memoization in front of the index (port
of `repro.serve.answer_cache`).

AÇAI's remote index pays a full scan per query even when a Zipf-skewed
trace repeats the same hot queries thousands of times.  This tier
memoizes the index's exact answers `(dists, ids)` keyed by query identity
and serves repeats without touching the scan, with three guarantees:

* **Bitwise parity** — a batch is served from the store only when every
  row hits; any miss recomputes the whole batch through the inner index
  (same shapes, same code as with the tier off) and re-stores every row.
  The scans are per row at a fixed batch shape, so a recomputed answer
  equals the stored one bit for bit; on the card this needs each kernel
  to repeat run to run for the same batch (chip_smoke.py's serving phase
  holds cache-on against pass-through at 1M x 128).
* **Precise churn invalidation** — `remove(ids)` drops exactly the
  entries whose answer contains a removed id (inverted id -> entry map);
  `add(vectors)` drops only entries whose k-th distance reaches a new row
  (a conservative radius check); `refresh()` flushes.  Backends whose
  mutations rewire existing structures (NSW's reverse links) or move an
  approximate cut (IVF-PQ's ADC shortlist) declare it with the
  `answer_unstable_add / _remove` class flags and get a full flush.
* **Idle unload** — after `idle_unload_ms` of the virtual clock without
  a scan, the wrapper moves the inner index's device structures (IVF
  lists and centroids, PQ codes and codebooks, NSW adjacency, LSH
  buckets ...) to host memory with `.cpu()`, and moves them back to the
  same device, unchanged, before the next scan.  Hits served while
  unloaded stay unloaded.  An unloaded index never scans on the host:
  `_ensure_loaded` runs before every scan, and the kernel wrappers raise
  on inputs split over two devices.

Keys: a 128-bit blake2b digest of the query's float32 bytes (requests of
a trace at jitter 0 are catalog rows, so repeats collide exactly), or
`rids=` (request ids) for callers that key by identity.  The bytes hashed
are the host copy of the batch that the caller already holds (the replay,
the engine and the launcher give their batches on the host, and
`AcaiCache` hands that copy to `CachedIndex.stage`), so a batch on the
card is not read back for its keys.  Only a batch that arrives on the
card with no host copy is read back (counted in `key_readbacks`).  Stored
answers keep the tensors the scan returned on the index's device (one
copy a batch of B x k), so a hit joins them on the device, or hands back
the stored batch itself when it repeats one: no copy from the host and no
synchronisation.  Host copies of the ids and distances serve the
invalidation rules.

`AnswerCacheSpec` is the serializable knob: `AcaiCache(...,
answer_cache=spec)`, `build_policy(..., answer_cache=...)`,
`SemanticCachedLM(..., answer_cache=...)` and `launch/serve.py
--answer-cache / --answer-cache-opt` take it (or its dict / int forms).
`capacity=0` is the pass-through mode: identical serving code with
hashing and memoization bypassed — the cache-off arm of every parity pin.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "AnswerCacheSpec", "AnswerCache", "CachedIndex",
    "resolve_answer_cache_spec", "parse_answer_cache_opts",
]


@dataclasses.dataclass(frozen=True)
class AnswerCacheSpec:
    """Serializable answer-cache config (the `IndexSpec` of this tier).

    capacity        LRU entry budget; 0 = pass-through (cache machinery
                    installed, memoization bypassed — the cache-off arm
                    of the parity pins).
    hit_ms          virtual service time of an engine fast-path hit: a
                    hit's answer completes at arrival + hit_ms without
                    entering the batch former.
    idle_unload_ms  virtual-clock idle threshold after which the inner
                    index's device structures are moved to host memory
                    (None = never unload).
    """

    capacity: int = 4096
    hit_ms: float = 0.2
    idle_unload_ms: Optional[float] = None

    def __post_init__(self):
        if self.capacity < 0:
            raise ValueError(f"capacity must be >= 0: {self.capacity}")
        if self.hit_ms < 0:
            raise ValueError(f"hit_ms must be >= 0: {self.hit_ms}")
        if self.idle_unload_ms is not None and self.idle_unload_ms <= 0:
            raise ValueError(
                f"idle_unload_ms must be > 0 or None: {self.idle_unload_ms}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AnswerCacheSpec":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"AnswerCacheSpec: unknown fields {sorted(unknown)} "
                f"(known: {sorted(f.name for f in dataclasses.fields(cls))})")
        return cls(**d)

    def with_params(self, **kw) -> "AnswerCacheSpec":
        return dataclasses.replace(self, **kw)


def resolve_answer_cache_spec(value) -> Optional[AnswerCacheSpec]:
    """Normalize every accepted `answer_cache=` form to a spec or None:
    None/False -> None (no tier), True -> default spec, int -> capacity,
    dict -> `from_dict`, spec -> itself."""
    if value is None or value is False:
        return None
    if value is True:
        return AnswerCacheSpec()
    if isinstance(value, AnswerCacheSpec):
        return value
    if isinstance(value, int):
        return AnswerCacheSpec(capacity=value)
    if isinstance(value, dict):
        return AnswerCacheSpec.from_dict(value)
    raise TypeError(
        f"answer_cache must be None/bool/int/dict/AnswerCacheSpec, "
        f"got {type(value).__name__}")


def parse_answer_cache_opts(pairs) -> dict:
    """KEY=VALUE CLI opts -> typed spec fields (the `parse_index_opts`
    idiom): int -> float -> str coercion, 'none' -> None."""
    out: dict = {}
    for item in pairs or ():
        if "=" not in item:
            raise ValueError(
                f"--answer-cache-opt needs KEY=VALUE, got {item!r}")
        key, val = item.split("=", 1)
        if val.lower() in ("none", "null"):
            out[key] = None
            continue
        for cast in (int, float):
            try:
                out[key] = cast(val)
                break
            except ValueError:
                continue
        else:
            out[key] = val
    return out


class _Entry(NamedTuple):
    q: np.ndarray        # (dim,) float32 query copy (radius checks)
    batch: torch.Tensor  # (B, 2k) int32 on the index's device: the stored
    #                      batch, distances' bits then ids, a row a query
    row: int             # this answer's row of `batch`
    dev: torch.Tensor    # (1, 2k) that row (a view), what a hit joins
    # host copies (None until the batch's copy lands, `_materialize`)
    ids: Optional[np.ndarray] = None  # (k,) int32 ids (-1 underflow slots)
    d: Optional[np.ndarray] = None    # (k,) float32 distances (+inf there)
    kth: Optional[float] = None       # largest finite distance; +inf when
    #                                   underfull (it can gain any new row)
    linked: Optional[np.ndarray] = None  # the ids this key has in the
    #                                      inverted map (None: none yet)


def _pack(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, k) float32 distances and int32 ids as one (B, 2k) int32 tensor:
    a hit joins one tensor, not two."""
    return torch.cat([d.to(torch.float32).view(torch.int32), ids.to(torch.int32)], dim=1)


def _unpack(packed: torch.Tensor):
    """(d (B, k) float32, ids (B, k) int32), views of a packed tensor."""
    k = packed.shape[1] // 2
    return packed[:, :k].view(torch.float32), packed[:, k:]


def _vector_key(row: np.ndarray) -> bytes:
    """128-bit digest of the query's float32 bytes — hashed-vector
    identity.  Equal vectors collide exactly; distinct float32 vectors
    collide with negligible probability."""
    buf = np.ascontiguousarray(row, dtype=np.float32)
    return hashlib.blake2b(buf.tobytes(), digest_size=16).digest()


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class AnswerCache:
    """LRU memo of exact index answers with precise churn invalidation.

    Entries are keyed `(namespace key, k)` — the same query at two
    fan-outs is two entries.  The store is the source of truth for the
    batch-level contract enforced by `CachedIndex`: serve from memory only
    on an all-hit batch, otherwise recompute everything.
    """

    def __init__(self, spec: AnswerCacheSpec):
        self.spec = spec
        self._store: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._inv: dict[int, set] = {}     # object id -> entry keys
        self._qkeys: dict = {}             # namespace key -> refcount
        self.epoch = 0
        self.hits = self.misses = 0
        self.stores = self.evictions = 0
        self.invalidations = 0
        self.inv_remove = self.inv_add = self.inv_refresh = 0
        self.scans = self.scans_skipped = 0
        # per-serving-step deltas, drained by AcaiCache's metric booking
        self._step_hit_mask: Optional[np.ndarray] = None
        self._inval_since_take = 0
        # the stored batch whose host copy is not read yet (host buffer,
        # ready event, [(key, entry)]), a pinned staging buffer by shape,
        # and the keys whose ids are not yet in the inverted map (linked
        # when a removal needs it: static traffic never pays for it)
        self._pending = None
        self._staging: dict = {}
        self._unlinked: list = []

    # -- keys ---------------------------------------------------------------

    @staticmethod
    def _keys_of(rs: np.ndarray, k: int, rids=None) -> list:
        if rids is not None:
            rids = np.atleast_1d(np.asarray(rids))
            if len(rids) != len(rs):
                raise ValueError(
                    f"rids length {len(rids)} != batch {len(rs)}")
            return [(("rid", int(r)), k) for r in rids]
        # each row's digest over its slice of the batch's bytes (the bytes
        # `_vector_key` hashes for that row alone)
        rs = np.ascontiguousarray(rs, dtype=np.float32)
        buf, width = rs.tobytes(), rs.shape[-1] * 4
        blake2b = hashlib.blake2b
        return [(("vec", blake2b(buf[i:i + width], digest_size=16).digest()), k)
                for i in range(0, len(buf), width)]

    # -- lookup / store -----------------------------------------------------

    def lookup_batch(self, rs: np.ndarray, k: int, rids=None):
        """Per-row entries (or None) + hit mask; counts hits / misses and
        refreshes the LRU recency of present entries."""
        self._materialize()
        return self._lookup(self._keys_of(rs, k, rids))

    def _lookup(self, keys: list):
        get, to_end = self._store.get, self._store.move_to_end
        entries = [get(key) for key in keys]
        hits = 0
        for key, e in zip(keys, entries):
            if e is not None:
                to_end(key)
                hits += 1
        mask = np.fromiter((e is not None for e in entries), bool, len(entries))
        self.hits += hits
        self.misses += len(keys) - hits
        self._note_step(mask)
        return entries, mask

    def peek(self, row, k: Optional[int] = None) -> bool:
        """Non-counting presence probe (the engine's arrival-time fast
        path checks this without moving hit statistics or LRU order).
        With `k=None` any fan-out of the query counts."""
        if self.spec.capacity == 0:
            return False
        nk = ("vec", _vector_key(np.asarray(row)))
        if k is None:
            return nk in self._qkeys
        return (nk, k) in self._store

    def store_batch(self, rs: np.ndarray, k: int, d, ids, rids=None) -> None:
        """Store a batch's answers: `d` / `ids` (B, k), numpy or tensors
        (the tensors' device is where a hit serves them; numpy answers
        are kept as CPU tensors)."""
        if self.spec.capacity == 0:
            return
        self._store_keys(self._keys_of(rs, k, rids), rs, d, ids)

    def _store_keys(self, keys: list, rs, d, ids) -> None:
        """Store a batch under its keys.  One (B, 2k) device copy a batch
        (the rows stored are its rows, so a scan's larger buffers are not
        held alive); its host copy goes to a pinned staging buffer without
        waiting for the card and is read at the next operation that needs
        the ids or distances on the host, so a miss never stalls the step
        for the scan to finish."""
        self._materialize()  # the previous batch's copy has long landed
        d = d if isinstance(d, torch.Tensor) else torch.from_numpy(np.array(d))
        ids = ids if isinstance(ids, torch.Tensor) else torch.from_numpy(np.array(ids))
        batch = _pack(d.detach(), ids.detach())
        if batch.device.type == "cuda":
            host = self._staging.get(batch.shape)
            if host is None:
                host = self._staging[batch.shape] = torch.empty(
                    batch.shape, dtype=batch.dtype, pin_memory=True)
            host.copy_(batch, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = batch, None
        q_np = np.array(rs, np.float32)
        entries = []
        for j, key in enumerate(keys):
            # an overwrite keeps the old answer's links (a recomputed answer
            # has the same ids: nothing to relink)
            old = self._store.pop(key, None)
            if old is None:
                self._qkeys[key[0]] = self._qkeys.get(key[0], 0) + 1
            e = self._store[key] = _Entry(q=q_np[j], batch=batch, row=j,
                                          dev=batch[j:j + 1],
                                          linked=None if old is None else old.linked)
            entries.append((key, e))
            self.stores += 1
            while len(self._store) > self.spec.capacity:
                self._drop(next(iter(self._store)))
                self.evictions += 1
        self._pending = (host, ready, entries)

    def _materialize(self) -> None:
        """Read the pending batch's host copy: fill each of its entries
        still in the store with its ids, distances and k-th distance."""
        if self._pending is None:
            return
        host, ready, entries = self._pending
        self._pending = None
        if ready is not None:
            ready.synchronize()
        packed = host.numpy().copy()  # out of the staging buffer
        k = packed.shape[1] // 2
        d, ids = packed[:, :k].view(np.float32), packed[:, k:]
        full = (np.isfinite(d) & (ids >= 0)).all(axis=1)
        kth = np.where(full, d.max(axis=1), np.inf).tolist()
        store = self._store
        for key, e in entries:
            if store.get(key) is e:  # not dropped or overwritten since
                store[key] = e._replace(ids=ids[e.row], d=d[e.row], kth=kth[e.row])
                self._unlinked.append(key)

    def _link(self) -> None:
        """Bring the inverted map up to date with every stored answer."""
        self._materialize()
        inv, store = self._inv, self._store
        for key in self._unlinked:
            e = store.get(key)
            if e is None or e.ids is None:
                continue
            if e.linked is not None and np.array_equal(e.linked, e.ids):
                continue
            self._unlink(key, e.linked)
            for oid in e.ids[e.ids >= 0].tolist():
                inv.setdefault(oid, set()).add(key)
            store[key] = e._replace(linked=e.ids)
        self._unlinked = []

    @staticmethod
    def stacked(entries):
        """The (B, k) answers of an all-hit batch, on their device: the
        stored batch itself when the entries are its rows in order (a
        repeated batch: nothing launched), else one concatenation."""
        first = entries[0]
        if (first.batch.shape[0] == len(entries)
                and all(e.batch is first.batch and e.row == j
                        for j, e in enumerate(entries))):
            return _unpack(first.batch)
        return _unpack(torch.cat([e.dev for e in entries]))

    def _unlink(self, key, ids: Optional[np.ndarray]) -> None:
        if ids is None:
            return
        inv = self._inv
        for oid in ids[ids >= 0].tolist():
            s = inv.get(oid)
            if s is not None:
                s.discard(key)
                if not s:
                    del inv[oid]

    def _drop(self, key) -> None:
        e = self._store.pop(key)
        self._unlink(key, e.linked)
        cnt = self._qkeys.get(key[0], 0) - 1
        if cnt <= 0:
            self._qkeys.pop(key[0], None)
        else:
            self._qkeys[key[0]] = cnt

    # -- invalidation -------------------------------------------------------

    def invalidate_removed(self, ids) -> int:
        """Drop exactly the entries whose answer contains a removed id
        (inverted map walk — precise, not a flush)."""
        self._link()
        doomed = set()
        for oid in np.atleast_1d(_host(ids)).tolist():
            doomed |= self._inv.get(int(oid), set())
        for key in doomed:
            self._drop(key)
        return self._book_invalidations(len(doomed), "remove")

    def invalidate_added(self, vectors) -> int:
        """Conservative radius check: a new row can only change an answer
        whose k-th distance reaches it, so drop entries with
        `min_j d2(q, v_j) <= kth` (float64, a small safety margin —
        over-invalidating is safe, under-invalidating is not).  Underfull
        answers (`kth = +inf`) always invalidate."""
        if not self._store:
            return 0
        self._materialize()
        v = np.atleast_2d(_host(vectors).astype(np.float64))
        keys = list(self._store.keys())
        q = np.stack([self._store[k].q for k in keys]).astype(np.float64)
        kth = np.array([self._store[k].kth for k in keys])
        d2 = ((q[:, None, :] - v[None, :, :]) ** 2).sum(-1).min(axis=1)
        hit = d2 <= kth * (1 + 1e-6) + 1e-6
        for key in (k for k, h in zip(keys, hit) if h):
            self._drop(key)
        return self._book_invalidations(int(hit.sum()), "add")

    def remap_ids(self, remap: np.ndarray) -> None:
        """Rewrite every stored answer's object ids through a compaction
        remap and rebuild the inverted id -> keys map in the new id space.
        Entries never reference dead rows (`invalidate_removed` is
        precise), so every stored id must land on a new row; -1 underflow
        slots pass through.  The answers stay bitwise valid: compaction's
        remap is order-preserving and moves rows without changing
        distances.  The device copies are rewritten with one copy to each
        device."""
        self._materialize()
        remap = np.asarray(remap, np.int32)
        # build the remapped store and inverted map fully before
        # committing, so the dead-row error leaves the cache untouched
        new_rows = {}
        inv: dict[int, set] = {}
        for key, e in self._store.items():
            ok = e.ids >= 0
            if ok.any() and (remap[e.ids[ok]] < 0).any():
                raise ValueError(
                    "remap_ids: stored answer references a dead row — "
                    "invalidate_removed must run before compaction")
            new_ids = np.where(ok, remap[np.clip(e.ids, 0, None)],
                               -1).astype(np.int32)
            new_rows[key] = new_ids
            for oid in new_ids[new_ids >= 0].tolist():
                inv.setdefault(int(oid), set()).add(key)
        by_dev: dict = {}
        for key, e in self._store.items():
            by_dev.setdefault(e.batch.device, []).append(key)
        store: "OrderedDict[tuple, _Entry]" = OrderedDict()
        rows = {}
        for dev, keys in by_dev.items():
            # one table a device: the distances as stored, the new ids
            table = np.concatenate([
                np.stack([self._store[k].d for k in keys]).view(np.int32),
                np.stack([new_rows[k] for k in keys])], axis=1)
            table = torch.from_numpy(table).to(dev)
            for j, key in enumerate(keys):
                rows[key] = (table, j)
        for key, e in self._store.items():
            table, j = rows[key]
            store[key] = e._replace(ids=new_rows[key], linked=new_rows[key], batch=table,
                                    row=j, dev=table[j:j + 1])
        self._store = store
        self._inv = inv
        self._unlinked = []
        self.epoch += 1  # the id space changed, the entries survived

    def flush(self, reason: str = "refresh") -> int:
        """Drop everything (epoch bump): `refresh()` rebuilds quantizer
        structures, and unstable-mutation backends route add / remove
        here too (parity over hit rate)."""
        n = len(self._store)
        self._store.clear()
        self._inv.clear()
        self._qkeys.clear()
        self._pending = None
        self._unlinked = []
        self.epoch += 1
        return self._book_invalidations(n, reason)

    def _book_invalidations(self, n: int, reason: str) -> int:
        self.invalidations += n
        self._inval_since_take += n
        if reason == "remove":
            self.inv_remove += n
        elif reason == "add":
            self.inv_add += n
        else:
            self.inv_refresh += n
        return n

    # -- per-step metric deltas ---------------------------------------------

    def _note_step(self, mask: np.ndarray) -> None:
        self._step_hit_mask = mask

    def take_step_stats(self, batch: int):
        """Drain the last serving step's deltas: (hit mask (B,),
        invalidations since the previous drain)."""
        mask = self._step_hit_mask
        if mask is None or len(mask) != batch:
            mask = np.zeros(batch, bool)
        self._step_hit_mask = None
        inval, self._inval_since_take = self._inval_since_take, 0
        return mask, inval

    # -- reporting ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._store)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "capacity": self.spec.capacity,
            "entries": len(self._store),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "stores": self.stores,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "inv_remove": self.inv_remove,
            "inv_add": self.inv_add,
            "inv_refresh": self.inv_refresh,
            "scans": self.scans,
            "scans_skipped": self.scans_skipped,
            "epoch": self.epoch,
        }


class CachedIndex:
    """Answer-cache front for any registered index backend: the `Index`
    protocol (so `mutable_index_candidate_fn` and `AcaiCache`'s mutation
    hooks drive it unchanged), with `query` memoized through an
    `AnswerCache`, mutations routed through the invalidation rules, and
    the idle unload on a virtual clock.

    Batch contract (the parity guarantee): a batch is answered from the
    store only when every row hits; any miss recomputes the whole batch
    through the inner index and re-stores it.
    """

    #: attributes never offloaded: the mutable slab assembly reads them
    #: every step, hits included
    _KEEP_LOADED = ("embeddings", "valid")

    def __init__(self, inner, spec: AnswerCacheSpec):
        self.inner = inner
        self.spec = spec
        self.cache = AnswerCache(spec)
        self._now_ms = 0.0
        self._last_scan_ms = 0.0
        # (attribute, sub-attribute or None, device) of what is on the host
        self._offloaded: list[tuple] = []
        self._staged: Optional[np.ndarray] = None
        self.unloads = self.reloads = 0
        self.key_readbacks = 0
        self.last_unload_nbytes = 0          # tensor bytes moved to the host
        self.last_unload_allocator_bytes = 0  # freed on the card (allocator)

    # -- Index protocol proxies ---------------------------------------------

    @property
    def embeddings(self):
        return self.inner.embeddings

    @property
    def valid(self):
        return self.inner.valid

    @property
    def capacity(self):
        return self.inner.capacity

    @property
    def n_slots(self):
        return self.inner.n_slots

    @property
    def n(self):
        return self.inner.n

    @property
    def device(self):
        return self.inner.embeddings.device

    @property
    def exact_distances(self):
        return getattr(self.inner, "exact_distances", False)

    def live_rows(self):
        return self.inner.live_rows()

    def memory_bytes(self) -> int:
        return self.inner.memory_bytes()

    # -- queries ------------------------------------------------------------

    def stage(self, host_rows: Optional[np.ndarray]) -> None:
        """Hand over the host copy of the batch the next `query` receives
        on the device (its keys are hashed from it).  None: the caller has
        no host copy."""
        self._staged = host_rows

    def _batch(self, rs):
        """(rs on the index's device, its host float32 copy or None)."""
        staged, self._staged = self._staged, None
        if isinstance(rs, torch.Tensor):
            if rs.dim() != 2:
                rs = torch.atleast_2d(rs)
            host = staged if (staged is not None
                              and staged.shape == tuple(rs.shape)) else None
            if host is None and rs.device.type == "cpu":
                host = np.ascontiguousarray(rs.detach().numpy(), np.float32)
            dev = self.device
            return (rs if rs.device == dev else rs.to(dev)), host
        host = np.atleast_2d(np.ascontiguousarray(rs, np.float32))
        return torch.from_numpy(host).to(self.device), host

    def query(self, rs, k: int):
        rs, host = self._batch(rs)
        if self.spec.capacity == 0:  # pass-through arm of the parity pins
            self._ensure_loaded()
            self._last_scan_ms = self._now_ms
            self.cache.scans += 1
            self.cache._note_step(np.zeros(rs.shape[0], bool))
            return self.inner.query(rs, k)
        if host is None:
            # a batch on the card with no host copy: read it back for keys
            host = rs.detach().cpu().numpy()
            self.key_readbacks += 1
        keys = self.cache._keys_of(host, k)
        entries, mask = self.cache._lookup(keys)
        if mask.all():
            # all-hit: serve the memoized answers where they lie — no scan
            # and no transfer (an unloaded index stays unloaded)
            self.cache.scans_skipped += 1
            return self.cache.stacked(entries)
        self._ensure_loaded()
        self._last_scan_ms = self._now_ms
        self.cache.scans += 1
        d, ids = self.inner.query(rs, k)
        self.cache._store_keys(keys, host, d, ids)
        return d, ids

    def step_counters(self, b: int) -> dict:
        """The answer tier's StepMetrics fields of the batch just served:
        the hit mask of the query it ran and the invalidations since the
        previous step (booked on the first request), as int32 CPU tensors
        (booked on the host, where the tier runs)."""
        mask, inval = self.cache.take_step_stats(b)
        hits = torch.from_numpy(mask.astype(np.int32))
        inv = torch.zeros(b, dtype=torch.int32)
        inv[0] = int(inval)
        return {"answer_hits": hits, "answer_misses": 1 - hits,
                "answer_invalidations": inv}

    # -- mutation hooks (invalidation rules) ----------------------------------

    def add(self, vectors):
        self._ensure_loaded()
        ids = self.inner.add(vectors)
        if (getattr(self.inner, "answer_unstable_add", False)
                or not self.exact_distances):
            # graph-rewiring insertion (NSW reverse links) or approximate
            # reported distances (IVF-PQ ADC): the radius check cannot
            # bound the answer drift — flush instead
            self.cache.flush("add")
        else:
            self.cache.invalidate_added(vectors)
        return ids

    def remove(self, ids) -> None:
        self._ensure_loaded()
        self.inner.remove(ids)
        if getattr(self.inner, "answer_unstable_remove", False):
            # e.g. NSW: the first tombstone flips beam-search masking,
            # which can reroute answers that never contained the id
            self.cache.flush("remove")
        else:
            self.cache.invalidate_removed(ids)

    def refresh(self) -> None:
        self._ensure_loaded()
        self.inner.refresh()
        self.cache.flush("refresh")

    def refresh_start(self) -> None:
        """Phase 1 of the two-phase refresh: the shadow rebuild in the
        inner index.  The stale structures — and the answers memoized over
        them — keep serving; no flush until the swap changes what the
        index would answer."""
        self._ensure_loaded()
        self.inner.refresh_start()

    def refresh_swap(self) -> None:
        """Phase 2: install the shadow, then flush.  A swap with no
        pending shadow installs nothing, so the store stays."""
        if not self.refresh_pending:
            self.inner.refresh_swap()  # inner no-op, kept for symmetry
            return
        self.inner.refresh_swap()
        self.cache.flush("refresh")

    @property
    def refresh_pending(self) -> bool:
        return bool(getattr(self.inner, "refresh_pending", False))

    def compact(self) -> np.ndarray:
        """Epoch compaction pass-through: compact the inner index and push
        the id remap into the stored answers.  Remap-and-keep is safe only
        for structure-free exact backends (`answer_stable_compact`, flat):
        the remap is order-preserving, so even top-k tie-breaks survive.
        Every backend with auxiliary structures flushes (compaction
        rebuilds them over the live set)."""
        self._ensure_loaded()
        remap = self.inner.compact()
        if (getattr(self.inner, "answer_stable_compact", False)
                and self.exact_distances):
            self.cache.remap_ids(remap)
        else:
            self.cache.flush("compact")
        return remap

    # -- idle unload (virtual clock) ----------------------------------------

    def tick(self, now_ms: float) -> None:
        """Advance the virtual clock (the serving engine calls this at
        every dispatch instant); unload once the index has sat idle — no
        scan — for `idle_unload_ms`."""
        self._now_ms = max(self._now_ms, float(now_ms))
        if (self.spec.idle_unload_ms is not None and self.loaded
                and self._now_ms - self._last_scan_ms
                >= self.spec.idle_unload_ms):
            self.unload()

    @property
    def loaded(self) -> bool:
        return not self._offloaded

    def _tensor_slots(self):
        """(attribute, sub-attribute or None, tensor) of the inner index's
        tensors, one level into helper objects (a PQ codec's codebooks),
        `embeddings` and `valid` excepted."""
        for name, val in list(vars(self.inner).items()):
            if name in self._KEEP_LOADED:
                continue
            if isinstance(val, torch.Tensor):
                yield name, None, val
            elif hasattr(val, "__dict__") and not isinstance(val, type):
                for sub, sval in list(vars(val).items()):
                    if isinstance(sval, torch.Tensor):
                        yield name, sub, sval

    def _set(self, name, sub, val) -> None:
        setattr(self.inner if sub is None else getattr(self.inner, name),
                name if sub is None else sub, val)

    def unload(self) -> int:
        """Move the inner index's device tensors (everything but the
        embeddings slab and the liveness mask) to host memory with
        `.cpu()`.  Returns the bytes freed on the card, read from the
        allocator (`torch.cuda.memory_allocated`); on a CPU index, the
        tensors' bytes.  The structures are moved, not rebuilt, so a
        reload serves bitwise-identical answers (unlike `refresh()`)."""
        if not self.loaded:
            return 0
        dev = self.device
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
        nbytes = 0
        slots = list(self._tensor_slots())
        for name, sub, val in slots:
            self._set(name, sub, val.cpu())
            self._offloaded.append((name, sub, val.device))
            nbytes += val.numel() * val.element_size()
        slots = val = None  # drop the last references to the device copies
        self.last_unload_nbytes = nbytes
        if cuda:
            torch.cuda.synchronize(dev)
            self.last_unload_allocator_bytes = before - torch.cuda.memory_allocated(dev)
        else:
            self.last_unload_allocator_bytes = 0
        if self._offloaded:
            self.unloads += 1
        return self.last_unload_allocator_bytes if cuda else nbytes

    def _ensure_loaded(self) -> None:
        """Move every offloaded tensor back to the device it came from
        (runs before every scan and mutation)."""
        if self.loaded:
            return
        for name, sub, dev in self._offloaded:
            host = getattr(self.inner, name) if sub is None else getattr(
                getattr(self.inner, name), sub)
            self._set(name, sub, host.to(dev))
        self._offloaded = []
        self.reloads += 1
        self._last_scan_ms = self._now_ms

    # -- reporting ----------------------------------------------------------

    def stats(self) -> dict:
        s = self.cache.stats()
        s.update(unloads=self.unloads, reloads=self.reloads,
                 loaded=self.loaded, key_readbacks=self.key_readbacks,
                 last_unload_nbytes=self.last_unload_nbytes,
                 last_unload_allocator_bytes=self.last_unload_allocator_bytes)
        return s

    def __repr__(self) -> str:
        return (f"CachedIndex({type(self.inner).__name__}, "
                f"capacity={self.spec.capacity}, "
                f"entries={len(self.cache)})")
