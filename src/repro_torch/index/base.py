"""Index API: protocol, spec and backend registry (port of `repro.index.base`).

The batched `Index` protocol, the serializable `IndexSpec`, the registry
that builds a backend from a spec (`flat`, `ivf`, `ivfpq`, `lsh`, `nsw`,
and the sharded `ivf_sharded`, which also takes the device mesh and
returns the structure the sharded step consumes), and the mutable-catalog
slab machinery every backend shares:

* `add(vectors (B, d)) -> (B,) int32 row ids` appends rows at the slab's
  high-water mark; ids are monotonic and never recycled.
* `remove(ids)` tombstones rows in the (capacity,) `valid` mask; every
  query path masks them, so a removed row never surfaces.
* `refresh()` rebuilds the auxiliary structures over the live rows, in
  two phases when asked (`refresh_start` builds a shadow while the stale
  structures serve, `refresh_swap` installs it); `compact()` rebuilds the
  slab over the live rows and returns the old -> new id remap.

The slab, the mask and every table are preallocated tensors written in
place (`index_copy_`, `index_fill_`, slice writes), where the reference
donates its buffers to jitted updates: at a fixed capacity no mutation
allocates a new slab, mask or table.  Capacity grows by doubling, on the
reference's schedule (`slab_append`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch import spans


@runtime_checkable
class Index(Protocol):
    """Batched ANN index over a fixed catalog of `n` embeddings.

    * `query(rs (B, d), k) -> (dists (B, k), ids (B, k))` — ascending
      float32 squared distances, int32 catalog row ids; -1 marks underflow
      (dist = +inf on those slots).  A (d,) vector is promoted to B = 1.
    * `exact_distances: bool` — True when returned distances are exact on
      the shared catalog embeddings (the candidate generator then skips its
      exact re-rank).
    * `n: int` — live (indexed, non-tombstoned) objects.
    * `memory_bytes() -> int` — resident bytes of the index structures.

    Mutation surface (`MutableRows`): `add`, `remove`, `refresh`,
    `refresh_start` / `refresh_swap`, `compact`; `valid` (capacity,) bool,
    `capacity` and `n_slots` (the high-water mark) describe the slab.
    """

    exact_distances: bool

    def query(self, rs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        ...

    @property
    def n(self) -> int:
        ...

    def memory_bytes(self) -> int:
        ...


def arrays_bytes(*tensors) -> int:
    """Sum of the byte sizes of the given tensors (None entries skipped)."""
    return int(sum(t.numel() * t.element_size() for t in tensors if t is not None))


_CHECK_FINITE = spans.wait("check_finite")


def check_finite_queries(rs: torch.Tensor, where: str) -> None:
    """Reject NaN/Inf query vectors with a clear error instead of letting
    them corrupt top-k and OMA state.  Reads one flag back from the device
    (the wait `check_finite`)."""
    if not rs.dtype.is_floating_point:
        return
    bad = ~torch.isfinite(rs.reshape(rs.shape[0], -1) if rs.dim() > 1
                          else rs.reshape(1, -1)).all(dim=1)
    with _CHECK_FINITE:
        any_bad = bool(bad.any())
    if any_bad:
        rows = torch.nonzero(bad).flatten().tolist()
        raise ValueError(
            f"{where}: query vector(s) contain NaN/Inf (rows {rows}) — "
            f"refusing to serve; sanitize the embedding upstream (a NaN "
            f"query would corrupt top-k and OMA state)")


# ---------------------------------------------------------------------------
# Mutable-catalog slab machinery
# ---------------------------------------------------------------------------

_device_mutation_s = 0.0  # wall seconds of the mutation writes, `run_device`


def device_mutation_seconds() -> float:
    """Cumulative wall seconds spent in mutation writes (`run_device`)."""
    return _device_mutation_s


def run_device(fn, *args):
    """Run a mutation write and book its wall time; when a tensor argument
    lies on the card, the card is synchronised first and last, so the time
    is the write's (the reference blocks with `block_until_ready`)."""
    global _device_mutation_s
    dev = next((a.device for a in args
                if isinstance(a, torch.Tensor) and a.device.type == "cuda"), None)
    if dev is not None:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    if dev is not None:
        torch.cuda.synchronize(dev)
    _device_mutation_s += time.perf_counter() - t0
    return out


# The reference pads every mutation batch to a power-of-two width of at
# least MIN_WRITE rows (so its jit cache stays small) and grows the slab
# when the padded write would not fit.  The port writes no padding but
# keeps that growth schedule, so capacities (and with them the length of
# y, x and the rounding uniforms) equal the reference's step for step.
MIN_WRITE = 32


def bucket_width(b: int) -> int:
    """Smallest power of two >= max(b, MIN_WRITE)."""
    return max(MIN_WRITE, 1 << max(int(b) - 1, 0).bit_length())


def grow_capacity(n_slots: int, needed: int, cap: int) -> int:
    """The smallest doubling of `cap` that holds `n_slots + needed` rows."""
    new_cap = max(cap, 1)
    while n_slots + needed > new_cap:
        new_cap *= 2
    return new_cap


def grow_rows(t: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """A copy of `t` with `rows` rows along dim 0, the new ones `fill`."""
    out = torch.full((rows,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    out[:t.shape[0]] = t
    return out


def slab_append(emb: torch.Tensor, valid: torch.Tensor, n_slots: int,
                vectors: torch.Tensor):
    """Append rows to a capacity slab, growing it by doubling when the
    reference's padded write (`bucket_width` rows) would not fit.

    emb (cap, d) float32 (rows >= n_slots unused), valid (cap,) bool,
    n_slots the high-water mark, vectors (B, d) on emb's device.  Returns
    (emb', valid', ids): the same tensors written in place, or grown
    copies, and the new rows' ids, np.int32 arange(n_slots, n_slots + B)."""
    b = vectors.shape[0]
    cap = emb.shape[0]
    if n_slots + bucket_width(b) > cap:
        new_cap = grow_capacity(n_slots, bucket_width(b), cap)
        emb, valid = grow_rows(emb, new_cap), grow_rows(valid, new_cap, False)

    def write(emb, valid, vectors):
        emb[n_slots:n_slots + b] = vectors
        valid[n_slots:n_slots + b] = True

    run_device(write, emb, valid, vectors)
    return emb, valid, np.arange(n_slots, n_slots + b, dtype=np.int32)


def check_removable(ids, n_slots: int, valid: torch.Tensor, where: str) -> np.ndarray:
    """The mutation guards of a removal, raised before anything changes:
    ids in [0, n_slots), no duplicates, every row still live.  Returns the
    ids as np.int32 (B,)."""
    ids = np.atleast_1d(np.asarray(ids, np.int32))
    if len(ids) == 0:
        return ids
    if ids.min() < 0 or ids.max() >= n_slots:
        raise ValueError(f"{where}: ids must be assigned rows in [0, {n_slots}); "
                         f"got range [{ids.min()}, {ids.max()}]")
    if len(np.unique(ids)) != len(ids):
        raise ValueError(f"{where}: duplicate ids in one batch")
    alive = valid[torch.from_numpy(ids.astype(np.int64)).to(valid.device)].cpu().numpy()
    if not alive.all():
        raise ValueError(f"{where}: rows {ids[~alive].tolist()} are already dead "
                         f"(tombstoned or never assigned)")
    return ids


def live_remap(valid: torch.Tensor):
    """(live (n_live,) int64 on valid's device, remap (cap,) np.int32): the
    live rows ascending, and each row's id after compaction (-1 if dead)."""
    live = torch.nonzero(valid).flatten()
    remap = np.full(valid.shape[0], -1, np.int32)
    remap[live.cpu().numpy()] = np.arange(live.shape[0], dtype=np.int32)
    return live, remap


def compact_rows(emb: torch.Tensor, live: torch.Tensor):
    """(emb', valid') over the live rows only, in slab order, at the
    reference's capacity: the smallest doubling that holds them and one
    MIN_WRITE batch more."""
    n_live = live.shape[0]
    cap = grow_capacity(0, n_live + MIN_WRITE, 1)
    out = torch.zeros((cap, emb.shape[1]), dtype=emb.dtype, device=emb.device)
    out[:n_live] = emb[live]
    valid = torch.zeros(cap, dtype=torch.bool, device=emb.device)
    valid[:n_live] = True
    return out, valid


def default_init_fn(seed: int) -> Callable:
    """`init_fn(n, k)` of the structures' k-means: k distinct rows of n
    from a CPU generator seeded with `seed`, the same on every device."""

    def init_fn(n: int, k: int):
        return torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:k]

    return init_fn


class MutableRows:
    """Capacity slab and tombstone bookkeeping shared by every backend
    (port of the reference's `MutableRows`).

    Owns `embeddings` (capacity, d), `valid` (capacity,) bool, the
    high-water mark `n_slots` and the live count `n`.  Backends call
    `_append_rows` from `add` and `_tombstone_rows` from `remove`, and add
    their own bookkeeping.  Backends with auxiliary structures override
    `_compute_structures` (a pure rebuild over the live rows) and
    `_install_structures`; they get the two-phase refresh and `compact`.
    """

    embeddings: torch.Tensor
    valid: torch.Tensor

    def _init_rows(self, embeddings, device) -> None:
        self.embeddings = torch.atleast_2d(torch.as_tensor(
            embeddings, dtype=torch.float32)).to(device).contiguous()
        self._n_slots = int(self.embeddings.shape[0])
        self._live = self._n_slots
        self.valid = torch.ones(self._n_slots, dtype=torch.bool, device=self.embeddings.device)
        self._shadow = None  # pending two-phase-refresh structures

    def _load_rows(self, valid, n_slots: int) -> None:
        """Take a mutated slab's mask and high-water mark (the slab itself
        came in as `embeddings`, at its capacity)."""
        valid = torch.from_numpy(np.array(valid, bool)).to(self.embeddings.device)
        if valid.shape != (self.capacity,) or not 0 <= n_slots <= self.capacity:
            raise ValueError(f"valid {tuple(valid.shape)} and n_slots {n_slots} do not "
                             f"fit a slab of {self.capacity} rows")
        if bool(valid[n_slots:].any()):
            raise ValueError("valid marks rows past n_slots live")
        self.valid = valid.contiguous()
        self._n_slots = int(n_slots)
        self._live = int(valid.sum())

    @property
    def n(self) -> int:
        """Live (indexed, non-tombstoned) objects."""
        return self._live

    @property
    def capacity(self) -> int:
        """Slab rows allocated (the id space every query result respects)."""
        return int(self.embeddings.shape[0])

    @property
    def n_slots(self) -> int:
        """High-water mark: rows ever assigned (live + tombstoned)."""
        return self._n_slots

    def live_rows(self) -> np.ndarray:
        """Row ids of the live objects, ascending (rebuilds walk this
        order, so a rebuilt structure is a fresh build on the live rows
        modulo the id remap)."""
        return torch.nonzero(self.valid).flatten().cpu().numpy()

    def _live_embeddings(self, live: np.ndarray) -> torch.Tensor:
        if len(live) == self.capacity:
            return self.embeddings
        return self.embeddings[torch.from_numpy(live).to(self.embeddings.device)]

    def _append_rows(self, vectors) -> np.ndarray:
        vectors = torch.atleast_2d(torch.as_tensor(vectors, dtype=torch.float32)).to(
            self.embeddings.device)
        self.embeddings, self.valid, ids = slab_append(
            self.embeddings, self.valid, self._n_slots, vectors)
        self._n_slots += len(ids)
        self._live += len(ids)
        # a pending shadow predates these rows: installing it would make
        # them unfindable, so it is discarded
        self._shadow = None
        return ids

    def _tombstone_rows(self, ids) -> np.ndarray:
        ids = check_removable(ids, self._n_slots, self.valid, "remove")
        if len(ids):
            idx = torch.from_numpy(ids.astype(np.int64)).to(self.valid.device)
            run_device(lambda v, i: v.index_fill_(0, i, False), self.valid, idx)
            self._live -= len(ids)
            self._shadow = None  # see _append_rows
        return ids

    def add(self, vectors) -> np.ndarray:
        """Default `add`: slab append only (structure-free backends)."""
        return self._append_rows(vectors)

    def remove(self, ids) -> None:
        """Tombstone `ids`: every query path masks them through `valid`."""
        self._tombstone_rows(ids)

    @property
    def masked(self) -> bool:
        """True once a row has been tombstoned: list-based queries take
        `valid` from then on (their tables never name unused slab rows)."""
        return self._live != self._n_slots

    # -- two-phase refresh --------------------------------------------------

    def _compute_structures(self):
        """Backend hook: fresh auxiliary structures from the live rows,
        without touching serving state (None: structure-free backend)."""
        return None

    def _install_structures(self, structures) -> None:
        """Backend hook: install a `_compute_structures` bundle."""

    def _build_structures(self) -> None:
        s = self._compute_structures()
        if s is not None:
            self._install_structures(s)

    def refresh_start(self) -> None:
        """Phase 1: build the structures into a shadow; the stale ones keep
        serving until the swap."""
        self._shadow = self._compute_structures()

    def refresh_swap(self) -> None:
        """Phase 2: install the shadow (no-op without one: any mutation
        since the start discarded it)."""
        s, self._shadow = self._shadow, None
        if s is not None:
            self._install_structures(s)

    @property
    def refresh_pending(self) -> bool:
        return self._shadow is not None

    def refresh(self) -> None:
        """Blocking refresh: both phases back to back."""
        self.refresh_start()
        self.refresh_swap()

    # -- epoch compaction ---------------------------------------------------

    @property
    def answer_stable_compact(self) -> bool:
        """True when `compact()` changes nothing but row numbering (only
        structure-free backends: the others rebuild their structures)."""
        return type(self)._compute_structures is MutableRows._compute_structures

    def compact(self) -> np.ndarray:
        """Rebuild the slab over the live rows in ascending order (capacity
        `compact_rows`'s), rebuild the structures on the new ids, and
        return the (old capacity,) int32 old -> new remap, -1 on dead
        rows."""
        live, remap = live_remap(self.valid)
        self.embeddings, self.valid = compact_rows(self.embeddings, live)
        self._n_slots = self._live = int(live.shape[0])
        self._shadow = None
        self._build_structures()
        return remap


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Serializable index selection: backend name + build kwargs, e.g.
    ``IndexSpec("ivf", {"nlist": 256, "nprobe": 16})``.  Round-trips
    through the flat dict ``{"backend": "ivf", "nlist": 256, ...}``."""

    backend: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", dict(self.params))
        if "backend" in self.params:
            raise ValueError("'backend' is the spec field, not a param")

    def __hash__(self):
        return hash((self.backend, tuple(sorted(self.params.items()))))

    def to_dict(self) -> Dict[str, Any]:
        return {"backend": self.backend, **self.params}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "IndexSpec":
        d = dict(d)
        try:
            backend = d.pop("backend")
        except KeyError:
            raise ValueError(f"index spec dict needs a 'backend' key: {d}")
        if backend not in _REGISTRY:
            raise ValueError(_unknown_backend_msg(backend))
        return cls(backend, d)


@dataclasses.dataclass(frozen=True)
class _Backend:
    build: Callable
    sharded: bool  # build takes (catalog, mesh, device=None, **params)


_REGISTRY: Dict[str, _Backend] = {}


def register_backend(name: str, *, sharded: bool = False):
    """Decorator registering `fn(catalog, device=None, **params)` (or
    `fn(catalog, mesh, device=None, **params)` when sharded) under `name`."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"index backend {name!r} already registered")
        _REGISTRY[name] = _Backend(fn, sharded)
        return fn

    return deco


def registered_backends(*, sharded: bool | None = None) -> Tuple[str, ...]:
    """Sorted backend names; filtered by shardedness when given."""
    return tuple(sorted(name for name, b in _REGISTRY.items()
                        if sharded is None or b.sharded == sharded))


def parse_index_opts(opts) -> Dict[str, Any]:
    """Parse CLI `--index-opt key=value` pairs into builder kwargs; values
    are coerced int -> float -> str in that order."""
    out: Dict[str, Any] = {}
    for opt in opts or ():
        key, sep, val = opt.partition("=")
        if not sep or not key:
            raise ValueError(f"--index-opt expects key=value, got {opt!r}")
        for cast in (int, float):
            try:
                out[key] = cast(val)
                break
            except ValueError:
                continue
        else:
            out[key] = val
    return out


def _unknown_backend_msg(name: str) -> str:
    return (f"unknown index backend {name!r}; registered: "
            f"{', '.join(registered_backends())}")


def build_index(spec, catalog, device=None, mesh=None):
    """Construct the index a spec (or its flat-dict form) describes over
    `catalog`, on `device` (the CUDA card by default).  Single-device
    backends ignore `mesh`; sharded ones need it (their layout follows the
    mesh's `model` axis)."""
    if isinstance(spec, Mapping):
        spec = IndexSpec.from_dict(spec)
    try:
        backend = _REGISTRY[spec.backend]
    except KeyError:
        raise ValueError(_unknown_backend_msg(spec.backend))
    if backend.sharded:
        if mesh is None:
            raise ValueError(f"index backend {spec.backend!r} is sharded: build_index "
                             f"needs the device mesh (mesh=...)")
        return backend.build(catalog, mesh, device=device, **spec.params)
    return backend.build(catalog, device=device, **spec.params)


# Reserved spec-less name: "exact" means no index — the policy's
# perfect-recall exact candidate generator.
EXACT = "exact"


def resolve_spec(value) -> "IndexSpec | None":
    """Normalize None, an IndexSpec, a backend name or the flat dict form
    to IndexSpec-or-None, with the reserved name "exact" mapping to None."""
    if isinstance(value, IndexSpec):
        if value.backend != EXACT:
            if value.backend not in _REGISTRY:
                raise ValueError(_unknown_backend_msg(value.backend))
            return value
        if value.params:
            raise ValueError(
                f"'exact' takes no params (it is the spec-less exact "
                f"candidate generator): {value.params}")
        return None
    if value is None:
        return None
    if isinstance(value, str):
        if value == EXACT:
            return None
        if value not in _REGISTRY:
            raise ValueError(_unknown_backend_msg(value))
        return IndexSpec(value)
    if isinstance(value, Mapping):
        if value.get("backend") == EXACT:
            if len(value) > 1:
                raise ValueError(
                    f"'exact' takes no params (it is the spec-less exact "
                    f"candidate generator): {dict(value)}")
            return None
        return IndexSpec.from_dict(value)
    raise TypeError(f"cannot resolve an index spec from {value!r}")


@register_backend("flat")
def _build_flat(catalog, device=None, **kw):
    from repro_torch.index.exact import FlatIndex

    return FlatIndex(catalog, device=device, **kw)


@register_backend("ivf")
def _build_ivf(catalog, device=None, **kw):
    from repro_torch.index.ivf import IVFFlatIndex

    return IVFFlatIndex(catalog, device=device, **kw)


@register_backend("ivfpq")
def _build_ivfpq(catalog, device=None, **kw):
    from repro_torch.index.pq import IVFPQIndex

    return IVFPQIndex(catalog, device=device, **kw)


@register_backend("lsh")
def _build_lsh(catalog, device=None, **kw):
    from repro_torch.index.lsh import LSHIndex

    return LSHIndex(catalog, device=device, **kw)


@register_backend("nsw")
def _build_nsw(catalog, device=None, **kw):
    from repro_torch.index.nsw import NSWIndex

    return NSWIndex(catalog, device=device, **kw)


@register_backend("ivf_sharded", sharded=True)
def _build_ivf_sharded(catalog, mesh, device=None, *, model_axis: str = "model",
                       centroids=None, invlists=None, **kw):
    """One IVF coarse quantizer and list table per catalog shard on the
    mesh's `model` axis (`repro_torch.core.distributed.ShardedIVF`, what
    `make_step_sharded(ivf=...)` and `AcaiCache(mesh=...)` consume).
    Prebuilt `centroids` (P nlist, d) and `invlists` (P nlist, cap; local
    ids) load instead of training (`convert.sharded_ivf_from_numpy`)."""
    from repro_torch.core.distributed import _axis_size, build_sharded_ivf

    if model_axis not in mesh.mesh_dim_names:
        raise ValueError(
            f"ivf_sharded shards over mesh axis {model_axis!r}, but the mesh has axes "
            f"{tuple(mesh.mesh_dim_names)} — pass model_axis=<axis name> in the spec "
            f"params or rename the mesh axis")
    if centroids is not None or invlists is not None:
        from repro_torch.convert import sharded_ivf_from_numpy

        if "nlist" not in kw:
            raise ValueError("ivf_sharded: prebuilt centroids / invlists need nlist")
        return sharded_ivf_from_numpy(centroids, invlists, kw["nlist"],
                                      kw.get("nprobe", 8), device=device)
    return build_sharded_ivf(catalog, _axis_size(mesh, model_axis), device=device, **kw)
