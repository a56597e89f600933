"""Index API: protocol, spec and backend registry (port of `repro.index.base`).

The static subset: the batched `Index` protocol, the serializable
`IndexSpec`, and the registry that builds a backend from a spec, with the
`flat` and `ivf` backends registered.  The mutable-catalog slab machinery
of the reference (ROADMAP A8) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Protocol, Tuple, runtime_checkable

import torch


@runtime_checkable
class Index(Protocol):
    """Batched ANN index over a fixed catalog of `n` embeddings.

    * `query(rs (B, d), k) -> (dists (B, k), ids (B, k))` — ascending
      float32 squared distances, int32 catalog row ids; -1 marks underflow
      (dist = +inf on those slots).  A (d,) vector is promoted to B = 1.
    * `exact_distances: bool` — True when returned distances are exact on
      the shared catalog embeddings (the candidate generator then skips its
      exact re-rank).
    * `n: int` — catalog size.
    * `memory_bytes() -> int` — resident bytes of the index structures.
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


def check_finite_queries(rs: torch.Tensor, where: str) -> None:
    """Reject NaN/Inf query vectors with a clear error instead of letting
    them corrupt top-k and OMA state.  Reads one flag back from the device."""
    if not rs.dtype.is_floating_point:
        return
    bad = ~torch.isfinite(rs.reshape(rs.shape[0], -1) if rs.dim() > 1
                          else rs.reshape(1, -1)).all(dim=1)
    if bool(bad.any()):
        rows = torch.nonzero(bad).flatten().tolist()
        raise ValueError(
            f"{where}: query vector(s) contain NaN/Inf (rows {rows}) — "
            f"refusing to serve; sanitize the embedding upstream (a NaN "
            f"query would corrupt top-k and OMA state)")


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


_REGISTRY: Dict[str, Callable] = {}


def register_backend(name: str):
    """Decorator registering `fn(catalog, device=None, **params)` under `name`."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"index backend {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def registered_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _unknown_backend_msg(name: str) -> str:
    return (f"unknown index backend {name!r}; registered: "
            f"{', '.join(registered_backends())}")


def build_index(spec, catalog, device=None):
    """Construct the index a spec (or its flat-dict form) describes over
    `catalog`, on `device` (the CUDA card by default)."""
    if isinstance(spec, Mapping):
        spec = IndexSpec.from_dict(spec)
    try:
        build = _REGISTRY[spec.backend]
    except KeyError:
        raise ValueError(_unknown_backend_msg(spec.backend))
    return build(catalog, device=device, **spec.params)


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
