"""Declarative query API: `QuerySpec` in, `ResultSet` out (port of
repro.core.query).

    spec = Q.knn(k=100).probe(8).where(Pred(0, "==", 3)).postfilter()
    rs   = db.query(vecs, spec)          # ResultSet
    for hit in rs: ...                   # per-query iteration

`QuerySpec` is a frozen, hashable dataclass; every fluent method returns a
new spec. Backends are None (follow the index's device), "cuda" (the
hand-written kernels) or "torch" (their plain PyTorch versions, on the
CPU). `ResultSet` keeps the executor's device tensors and moves them to
the host lazily.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .hybrid import And, Node, Or, Pred
from .topk import dedup_by_id, merge_topk
from .types import INVALID_ID, SearchResult

_KINDS = ("ann", "exact")
_HYBRID = ("auto", "pre", "post")
_BACKENDS = (None, "cuda", "torch")

# A predicate slot holds a frozen Pred/And/Or tree or a compiled filter
# callable (hashes by identity).
Predicate = Union[Node, Any]


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One declarative search. Frozen + hashable.

    Fields:
      kind          "ann" (probe n_probe partitions) | "exact" (oracle)
      k             top-k width
      n_probe       partitions probed per query (ann)
      u_max         optional cap on the batched shared-scan union (MQO)
      cap           prefilter gather budget (hybrid == "pre")
      predicate     attribute predicate tree (Pred/And/Or)
      hybrid        "auto" (the engine's optimizer picks) | "pre" | "post"
      use_quantized scan tier: None auto (codes when present), False f32,
                    True requires codes
      on_backend    None (the index's device) | "cuda" | "torch"
      gather_attrs  gather result rows' attributes (engine-level)
    """

    kind: str = "ann"
    k: int = 10
    n_probe: int = 8
    u_max: Optional[int] = None
    cap: Optional[int] = None
    predicate: Optional[Predicate] = None
    hybrid: str = "auto"
    use_quantized: Optional[bool] = None
    on_backend: Optional[str] = None
    gather_attrs: bool = False

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}: {self.kind!r}")
        if self.hybrid not in _HYBRID:
            raise ValueError(f"hybrid must be one of {_HYBRID}")
        if self.on_backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}: "
                             f"{self.on_backend!r}")
        if self.k < 1 or self.n_probe < 1:
            raise ValueError("k and n_probe must be >= 1")

    # -- fluent API (each call returns a NEW frozen spec) -------------------
    def top(self, k: int) -> "QuerySpec":
        return dataclasses.replace(self, k=k)

    def probe(self, n_probe: int) -> "QuerySpec":
        return dataclasses.replace(self, n_probe=n_probe)

    def union_cap(self, u_max: Optional[int]) -> "QuerySpec":
        """Cap the batched shared-scan union (the MQO knob, paper §3.4)."""
        return dataclasses.replace(self, u_max=u_max)

    def where(self, *predicates: Predicate) -> "QuerySpec":
        """Attach predicates. Several arguments AND together and chained
        calls accumulate; top-level Ands flatten so .where(a).where(b) and
        .where(a, b) build the same tree. A bare callable without a tree
        can only stand alone."""
        nodes = tuple(getattr(p, "predicate", p) for p in predicates)
        if self.predicate is not None:
            nodes = (self.predicate,) + nodes
        if len(nodes) == 1:
            node = nodes[0]
        else:
            bare = [n for n in nodes if not isinstance(n, (Pred, And, Or))]
            if bare:
                raise TypeError(
                    "where() can AND-combine predicate trees only; a "
                    "hand-written filter callable must be the sole "
                    f"predicate (got {len(bare)} callable(s) among "
                    f"{len(nodes)} predicates)")
            flat = []
            for n in nodes:
                flat.extend(n.children if isinstance(n, And) else (n,))
            node = And(tuple(flat))
        return dataclasses.replace(self, predicate=node)

    @property
    def predicate_tree(self) -> Optional[Node]:
        p = self.predicate
        return p if isinstance(p, (Pred, And, Or)) else None

    def exact(self) -> "QuerySpec":
        """100%-recall oracle: probe every partition."""
        return dataclasses.replace(self, kind="exact")

    def ann(self) -> "QuerySpec":
        return dataclasses.replace(self, kind="ann")

    def prefilter(self, cap: Optional[int] = None) -> "QuerySpec":
        return dataclasses.replace(self, hybrid="pre", cap=cap)

    def postfilter(self) -> "QuerySpec":
        """Run the predicate as a post-filter, evaluated in the scan."""
        return dataclasses.replace(self, hybrid="post")

    def quantized(self, flag: Optional[bool] = True) -> "QuerySpec":
        return dataclasses.replace(self, use_quantized=flag)

    def backend(self, name: Optional[str]) -> "QuerySpec":
        return dataclasses.replace(self, on_backend=name)

    def with_attrs(self, flag: bool = True) -> "QuerySpec":
        return dataclasses.replace(self, gather_attrs=flag)


class Q:
    """Entry points of the fluent API: `Q.knn(...)`, `Q.exact(...)`."""

    @staticmethod
    def knn(k: int = 10, n_probe: int = 8) -> QuerySpec:
        return QuerySpec(kind="ann", k=k, n_probe=n_probe)

    @staticmethod
    def exact(k: int = 10) -> QuerySpec:
        return QuerySpec(kind="exact", k=k)


@dataclasses.dataclass(eq=False)
class QueryResult:
    """One query's hits, trimmed of INVALID padding (host arrays)."""

    ids: np.ndarray                    # [m] int32
    scores: np.ndarray                 # [m] float32 (exact f32 distances)
    attrs: Optional[np.ndarray] = None  # [m, n_attr] if gathered

    def __len__(self) -> int:
        return len(self.ids)


@dataclasses.dataclass(eq=False)
class ResultSet:
    """Typed top-k result batch -- what every search path returns.

    `ids`/`scores` stay device tensors ([Q, k], INVALID_ID marks missing
    hits, scores are exact float32 distances, smaller is better);
    iteration and `to_numpy()` copy to the host once. `merge()` is the
    associative top-k reduction of two sets for the same query batch."""

    ids: torch.Tensor                   # [Q, k] int32
    scores: torch.Tensor                # [Q, k] float32
    spec: Optional[QuerySpec] = None
    attrs: Optional[np.ndarray] = None  # [Q, k, n_attr] if gathered
    # obs.trace.QueryTrace when the query ran traced (query(trace=True),
    # explain(), a traced front-door submit); None untraced
    trace: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    _np: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @staticmethod
    def of(res: SearchResult, spec: Optional[QuerySpec] = None,
           attrs: Optional[np.ndarray] = None) -> "ResultSet":
        return ResultSet(ids=res.ids, scores=res.scores, spec=spec,
                         attrs=attrs)

    @property
    def num_queries(self) -> int:
        return int(self.ids.shape[0])

    @property
    def k(self) -> int:
        return int(self.ids.shape[1])

    def __len__(self) -> int:
        return self.num_queries

    def __iter__(self) -> Iterator[QueryResult]:
        for qi in range(self.num_queries):
            yield self[qi]

    def __getitem__(self, qi: int) -> QueryResult:
        ids, scores = self.to_numpy()
        got = ids[qi] != INVALID_ID
        return QueryResult(
            ids=ids[qi][got], scores=scores[qi][got],
            attrs=None if self.attrs is None else self.attrs[qi][got])

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._np is None:
            self._np = (self.ids.cpu().numpy(), self.scores.cpu().numpy())
        return self._np

    def split(self, sizes: Sequence[int]) -> List["ResultSet"]:
        """Cut the batch back into per-caller ResultSets (the inverse of
        run_coalesced's concatenation). `sizes` must sum to num_queries."""
        sizes = [int(s) for s in sizes]
        if any(s < 1 for s in sizes) or sum(sizes) != self.num_queries:
            raise ValueError(f"split sizes {sizes} do not cover the batch "
                             f"of {self.num_queries}")
        out: List[ResultSet] = []
        off = 0
        for s in sizes:
            out.append(ResultSet(
                ids=self.ids[off:off + s], scores=self.scores[off:off + s],
                spec=self.spec,
                attrs=None if self.attrs is None
                else self.attrs[off:off + s]))
            off += s
        return out

    def merge(self, other: "ResultSet", k: Optional[int] = None
              ) -> "ResultSet":
        """Associative top-k merge of two candidate sets for the SAME query
        batch; duplicated ids are deduped keeping the best score."""
        if self.ids.shape[0] != other.ids.shape[0]:
            raise ValueError("merge() needs the same query batch on both "
                             "sides")
        k_out = k if k is not None else max(self.k, other.k)
        k_out = min(k_out, self.k + other.k)
        # merge at 2x width before deduping: an id appears at most once per
        # side, so 2*k_out candidates cover the true top-k_out
        k_wide = min(2 * k_out, self.k + other.k)
        dev = self.ids.device
        s, i = merge_topk(self.scores, self.ids, other.scores.to(dev),
                          other.ids.to(dev), k_wide)
        s, i = dedup_by_id(s, i)
        i, s = i[:, :k_out], s[:, :k_out]
        attrs = None
        if self.attrs is not None and other.attrs is not None:
            ids_m = i.cpu().numpy()
            n_attr = self.attrs.shape[-1]
            attrs = np.zeros(ids_m.shape + (n_attr,), np.float32)
            a_ids, _ = self.to_numpy()
            b_ids, _ = other.to_numpy()
            for qi in range(ids_m.shape[0]):
                lut = {int(r): self.attrs[qi, j]
                       for j, r in enumerate(a_ids[qi]) if r != INVALID_ID}
                lut.update({int(r): other.attrs[qi, j]
                            for j, r in enumerate(b_ids[qi])
                            if r != INVALID_ID})
                for j, r in enumerate(ids_m[qi]):
                    if r != INVALID_ID:
                        attrs[qi, j] = lut[int(r)]
        return ResultSet(ids=i, scores=s, spec=self.spec or other.spec,
                         attrs=attrs)
