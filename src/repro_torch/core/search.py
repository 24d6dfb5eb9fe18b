"""ANN / exact KNN search (paper Alg. 2): kwarg shims over QuerySpecs (port
of repro.core.search).

The query representation is the frozen `QuerySpec` (core/query.py) and
every path returns a `ResultSet`. These entry points compile their
arguments into a spec and hand it to `executor.run`, which builds the
QueryPlan and runs the fused scan.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import executor
from .executor import AttrFilter, find_nearest_centroids  # noqa: F401
from .query import Q, QuerySpec, ResultSet  # noqa: F401
from .types import INVALID_ID, IVFIndex


def ann_search(index: IVFIndex, queries, k: int, n_probe: int,
               attr_filter: Optional[AttrFilter] = None,
               backend: Optional[str] = None) -> ResultSet:
    """Alg. 2 as an ANN spec: per-query probe sets scanned as one shared
    union with a selection mask; a filter runs as a post-filter."""
    spec = Q.knn(k=k, n_probe=n_probe).backend(backend)
    if attr_filter is not None:
        spec = spec.where(attr_filter).postfilter()
    return executor.run(index, queries, spec)


def exact_search(index: IVFIndex, queries, k: int,
                 attr_filter: Optional[AttrFilter] = None,
                 backend: Optional[str] = None) -> ResultSet:
    """Brute-force KNN over every live row: the 100%-recall oracle."""
    spec = Q.exact(k=k).backend(backend)
    if attr_filter is not None:
        spec = spec.where(attr_filter)
    return executor.run(index, queries, spec)


def prefilter_search(index: IVFIndex, queries, k: int,
                     attr_filter: AttrFilter, cap: int,
                     backend: Optional[str] = None) -> ResultSet:
    """Pre-filtering spec (paper §3.5): evaluate the predicate first and
    brute-force over the qualifying rows (100% recall); `cap` is the gather
    budget, so the cost follows the predicate's selectivity."""
    spec = Q.knn(k=k).where(attr_filter).prefilter(cap).backend(backend)
    return executor.run(index, queries, spec)


def recall_at_k(approx: ResultSet, exact: ResultSet, k: int
                ) -> torch.Tensor:
    """recall@k: |approx top-k ∩ exact top-k| / k (the paper's metric);
    the denominator counts the exact set's real results (tiny databases)."""
    a = approx.ids[:, :k]
    e = exact.ids[:, :k].to(a.device)
    hits = (a[:, :, None] == e[:, None, :]) & (a[:, :, None] != INVALID_ID)
    denom = torch.clamp((e != INVALID_ID).sum(-1), min=1)
    return (hits.any(-1).sum(-1) / denom).mean()
