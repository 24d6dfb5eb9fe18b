"""Batch multi-query optimization (paper §3.4; port of repro.core.mqo).

An MQO batch is an ANN QuerySpec: the shared probe union is the plan's
`part_ids` and the query-by-partition selection its `qsel`, so
`mqo_search` builds `Q.knn(...).union_cap(u_max)` and runs it. `u_max`
caps the scan union (unioned-out slots carry zero votes and are masked).

I/O amortisation: bytes gathered drop from Q * n_probe * p_max * d
(naive) to u_max * p_max * d (shared).
"""
from __future__ import annotations

from typing import Optional

from . import executor
from .executor import AttrFilter
from .query import Q, ResultSet
from .types import IVFIndex


def mqo_search(index: IVFIndex, queries, k: int, n_probe: int,
               u_max: Optional[int] = None,
               attr_filter: Optional[AttrFilter] = None,
               backend: Optional[str] = None) -> ResultSet:
    """Partition-major shared scan for a query batch."""
    spec = Q.knn(k=k, n_probe=n_probe).union_cap(u_max).backend(backend)
    if attr_filter is not None:
        spec = spec.where(attr_filter).postfilter()
    return executor.run(index, queries, spec)


def gathered_bytes(index: IVFIndex, batch: int, n_probe: int,
                   u_max: Optional[int] = None, mqo: bool = True) -> int:
    """Partition bytes read per batch -- the I/O-amortisation metric."""
    kp, p_max, d = index.vectors.shape
    row = d * 4
    if mqo:
        u = u_max if u_max is not None else min(kp, batch * min(n_probe, kp))
        return u * p_max * row
    return batch * min(n_probe, kp) * p_max * row
