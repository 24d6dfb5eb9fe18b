"""Query execution for the resident index (port of the resident half of
repro.core.executor): every search is a QueryPlan run by one fused scan.

Plan model (paper Alg. 2 generalised):
    probe set         part_ids [n]  -- shared partition scan list
    selection mask    qsel [Q, n]   -- which query wants which partition
    post-filter       keep [k, p_max] -- the compiled predicate's row mask
    k                 top-k width
Exact = probe everything. On an int8 index an ann plan scans the code tier
for k' = rerank_factor * k candidate rows (kernels/sq_scan.py) and reranks
them exactly in float32; every other plan runs the float32 scan
(kernels/ivf_scan.py). The delta merge, dedup and ||q||^2 restore close
every path.

Backends follow the index's device: "cuda" launches the hand-written
kernels, "torch" runs their plain versions on the CPU. A spec naming the
other device's backend raises; nothing switches silently.

Differences from the JAX package, each deliberate:
  * the union plan is taken for every Q (no small-Q gather variant);
  * the probe union is ordered by (votes descending, partition id
    ascending) -- the order lax.top_k gives -- so partitions are scanned,
    and score ties broken, in the same order as the reference;
  * predicates run as post-filters only; "auto" and "pre" need the
    optimizer and the pre-filter plan (ROADMAP Queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..kernels import ops
from .hybrid import compile_filter
from .query import QuerySpec, ResultSet
from .topk import dedup_by_id, mask_scores, merge_topk, topk_smallest
from .types import (INVALID_ID, MASKED_SCORE, IVFIndex, SearchResult,
                    f32_matmul, normalize_if_cosine, pairwise_scores)

# attr_filter: [..., n_attr] float32 -> [...] bool (hybrid.compile_filter)
AttrFilter = Callable[[torch.Tensor], torch.Tensor]

_PREFILTER_TODO = (
    "hybrid='auto' and 'pre' with a predicate need the hybrid optimizer "
    "and the pre-filter plan, not ported yet (ROADMAP Queue A: the "
    "optimizer and pre-filter plan); use .postfilter()")


def _check_backend(index: IVFIndex, requested: Optional[str]) -> None:
    """A spec's backend must be its index's: "cuda" on a CUDA index,
    "torch" on a CPU one (or None)."""
    own = "cuda" if index.device.type == "cuda" else "torch"
    if requested is not None and requested != own:
        raise ValueError(f"backend {requested!r} does not match the index "
                         f"on {index.device} (backend {own!r})")


def _stable_topk_idx(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest along the last axis, ties by index."""
    return torch.sort(x, dim=-1, stable=True).indices[..., :k]


def _centroid_scores(centroids, counts, metric, q):
    """[Q, d] -> [Q, k] centroid distances, empty partitions pushed out of
    any probe set."""
    cd = pairwise_scores(q, centroids, metric)
    return torch.where(counts[None, :] > 0, cd,
                       torch.full_like(cd, MASKED_SCORE))


def find_nearest_centroids(index: IVFIndex, q: torch.Tensor, n_probe: int):
    """[Q, d] -> [Q, n_probe] partition ids (line 3 of Alg. 2)."""
    cd = _centroid_scores(index.centroids, index.counts,
                          index.config.metric, q)
    return _stable_topk_idx(cd, min(n_probe, index.k))


def _probe_union(centroids, counts, metric, q, n_probe,
                 u_max: Optional[int] = None,
                 qmask: Optional[torch.Tensor] = None):
    """Shared probe set + per-query selection (paper §3.4): the union is
    the u_max most-voted partitions, ordered by (votes desc, pid asc), and
    `qsel` masks each query back onto its own probes."""
    kp = centroids.shape[0]
    Q = q.shape[0]
    n_probe = min(n_probe, kp)
    if u_max is None:
        u_max = min(kp, Q * n_probe)
    cd = _centroid_scores(centroids, counts, metric, q)
    parts = _stable_topk_idx(cd, n_probe)                  # [Q, n]
    sel = torch.zeros((Q, kp), dtype=torch.bool, device=q.device)
    sel.scatter_(1, parts, True)
    if qmask is not None:
        sel = sel & qmask[:, None]
    votes = sel.sum(dim=0)                                 # [kp]
    upart = _stable_topk_idx(-votes, u_max)                # votes desc
    qsel = sel[:, upart] & (votes[upart] > 0)[None, :]
    return upart.to(torch.int32), qsel


@dataclasses.dataclass
class QueryPlan:
    """One search: probe set + per-query mask + post-filter + k.
    `queries` are already metric-normalised."""

    queries: torch.Tensor                 # [Q, d] f32
    part_ids: torch.Tensor                # [n] int32
    qsel: Optional[torch.Tensor]          # [Q, n] bool (None: all queries)
    k: int = 10
    kind: str = "ann"                     # ann | exact
    attr_filter: Optional[AttrFilter] = None


def plan_ann(index: IVFIndex, queries: torch.Tensor, k: int, n_probe: int,
             attr_filter: Optional[AttrFilter] = None,
             u_max: Optional[int] = None,
             qmask: Optional[torch.Tensor] = None) -> QueryPlan:
    """ANN / batched-MQO plan: per-query probe sets over one shared scan
    union; `qmask` False rows (bucket padding) cast no votes."""
    cfg = index.config
    q = normalize_if_cosine(queries.to(torch.float32), cfg.metric)
    upart, qsel = _probe_union(index.centroids, index.counts, cfg.metric, q,
                               n_probe, u_max=u_max, qmask=qmask)
    return QueryPlan(queries=q, part_ids=upart, qsel=qsel, k=k, kind="ann",
                     attr_filter=attr_filter)


def plan_exact(index: IVFIndex, queries: torch.Tensor, k: int,
               attr_filter: Optional[AttrFilter] = None) -> QueryPlan:
    """Exact plan: probe set = every partition, no selection mask."""
    q = normalize_if_cosine(queries.to(torch.float32), index.config.metric)
    return QueryPlan(queries=q,
                     part_ids=torch.arange(index.k, dtype=torch.int32,
                                           device=q.device),
                     qsel=None, k=k, kind="exact", attr_filter=attr_filter)


# ---------------------------------------------------------------------------
# The fused scans
# ---------------------------------------------------------------------------


def fused_scan(queries, vectors, valid, ids, part_ids, k_out: int, *,
               metric: str = "l2", qsel=None, keep=None):
    """Alg. 2 hot loop over the float32 tier: probed partitions, batched
    distances, top-k, post-filter mask applied before selection. Returns
    (scores [Q, k_out], ids [Q, k_out]) in the rank convention (l2 drops
    ||q||^2). qsel None scans every probe for every query."""
    return ops.scan_topk_mqo(queries, vectors, valid, ids, part_ids, qsel,
                             k_out, metric=metric, keep=keep)


def fused_sq_scan(queries, codes, qstats, valid, part_ids, k_out: int, *,
                  metric: str = "l2", qsel=None, keep=None, norms=None):
    """Candidate stage of the quantized two-stage search: the int8-domain
    scan over the code tier, emitting flat row ids (p * p_max + slot) for
    the float32 rerank; scores are approximate."""
    return ops.sq_scan_topk(queries, codes, qstats.lo, qstats.scale, valid,
                            None, part_ids, k_out, metric=metric, qsel=qsel,
                            keep=keep, norms=norms)


# ---------------------------------------------------------------------------
# Plan execution (scan + delta merge + dedup epilogue)
# ---------------------------------------------------------------------------


def _delta_candidates_from(delta, metric: str, q: torch.Tensor,
                           attr_filter: Optional[AttrFilter]):
    """The delta partition, always scanned (§3.6), in rank convention."""
    dots = f32_matmul(q, delta.vectors.T)                   # [Q, cap]
    if metric in ("ip", "cosine"):
        scores = -dots
    else:
        scores = torch.sum(delta.vectors * delta.vectors,
                           dim=-1)[None, :] - 2.0 * dots
    ok = delta.valid
    if attr_filter is not None:
        ok = ok & attr_filter(delta.attrs)
    return (mask_scores(scores, ok[None, :]),
            delta.ids[None, :].expand_as(scores))


def _merge_epilogue(delta, metric: str, q, s, i, k: int, k_scan: int,
                    attr_filter: Optional[AttrFilter]):
    """Shared tail of every search: delta merge + dedup + l2 restore."""
    ds, di = _delta_candidates_from(delta, metric, q, attr_filter)
    k_final = min(k, k_scan + ds.shape[-1])
    s, i = merge_topk(s, i, ds, di, k_final)
    s, i = dedup_by_id(s, i)
    if metric == "l2":
        # restore full squared distances (the scan drops ||q||^2)
        q2 = torch.sum(q * q, dim=-1, keepdim=True)
        s = torch.where(i == INVALID_ID, torch.full_like(s, MASKED_SCORE),
                        s + q2)
    return s, i


def _rescore_exact(q, v, got, ids, k_out: int, metric: str):
    """Exact float32 rescore of gathered candidate rows [Q, c, d]."""
    dots = torch.einsum("qd,qcd->qc", q, v)
    if metric in ("ip", "cosine"):
        s = -dots
    else:
        s = torch.sum(v * v, dim=-1) - 2.0 * dots
    s = mask_scores(s, got)
    ids = torch.where(got, ids, torch.full_like(ids, INVALID_ID))
    return topk_smallest(s, ids, k_out)


def _rerank_float32(index: IVFIndex, q: torch.Tensor, rows: torch.Tensor,
                    k_out: int):
    """Stage 2 of the quantized path: gather the candidate rows' float32
    vectors and recompute exact distances. `rows` are flat row indices
    (partition * p_max + slot), INVALID_ID where the scan found fewer."""
    kp, p_max, d = index.vectors.shape
    total = kp * p_max
    got = rows != INVALID_ID
    r = torch.clamp(rows, 0, total - 1).long()
    v = index.vectors.reshape(total, d)[r]                  # [Q, k', d]
    ids = index.ids.reshape(total)[r]                       # [Q, k']
    return _rescore_exact(q, v, got, ids, k_out, index.config.metric)


def execute_plan(index: IVFIndex, plan: QueryPlan,
                 quantized: Optional[bool] = None) -> SearchResult:
    """Run a QueryPlan through the fused scan + delta epilogue.

    `quantized` selects the scan tier on an index with int8 codes: None
    uses the codes when present, False forces float32, True requires
    codes. Only "ann" plans use the code tier; "exact" keeps its
    100%-recall contract over the float32 tier."""
    cfg = index.config
    q = plan.queries
    p_max = index.p_max
    f = plan.attr_filter
    if quantized is None:
        quantized = index.codes is not None
    elif quantized and index.codes is None:
        raise ValueError("quantized=True needs an index with int8 codes")
    keep = f(index.attrs) if f is not None else None
    n = plan.part_ids.shape[0]
    if quantized and plan.kind == "ann":
        # two-stage: the int8 scan selects k' candidate rows, then the
        # exact float32 rerank; the kernel emits -1 itself where fewer
        # than k' rows qualify, so nothing is re-emitted
        k_cand = min(max(plan.k, plan.k * cfg.rerank_factor), n * p_max)
        _, cand_rows = fused_sq_scan(
            q, index.codes, index.qstats, index.valid, plan.part_ids,
            k_cand, metric=cfg.metric, qsel=plan.qsel, keep=keep,
            norms=index.code_norms)
        k_scan = min(plan.k, k_cand)
        s, i = _rerank_float32(index, q, cand_rows, k_scan)
    else:
        k_scan = min(plan.k, n * p_max)
        s, i = fused_scan(q, index.vectors, index.valid, index.ids,
                          plan.part_ids, k_scan, metric=cfg.metric,
                          qsel=plan.qsel, keep=keep)
    s, i = _merge_epilogue(index.delta, cfg.metric, q, s, i, plan.k, k_scan,
                           f)
    return SearchResult(ids=i, scores=s)


def _spec_filter(spec: QuerySpec) -> Optional[AttrFilter]:
    """Spec predicate -> post-filter callable (trees through the memoised
    compile_filter; compiled callables pass through)."""
    if spec.predicate is None:
        return None
    if callable(spec.predicate):
        return spec.predicate
    return compile_filter(spec.predicate)


def _run_spec(index: IVFIndex, queries: torch.Tensor,
              qmask: torch.Tensor, spec: QuerySpec) -> SearchResult:
    f = _spec_filter(spec)
    if spec.kind == "exact":
        plan = plan_exact(index, queries, spec.k, f)
    else:
        if f is not None and spec.hybrid != "post":
            raise NotImplementedError(_PREFILTER_TODO)
        plan = plan_ann(index, queries, spec.k, spec.n_probe, f,
                        u_max=spec.u_max, qmask=qmask)
    return execute_plan(index, plan, quantized=spec.use_quantized)


def _bucket(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def run(index: IVFIndex, queries, spec: QuerySpec, *,
        bucket: bool = True) -> ResultSet:
    """Execute a QuerySpec against a resident IVFIndex -- the single query
    entry point. The query count is padded to the next power of two
    (padding rows are masked out of the plan and sliced off the result),
    as in the JAX package, so a stream of batch sizes meets few distinct
    shapes (what a captured CUDA graph per shape would need)."""
    _check_backend(index, spec.on_backend)
    dev = index.device
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    q = torch.atleast_2d(q)
    Q = q.shape[0]
    b = _bucket(Q) if bucket else Q
    if b != Q:
        q = torch.cat([q, torch.zeros((b - Q, q.shape[1]), dtype=q.dtype,
                                      device=dev)])
    qmask = torch.arange(b, device=dev) < Q
    res = _run_spec(index, q, qmask, spec)
    if b != Q:
        res = SearchResult(ids=res.ids[:Q], scores=res.scores[:Q])
    return ResultSet.of(res, spec)


def run_coalesced(index: IVFIndex, chunks, spec: QuerySpec):
    """Concatenate per-caller query chunks sharing one spec, run ONE
    bucketed scan, and split the ResultSet back per caller. Each query's
    scores are elementwise over its own probes, so a caller's slice equals
    its solo run()."""
    if len(chunks) < 1:
        raise ValueError("run_coalesced needs at least one chunk")
    dev = index.device
    qs = [torch.atleast_2d(torch.as_tensor(c, dtype=torch.float32,
                                           device=dev)) for c in chunks]
    sizes = [int(q.shape[0]) for q in qs]
    if len(qs) == 1:
        return [run(index, qs[0], spec)]
    return run(index, torch.cat(qs, dim=0), spec).split(sizes)
