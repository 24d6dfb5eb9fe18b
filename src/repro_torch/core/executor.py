"""Query execution (port of repro.core.executor): every resident search is
a QueryPlan run by one fused scan, and a paged search streams the same
plan through the frame pool.

Plan model (paper Alg. 2 generalised):
    probe set         part_ids [n]  -- shared partition scan list
    selection mask    qsel [Q, n]   -- which query wants which partition
    post-filter       the compiled predicate's program, evaluated by the
                      scan kernels on each probed row's attrs (an opaque
                      filter callable: its [k, p_max] keep mask instead)
    k                 top-k width
Exact = probe everything; pre-filter = compact the qualifying rows into
virtual partitions and scan those (§3.5, cost ~ the gather cap); small
batches on the "torch" backend gather each query's own probes
(plan_ann_gather) instead of the shared union. On an
int8 index an ann plan scans the code tier for k' = rerank_factor * k
candidate rows (kernels/sq_scan.py) and reranks them exactly in float32;
every other plan runs the float32 scan (kernels/ivf_scan.py). The delta
merge, dedup and ||q||^2 restore close every path.

Paged execution (`paged_search`, on a PagedIndex): the probe union comes
from the same `_probe_union` as plan_ann, so paged and resident searches
scan partitions in the same order; the union is faulted into the frame
pool chunk by chunk and each chunk scanned by the same kernels with frame
indices as the probe list and asset ids as the ids; chunk top-k lists
merge with the stable merge_topk; an int8 pool's candidates are reranked
from SQLite. Every scan, fault write and rerank runs on the device's
current stream, and no chunk waits on the device.

Backends follow the index's device: "cuda" launches the hand-written
kernels, "torch" runs their plain versions on the CPU. A spec naming the
other device's backend raises; nothing switches silently.

Differences from the JAX package, each deliberate:
  * an opaque filter callable, or a tree over the program's limits (no
    `.program`), is evaluated into a keep mask over the whole index (the
    frame pool, when paged) before the scan (JAX traces any callable into
    its kernel);
  * the probe union is ordered by (votes descending, partition id
    ascending) -- the order lax.top_k gives -- so partitions are scanned,
    and score ties broken, in the same order as the reference;
  * a pre-filter spec without a cap raises ValueError (the reference
    asserts);
  * a spec whose scan keeps more than MAX_SCAN_K candidates per query
    raises ValueError on both devices (the reference has no bound; see
    MAX_SCAN_K);
  * there is no jit, so nothing compiles per spec: `run_count()` counts
    fused scan calls (one per run / run_coalesced / paged_search), and a
    traced scan span carries the K1/K2 `launches` it made and the kernel
    libraries it loaded (`compiled`, build.load_count()) where the
    reference counts jit traces.

Tracing (obs/trace.py): every search runs its stages through
`obs_trace.stage`, each where its work is done: probe (the plan's probe
union, the gather plan's probes, the pre-filter compaction; the exact
plan's "every partition"), scan (the fused K1 / K2 call, or the gather
plan's scoring), rerank (the int8 tier's float32 rerank, from SQLite
when paged) and merge (the delta epilogue), with the pager's fault spans
between a paged search's probe and scans. With a trace active a stage
adds its host time and counters to its span; under torch.profiler it is
a "micronn.<stage>" range. No stage waits for the device: the probe
union's size stays a device tensor until the trace's finish reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..kernels import build, ops
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import quantize
from .hybrid import compile_filter
from .query import QuerySpec, ResultSet
from .topk import dedup_by_id, mask_scores, merge_topk, topk_smallest
from .types import (INVALID_ID, MASKED_SCORE, IVFIndex, PagedIndex,
                    SearchResult, normalize_if_cosine,
                    normalize_rows, pairwise_scores, pairwise_sum,
                    row_matmul, to_device)

# attr_filter: [..., n_attr] float32 -> [...] bool (hybrid.compile_filter)
AttrFilter = Callable[[torch.Tensor], torch.Tensor]

# Most candidates one scan keeps per query (its k_out). Pass 2 of K1 / K2
# merges a query's lists in shared memory: 3 * k_out 8-byte keys plus two
# ints per chunk (csrc/topk_common.cuh, pass2_smem_bytes). H100 gives a
# block at most 227 KB = 232,448 bytes, and a scan has at most 2 * 132 = 264
# chunks, so k_out <= (232,448 - 2 * 264 * 4) / 24 = 9,597; 9,216 = 9 * 1024
# leaves a margin (pass 1 then takes at most ~190 KB at d = 960). A spec
# needing more raises ValueError on every device, before any planning.
MAX_SCAN_K = 9216

# Fused scan calls so far: one per run() (run_coalesced included) and per
# paged_search(); the port's counterpart of the reference's jit trace count.
_RUN_COUNT = 0


def run_count() -> int:
    """Fused scan calls made in this process (run / run_coalesced /
    paged_search, one each)."""
    return _RUN_COUNT


def _scan_launches() -> int:
    c = ops.launch_counts()
    return c["ivf_scan_topk"] + c["sq_scan_topk"]


def _own_backend(index) -> str:
    return "cuda" if index.device.type == "cuda" else "torch"


def _backend(index, spec: QuerySpec) -> str:
    return spec.on_backend or _own_backend(index)


def _check_backend(index: IVFIndex, requested: Optional[str]) -> None:
    """A spec's backend must be its index's: "cuda" on a CUDA index,
    "torch" on a CPU one (or None)."""
    own = _own_backend(index)
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
                 qmask: Optional[torch.Tensor] = None,
                 stage=obs_trace.NO_STAGE):
    """Shared probe set + per-query selection (paper §3.4): the union is
    the u_max most-voted partitions, ordered by (votes desc, pid asc), and
    `qsel` masks each query back onto its own probes. A live `stage` is
    given the partitions any query probes (before the u_max cut) as a
    device tensor."""
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
    if stage:
        stage.note(partitions=torch.count_nonzero(votes))
    upart = _stable_topk_idx(-votes, u_max)                # votes desc
    qsel = sel[:, upart] & (votes[upart] > 0)[None, :]
    return upart.to(torch.int32), qsel


@dataclasses.dataclass
class QueryPlan:
    """One search: probe set + per-query mask + predicate + k. `queries`
    are already metric-normalised. For kind "prefilter" the probe set is
    replaced by `rows`, a fixed-cap compaction of the qualifying flat row
    indices, which execute_plan repacks into virtual partitions."""

    queries: torch.Tensor                 # [Q, d] f32
    part_ids: Optional[torch.Tensor]      # [n] int32 (None for prefilter)
    qsel: Optional[torch.Tensor]          # [Q, n] bool (None: all queries)
    k: int = 10
    kind: str = "ann"                     # ann | exact | prefilter
    #                                       | ann_gather
    attr_filter: Optional[AttrFilter] = None
    rows: Optional[torch.Tensor] = None   # [cap] int32 (prefilter only)
    parts_pq: Optional[torch.Tensor] = None  # [Q, n] int32 (ann_gather)


def plan_ann(index: IVFIndex, queries: torch.Tensor, k: int, n_probe: int,
             attr_filter: Optional[AttrFilter] = None,
             u_max: Optional[int] = None,
             qmask: Optional[torch.Tensor] = None) -> QueryPlan:
    """ANN / batched-MQO plan: per-query probe sets over one shared scan
    union; `qmask` False rows (bucket padding) cast no votes."""
    cfg = index.config
    with obs_trace.stage(obs_trace.STAGE_PROBE) as st:
        q = normalize_if_cosine(queries.to(torch.float32), cfg.metric)
        upart, qsel = _probe_union(index.centroids, index.counts, cfg.metric,
                                   q, n_probe, u_max=u_max, qmask=qmask,
                                   stage=st)
        if st:
            st.note(n_probe=int(min(n_probe, index.k)), kind="ann")
    return QueryPlan(queries=q, part_ids=upart, qsel=qsel, k=k, kind="ann",
                     attr_filter=attr_filter)


# Largest (bucketed) query count routed to the per-query gather plan on
# the "torch" backend (the reference's value): below it the gather's
# direct [Q, n_probe] scan is cheaper than the union's vote and top-k
# plumbing. The "cuda" backend keeps the union plan at every Q.
SMALL_Q_GATHER_MAX = 8


def plan_ann_gather(index: IVFIndex, queries: torch.Tensor, k: int,
                    n_probe: int,
                    attr_filter: Optional[AttrFilter] = None,
                    qmask: Optional[torch.Tensor] = None) -> QueryPlan:
    """Small-Q ANN plan: each query's own n_probe nearest partitions, no
    shared union. Execution gathers each query's [n_probe, p_max] block
    and scores it directly; the candidate set is plan_ann's at equal
    n_probe, so ids agree and scores agree within float32 summation
    order. `qmask` False rows (bucket padding) are left out of the probe
    span's count."""
    with obs_trace.stage(obs_trace.STAGE_PROBE) as st:
        q = normalize_if_cosine(queries.to(torch.float32),
                                index.config.metric)
        parts = find_nearest_centroids(index, q, n_probe)   # [Q, n]
        if st:
            sel = torch.zeros((q.shape[0], index.k), dtype=torch.bool,
                              device=q.device).scatter_(1, parts, True)
            if qmask is not None:
                sel = sel & qmask[:, None]
            st.note(partitions=sel.any(dim=0).sum(),
                    n_probe=int(min(n_probe, index.k)), kind="ann")
    return QueryPlan(queries=q, part_ids=None, qsel=None, k=k,
                     kind="ann_gather", attr_filter=attr_filter,
                     parts_pq=parts.to(torch.int32))


def plan_exact(index: IVFIndex, queries: torch.Tensor, k: int,
               attr_filter: Optional[AttrFilter] = None) -> QueryPlan:
    """Exact plan: probe set = every partition, no selection mask."""
    with obs_trace.stage(obs_trace.STAGE_PROBE) as st:
        q = normalize_if_cosine(queries.to(torch.float32),
                                index.config.metric)
        part_ids = torch.arange(index.k, dtype=torch.int32, device=q.device)
        if st:
            st.note(partitions=int(index.k), n_probe=int(index.k),
                    kind="exact")
    return QueryPlan(queries=q, part_ids=part_ids, qsel=None, k=k,
                     kind="exact", attr_filter=attr_filter)


def compact_rows(ok: torch.Tensor, cap: int) -> torch.Tensor:
    """[N] bool -> [cap] int32: the indices of the True entries in
    ascending order, truncated to the first `cap` and padded with N -- what
    jnp.nonzero(ok, size=cap, fill_value=N) gives -- by a cumsum and a
    scatter, with no host sync (torch.nonzero waits for the device)."""
    n = ok.shape[0]
    rank = torch.cumsum(ok.to(torch.int64), 0) - 1
    # rows past the cap, and rows that do not qualify, land in a dump slot
    dest = torch.where(ok & (rank < cap), rank, torch.full_like(rank, cap))
    out = torch.full((cap + 1,), n, dtype=torch.int32, device=ok.device)
    out.scatter_(0, dest, torch.arange(n, dtype=torch.int32,
                                       device=ok.device))
    return out[:cap]


def plan_prefilter(index: IVFIndex, queries: torch.Tensor, k: int,
                   attr_filter: AttrFilter, cap: int) -> QueryPlan:
    """Pre-filtering plan (paper §3.5): evaluate the predicate first and
    compact the qualifying row indices into the `cap` budget; execution
    brute-forces over just those rows, so its cost follows the predicate's
    selectivity."""
    with obs_trace.stage(obs_trace.STAGE_PROBE) as st:
        q = normalize_if_cosine(queries.to(torch.float32),
                                index.config.metric)
        kp, p_max, _ = index.vectors.shape
        ok = index.valid.reshape(-1) & attr_filter(
            index.attrs.reshape(kp * p_max, index.n_attr))
        rows = compact_rows(ok, cap)
        if st:
            st.note(partitions=0, rows_cap=int(cap), kind="prefilter")
    return QueryPlan(queries=q, part_ids=None, qsel=None, k=k,
                     kind="prefilter", attr_filter=attr_filter, rows=rows)


# ---------------------------------------------------------------------------
# The fused scans
# ---------------------------------------------------------------------------


def scan_filter(attr_filter: Optional[AttrFilter], attrs):
    """A post-filter as the scan kernels take it -> (keep, attrs, program):
    a compiled predicate's program with the attribute tensor it reads in
    the scan, or, for an opaque callable or a tree over the program's
    limits (no `.program`), its keep mask over `attrs`. (None, None, None)
    without a filter."""
    if attr_filter is None:
        return None, None, None
    program = getattr(attr_filter, "program", None)
    if program is not None:
        return None, attrs, program
    return attr_filter(attrs), None, None


def fused_scan(queries, vectors, valid, ids, part_ids, k_out: int, *,
               metric: str = "l2", qsel=None, keep=None, attrs=None,
               program=None):
    """Alg. 2 hot loop over the float32 tier: probed partitions, batched
    distances, top-k, the post-filter (a predicate program over `attrs`,
    or a keep mask) applied in the scan before selection. Returns
    (scores [Q, k_out], ids [Q, k_out]) in the rank convention (l2 drops
    ||q||^2). qsel None scans every probe for every query."""
    return ops.scan_topk_mqo(queries, vectors, valid, ids, part_ids, qsel,
                             k_out, metric=metric, keep=keep, attrs=attrs,
                             program=program)


def fused_sq_scan(queries, codes, qstats, valid, part_ids, k_out: int, *,
                  metric: str = "l2", qsel=None, keep=None, norms=None,
                  ids=None, attrs=None, program=None):
    """Candidate stage of the quantized two-stage search: the int8-domain
    scan over the code tier, emitting flat row ids (p * p_max + slot) for
    the resident rerank, or `ids` (a paged pool's asset ids) where given;
    scores are approximate."""
    return ops.sq_scan_topk(queries, codes, qstats.lo, qstats.scale, valid,
                            ids, part_ids, k_out, metric=metric, qsel=qsel,
                            keep=keep, norms=norms, attrs=attrs,
                            program=program)


# ---------------------------------------------------------------------------
# Plan execution (scan + delta merge + dedup epilogue)
# ---------------------------------------------------------------------------


def _delta_candidates_from(delta, metric: str, q: torch.Tensor,
                           attr_filter: Optional[AttrFilter]):
    """The delta partition, always scanned (§3.6), in rank convention. The
    products run in fixed-shape row blocks (row_matmul), so a query's delta
    scores do not depend on its batch."""
    dots = row_matmul(q, delta.vectors.T)                   # [Q, cap]
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
                    attr_filter: Optional[AttrFilter],
                    qmask: Optional[torch.Tensor] = None):
    """Shared tail of every search, resident and paged alike: delta merge
    + dedup + l2 restore (`qmask` False rows are bucket padding)."""
    ds, di = _delta_candidates_from(delta, metric, q, attr_filter)
    if qmask is not None:
        ds = mask_scores(ds, qmask[:, None])
    k_final = min(k, k_scan + ds.shape[-1])
    s, i = merge_topk(s, i, ds, di, k_final)
    s, i = dedup_by_id(s, i)
    if metric == "l2":
        # restore full squared distances (the scan drops ||q||^2)
        q2 = pairwise_sum(q * q)[:, None]
        s = torch.where(i == INVALID_ID, torch.full_like(s, MASKED_SCORE),
                        s + q2)
    return s, i


# Elements of the [Q, c, d] products one rescore step forms (1 GiB of
# float32): larger batches are rescored in slices of queries.
_RESCORE_ELEMS = 1 << 28


def _rescore_exact(q, v, got, ids, k_out: int, metric: str):
    """Exact float32 rescore of gathered candidate rows [Q, c, d]. The dot
    products and norms are summed by pairwise_sum, so a candidate's score
    has the same bits in any batch (a batched library product picks its
    kernel, and its order, by the batch's shape)."""
    step = max(1, _RESCORE_ELEMS // max(1, v.shape[1] * v.shape[2]))
    parts = []
    for a in range(0, q.shape[0], step):
        va = v[a:a + step]
        dots = pairwise_sum(q[a:a + step, None, :] * va)
        parts.append(-dots if metric in ("ip", "cosine")
                     else pairwise_sum(va * va) - 2.0 * dots)
    s = mask_scores(torch.cat(parts) if len(parts) > 1 else parts[0], got)
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


def gather_rows(index: IVFIndex, rows: torch.Tensor):
    """The pre-filter plan's scan input: the [cap] compacted flat rows
    (index kp * p_max marks an empty slot) gathered into ceil(cap / p_max)
    virtual partitions. -> (vectors [v, p_max, d], valid [v, p_max],
    ids [v, p_max], part_ids [v] = 0..v-1)."""
    kp, p_max, d = index.vectors.shape
    total = kp * p_max
    got = rows < total
    r = torch.clamp(rows, max=total - 1).long()
    cap = r.shape[0]
    vparts = -(-cap // p_max)
    pad = vparts * p_max - cap
    dev = rows.device
    sub_v = torch.cat([index.vectors.reshape(total, d)[r],
                       torch.zeros((pad, d), dtype=torch.float32,
                                   device=dev)])
    sub_i = torch.cat([torch.where(got, index.ids.reshape(total)[r],
                                   torch.full_like(rows, INVALID_ID)),
                       torch.full((pad,), INVALID_ID, dtype=torch.int32,
                                  device=dev)])
    sub_ok = torch.cat([got, torch.zeros((pad,), dtype=torch.bool,
                                         device=dev)])
    return (sub_v.reshape(vparts, p_max, d), sub_ok.reshape(vparts, p_max),
            sub_i.reshape(vparts, p_max),
            torch.arange(vparts, dtype=torch.int32, device=dev))


def execute_plan(index: IVFIndex, plan: QueryPlan,
                 quantized: Optional[bool] = None) -> SearchResult:
    """Run a QueryPlan through the fused scan + delta epilogue, as the
    stages scan, rerank (the int8 tier only) and merge.

    `quantized` selects the scan tier on an index with int8 codes: None
    uses the codes when present, False forces float32, True requires
    codes. Only "ann" plans use the code tier; "exact" keeps its
    100%-recall contract over the float32 tier."""
    cfg = index.config
    q = plan.queries
    if quantized is None:
        quantized = index.codes is not None
    elif quantized and index.codes is None:
        raise ValueError("quantized=True needs an index with int8 codes")
    with obs_trace.stage(obs_trace.STAGE_SCAN) as st:
        if st:
            l0, c0 = _scan_launches(), build.load_count()
        s, i, k_scan, cand_rows = _scan_plan(index, plan, quantized)
        if st:
            _note_scan(st, index, plan, cand_rows is not None,
                       _scan_launches() - l0, build.load_count() - c0)
    if cand_rows is not None:
        # stage 2 of the two-stage search: the exact float32 rerank
        with obs_trace.stage(obs_trace.STAGE_RERANK) as st:
            s, i = _rerank_float32(index, q, cand_rows, k_scan)
            if st:
                _note_rerank(st, index, plan)
    with obs_trace.stage(obs_trace.STAGE_MERGE) as st:
        s, i = _merge_epilogue(index.delta, cfg.metric, q, s, i, plan.k,
                               k_scan, plan.attr_filter)
        if st:
            st.note(fused=1)
    return SearchResult(ids=i, scores=s)


def _scan_plan(index: IVFIndex, plan: QueryPlan, quantized: bool):
    """The plan's scan -> (scores, ids, k_scan, cand_rows). On the int8
    tier the scan selects k' candidate rows for the float32 rerank
    (`cand_rows`; scores and ids None), else cand_rows is None."""
    cfg = index.config
    q = plan.queries
    p_max = index.p_max
    if plan.kind == "prefilter":
        # repack the qualifying rows into virtual partitions for the same
        # scan (the predicate was applied at compaction)
        sub_v, sub_ok, sub_i, vpart = gather_rows(index, plan.rows)
        k_scan = min(plan.k, sub_ok.numel())
        s, i = fused_scan(q, sub_v, sub_ok, sub_i, vpart, k_scan,
                          metric=cfg.metric)
        return s, i, k_scan, None
    if plan.kind == "ann_gather":
        return _scan_gather(index, plan, quantized)
    keep, attrs, prog = scan_filter(plan.attr_filter, index.attrs)
    n = plan.part_ids.shape[0]
    if quantized and plan.kind == "ann":
        # the int8 scan selects k' candidate rows; the kernel emits -1
        # itself where fewer than k' rows qualify, so nothing is re-emitted
        k_cand = min(max(plan.k, plan.k * cfg.rerank_factor), n * p_max)
        _, cand_rows = fused_sq_scan(
            q, index.codes, index.qstats, index.valid, plan.part_ids,
            k_cand, metric=cfg.metric, qsel=plan.qsel, keep=keep,
            norms=index.code_norms, attrs=attrs, program=prog)
        return None, None, min(plan.k, k_cand), cand_rows
    k_scan = min(plan.k, n * p_max)
    s, i = fused_scan(q, index.vectors, index.valid, index.ids,
                      plan.part_ids, k_scan, metric=cfg.metric,
                      qsel=plan.qsel, keep=keep, attrs=attrs, program=prog)
    return s, i, k_scan, None


def _note_scan(st, index: IVFIndex, plan: QueryPlan, use_sq: bool,
               launches: int, compiled: int) -> None:
    """The scan span's counters: the probed partitions and their rows,
    one chunk, the K1/K2 launches and kernel loads of the scan, fused=1
    (the plan's stages run in one call, as in the reference). The probe
    span's count is a device tensor on the ann routes; without a probe
    span every partition counts."""
    n = st.trace.counter(obs_trace.STAGE_PROBE, "partitions",
                         default=int(index.k))
    st.note(partitions=n, rows=n * index.p_max, chunks=1,
            backend=_own_backend(index), q_bucket=int(plan.queries.shape[0]),
            quantized=use_sq, launches=launches, compiled=compiled,
            cache_hit=(compiled == 0), fused=1)


def _note_rerank(st, index: IVFIndex, plan: QueryPlan) -> None:
    """The rerank span's counters: each query's k' candidates, at most the
    scan's rows."""
    rf = index.config.rerank_factor
    kc = max(plan.k, plan.k * rf)
    rows = st.trace.counter(obs_trace.STAGE_SCAN, "rows")
    per_q = torch.clamp(rows, max=kc) if isinstance(rows, torch.Tensor) \
        else min(kc, rows)
    st.note(fused=1, rf=int(rf), candidates=int(plan.queries.shape[0])
            * per_q)


def _scan_gather(index: IVFIndex, plan: QueryPlan, quantized: bool):
    """The small-Q gather plan (plain PyTorch, the "torch" backend): each
    query's [n_probe, p_max] probe block scored directly. An int8 index
    keeps the two-stage contract: the int8-domain gathered scan (both
    folded terms in one exact contraction) for k' candidate rows, which
    execute_plan reranks in float32. -> (scores, ids, k_scan, cand_rows),
    as _scan_plan."""
    cfg = index.config
    q = plan.queries
    kp, p_max, d = index.vectors.shape
    parts = plan.parts_pq.long()                           # [Q, n]
    n_q, npb = parts.shape
    pok = index.valid[parts]                               # [Q, n, p_max]
    if plan.attr_filter is not None:
        pok = pok & plan.attr_filter(index.attrs[parts])
    pok = pok.reshape(n_q, npb * p_max)
    if quantized:
        k_cand = min(max(plan.k, plan.k * cfg.rerank_factor), npb * p_max)
        q_i8, alpha, beta = quantize.fold_queries(index.qstats, q)
        qt = q_i8.reshape(2, n_q, d)
        at = alpha.reshape(2, n_q)
        pc = index.codes[parts]                            # [Q, n, p_max, d]
        if d <= 1024:   # integer products and sums below 2^24: exact
            acc = torch.einsum("tqd,qnpd->tqnp", qt.to(torch.float32),
                               pc.to(torch.float32))
        else:
            acc = torch.einsum("tqd,qnpd->tqnp", qt.to(torch.float64),
                               pc.to(torch.float64)).to(torch.float32)
        terms = at[:, :, None, None] * acc                 # [2, Q, n, p_max]
        dots = terms[0] + terms[1] + beta[:, None, None]
        if cfg.metric in ("ip", "cosine"):
            scores = -dots
        else:
            v2 = index.code_norms[parts] if index.code_norms is not None \
                else quantize.row_norms(index.qstats, pc)
            scores = v2 - 2.0 * dots
        scores = mask_scores(scores.reshape(n_q, npb * p_max), pok)
        # flat row ids (partition * p_max + slot) feed the f32 rerank
        rid = (parts.to(torch.int32)[:, :, None] * p_max
               + torch.arange(p_max, dtype=torch.int32,
                              device=q.device)[None, None, :])
        cand_s, cand_rows = topk_smallest(
            scores, rid.reshape(n_q, npb * p_max), k_cand)
        cand_rows = torch.where(cand_s >= MASKED_SCORE,
                                torch.full_like(cand_rows, INVALID_ID),
                                cand_rows)
        return None, None, min(plan.k, k_cand), cand_rows
    pv = index.vectors[parts]                              # [Q, n, p_max, d]
    dots = torch.einsum("qd,qnpd->qnp", q, pv)
    if cfg.metric in ("ip", "cosine"):
        scores = -dots
    else:
        scores = torch.sum(pv * pv, dim=-1) - 2.0 * dots
    scores = mask_scores(scores.reshape(n_q, npb * p_max), pok)
    k_scan = min(plan.k, npb * p_max)
    s, i = topk_smallest(scores, index.ids[parts].reshape(n_q, npb * p_max),
                         k_scan)
    return s, i, k_scan, None


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
    """Route a spec to its plan: exact, the pre-filter plan for
    hybrid="pre", else the ANN plan with the predicate as a post-filter
    (an unresolved "auto" included, as in the reference; MicroNN.query
    resolves "auto" through the optimizer first)."""
    f = _spec_filter(spec)
    if spec.kind == "exact":
        plan = plan_exact(index, queries, spec.k, f)
    elif f is not None and spec.hybrid == "pre":
        if spec.cap is None:
            raise ValueError(
                "pre-filtering needs a gather cap: use spec.prefilter(cap) "
                "or let MicroNN.query size it from the selectivity "
                "estimate")
        plan = plan_prefilter(index, queries, spec.k, f, spec.cap)
    elif (queries.shape[0] <= SMALL_Q_GATHER_MAX and spec.u_max is None
          and _backend(index, spec) == "torch"):
        # small (bucketed) batches on the plain backend skip the shared
        # union, as the reference does off the TPU kernel path
        plan = plan_ann_gather(index, queries, spec.k, spec.n_probe, f,
                               qmask=qmask)
    else:
        plan = plan_ann(index, queries, spec.k, spec.n_probe, f,
                        u_max=spec.u_max, qmask=qmask)
    return execute_plan(index, plan, quantized=spec.use_quantized)


def _bucket(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def run(index, queries, spec: QuerySpec, *,
        bucket: bool = True) -> ResultSet:
    """Execute a QuerySpec against a resident IVFIndex or a PagedIndex --
    the single query entry point. The query count is padded to the next
    power of two (padding rows are masked out of the plan and sliced off
    the result), as in the JAX package, so a stream of batch sizes meets
    few distinct shapes (what a captured CUDA graph per shape would need).
    A PagedIndex streams the plan through its frame pool (paged_search)."""
    global _RUN_COUNT
    _check_backend(index, spec.on_backend)
    check_scan_k(index, spec)
    if isinstance(index, PagedIndex):
        if spec.predicate is not None and spec.hybrid == "pre":
            raise ValueError(
                "paged mode runs predicates as post-filters over the frame "
                "scan; pre-filtering needs the resident float32 tier")
        if spec.u_max is not None:
            # a capped union changes which partitions are scanned, and the
            # paged union mirrors the resident plan exactly
            raise ValueError("union_cap is not supported in paged mode")
        return paged_search(index, queries, k=spec.k, kind=spec.kind,
                            n_probe=spec.n_probe,
                            attr_filter=_spec_filter(spec),
                            quantized=spec.use_quantized, spec=spec)
    dev = index.device
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    q = torch.atleast_2d(q)
    Q = q.shape[0]
    b = _bucket(Q) if bucket else Q
    if b != Q:
        q = torch.cat([q, torch.zeros((b - Q, q.shape[1]), dtype=q.dtype,
                                      device=dev)])
    qmask = torch.arange(b, device=dev) < Q
    _RUN_COUNT += 1
    res = _run_spec(index, q, qmask, spec)
    if b != Q:
        res = SearchResult(ids=res.ids[:Q], scores=res.scores[:Q])
    return ResultSet.of(res, spec)


def check_scan_k(index, spec: QuerySpec) -> None:
    """Refuse, by name, a spec whose scan keeps more than MAX_SCAN_K
    candidates per query (k * rerank_factor on the int8 tier, else k)
    before any cut to the probed rows: K1 / K2's pass 2 would not fit the
    card's shared memory. Checked on every device, so both behave
    alike."""
    if isinstance(index, PagedIndex):
        use_sq = index.cache.payload == "int8"
    else:
        quantized = spec.use_quantized
        if quantized is None:
            quantized = index.codes is not None
        use_sq = bool(quantized) and spec.kind == "ann" and not (
            spec.predicate is not None and spec.hybrid == "pre")
    k_scan = max(spec.k, spec.k * index.config.rerank_factor) if use_sq \
        else spec.k
    if k_scan > MAX_SCAN_K:
        raise ValueError(f"QuerySpec k={spec.k}: the scan's k_scan={k_scan} "
                         f"exceeds MAX_SCAN_K={MAX_SCAN_K}")


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


def search(index, queries, *, k: int, kind: str = "ann", n_probe: int = 8,
           u_max: Optional[int] = None, cap: Optional[int] = None,
           attr_filter: Optional[AttrFilter] = None,
           backend: Optional[str] = None, quantized: Optional[bool] = None,
           bucket: bool = True) -> ResultSet:
    """Kwarg shim over the QuerySpec entry point: builds the equivalent
    spec (kind "ann" | "exact" | "prefilter") and routes through run(), so
    equal kwargs and an equal hand-built spec take the same path."""
    if kind not in ("ann", "exact", "prefilter"):
        raise ValueError(f"kind must be 'ann', 'exact' or 'prefilter': "
                         f"{kind!r}")
    if kind == "prefilter" and (cap is None or attr_filter is None):
        raise ValueError("kind='prefilter' needs a cap and an attr_filter")
    pred = None if attr_filter is None else \
        getattr(attr_filter, "predicate", attr_filter)
    spec = QuerySpec(
        kind="exact" if kind == "exact" else "ann", k=k, n_probe=n_probe,
        u_max=u_max, cap=cap, predicate=pred,
        hybrid="pre" if kind == "prefilter" else
        ("post" if pred is not None else "auto"),
        use_quantized=quantized, on_backend=backend)
    return run(index, queries, spec, bucket=bucket)


# ---------------------------------------------------------------------------
# Paged execution: scan the memory-budgeted frame pool instead of a resident
# tier; an int8 pool's rerank gathers float32 rows from the durable store.
# ---------------------------------------------------------------------------


def _rerank_from_store(store, q: torch.Tensor, cand_ids: torch.Tensor,
                       k_out: int, metric: str):
    """Sibling of _rerank_float32 for the paged path: gather the candidate
    rows' float32 vectors from SQLite (one batched IN (...) over the
    unique asset ids), normalised on the host by the op recover() uses for
    the resident tier, and rescore them with the same _rescore_exact."""
    with obs_trace.stage(obs_trace.STAGE_RERANK) as st:
        cand = cand_ids.cpu().numpy()
        got = cand != INVALID_ID
        Q, kc = cand.shape
        v = np.zeros((Q, kc, store.dim), np.float32)
        n_uniq = 0
        if got.any():
            uniq = np.unique(cand[got])
            n_uniq = int(uniq.size)
            rows, found = store.vectors_for(uniq)
            rows = normalize_rows(rows, metric)
            idx = np.searchsorted(uniq, np.where(got, cand, uniq[0]))
            idx = np.clip(idx, 0, len(uniq) - 1)
            got = got & (uniq[idx] == cand) & found[idx]
            v[got] = rows[idx[got]]
        dev = cand_ids.device
        out = _rescore_exact(q, to_device([v], dev)[0],
                             to_device([got], dev)[0], cand_ids, k_out,
                             metric)
        if st:
            st.note(candidates=Q * kc, rows_gathered=n_uniq, k_out=k_out)
    return out


def _paged_probes(pindex: PagedIndex, q: torch.Tensor, n_probe: int,
                  qmask: Optional[torch.Tensor] = None):
    """plan_ann's probe construction over the paged index's metadata --
    literally _probe_union, so paged and resident searches agree on the
    probe order. -> (host [n] int64 partition ids, device qsel [Q, n])."""
    counts = torch.as_tensor(pindex.counts.astype(np.int32),
                             device=q.device)
    upart, qsel = _probe_union(pindex.centroids, counts,
                               pindex.config.metric, q, n_probe,
                               qmask=qmask)
    return upart.cpu().numpy().astype(np.int64), qsel


# Read-ahead: while the scan of chunk N runs, one worker thread STAGES chunk
# N+1 (the SQLite fetch + host packing, PartitionCache.stage), so the next
# fault pays only the device write. Staging takes no frames and no pins, so
# the chunking, and every result, is the same with it off.
PAGED_PREFETCH = True

_PREFETCHER = None


def _prefetcher():
    global _PREFETCHER
    if _PREFETCHER is None:
        from concurrent.futures import ThreadPoolExecutor
        _PREFETCHER = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="micronn-prefetch")
    return _PREFETCHER


def _wait_stage(pending):
    """Let a read-ahead land. Staging is advisory: if it failed, fault()
    reads the partitions from SQLite itself."""
    try:
        pending.result()
    except Exception:       # noqa: BLE001 -- advisory; fault() re-reads
        pass


def paged_search(pindex: PagedIndex, queries, *, k: int, kind: str = "ann",
                 n_probe: int = 8,
                 attr_filter: Optional[AttrFilter] = None,
                 quantized: Optional[bool] = None,
                 spec: Optional[QuerySpec] = None) -> ResultSet:
    """Run a search against a PagedIndex through the budgeted frame pool.

    The probe union is processed in chunks of at most the pool's capacity
    (its scan ring for exact): each chunk is faulted (pinned), scanned over
    the pool with frame indices as the probe list and asset ids as the
    ids, unpinned, and its top-k merged into the running result -- so the
    resident scan tier never exceeds the budget, even for an exact scan.
    Predicates mask the frame scan (the pool carries attrs frames); an
    int8 pool's candidates are reranked from SQLite."""
    global _RUN_COUNT
    _RUN_COUNT += 1
    cfg = pindex.config
    cache = pindex.cache
    dev = pindex.device
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32,
                                         device=dev))
    q = normalize_if_cosine(q, cfg.metric)
    Q = q.shape[0]
    b = _bucket(Q)
    if b != Q:
        q = torch.cat([q, torch.zeros((b - Q, q.shape[1]), dtype=q.dtype,
                                      device=dev)])
    qmask = torch.arange(b, device=dev) < Q
    # the pool's payload fixes the scan tier: an int8 pool runs the SQ scan
    # (paged exact on it is a full-probe near-oracle, not the f32 oracle)
    use_sq = cache.payload == "int8"
    if quantized is not None and bool(quantized) != use_sq:
        raise ValueError(f"the paged scan tier is fixed by the frame pool "
                         f"({cache.payload}); cannot force "
                         f"quantized={quantized}")
    if attr_filter is not None and cache.attrs_pool is None:
        raise ValueError("a predicate needs an attribute-backed frame pool "
                         "(a store with n_attr > 0)")
    if kind not in ("ann", "exact"):
        raise ValueError(f"kind must be 'ann' or 'exact': {kind!r}")
    with obs_trace.stage(obs_trace.STAGE_PROBE) as st:
        if kind == "exact":
            upart = np.nonzero(pindex.counts > 0)[0].astype(np.int64)
            qsel = qmask[:, None].expand(b, len(upart))
        else:
            upart, qsel = _paged_probes(pindex, q, n_probe, qmask=qmask)
        n = len(upart)
        if st:
            st.note(partitions=int(n), n_probe=int(n_probe), kind=kind)
    p_max = cache.p_max
    if use_sq:
        k_run = min(max(k, k * cfg.rerank_factor), max(n * p_max, 1))
    else:
        k_run = min(k, max(n * p_max, 1))
    run_s = torch.full((b, k_run), MASKED_SCORE, dtype=torch.float32,
                       device=dev)
    run_i = torch.full((b, k_run), INVALID_ID, dtype=torch.int32,
                       device=dev)
    # scan resistance: an exact search reads every partition once, so its
    # faults are not admitted -- they cycle through the scan ring and chunk
    # to its size, leaving the hot ANN working set resident
    admit = kind != "exact"
    chunk = cache.capacity if admit else cache.scan_frames
    prefetch = PAGED_PREFETCH and n > chunk
    starts = list(range(0, n, chunk))
    pending = None          # in-flight stage of the next chunk
    try:
        for c, s in enumerate(starts):
            cpids = upart[s:s + chunk]
            if pending is not None:
                _wait_stage(pending)
                pending = None
            frames = cache.fault(cpids, admit=admit)
            if prefetch and c + 1 < len(starts):
                s2 = starts[c + 1]
                pending = _prefetcher().submit(cache.stage,
                                               upart[s2:s2 + chunk])
            try:
                # read the pools after fault(): a resize rebinds them
                fidx = to_device([frames], dev)[0]
                keep, attrs, prog = scan_filter(attr_filter,
                                                cache.attrs_pool)
                cq = qsel[:, s:s + chunk]
                k_chunk = min(k_run, len(cpids) * p_max)
                with obs_trace.stage(obs_trace.STAGE_SCAN) as st:
                    if st:
                        l0, c0 = _scan_launches(), build.load_count()
                    if use_sq:
                        cs, ci = fused_sq_scan(
                            q, cache.payload_pool, pindex.qstats,
                            cache.valid_pool, fidx, k_chunk,
                            metric=cfg.metric, qsel=cq, keep=keep,
                            norms=cache.norms_pool, ids=cache.ids_pool,
                            attrs=attrs, program=prog)
                    else:
                        cs, ci = fused_scan(
                            q, cache.payload_pool, cache.valid_pool,
                            cache.ids_pool, fidx, k_chunk, metric=cfg.metric,
                            qsel=cq, keep=keep, attrs=attrs, program=prog)
                    if st:
                        compiled = build.load_count() - c0
                        st.note(chunks=1, partitions=len(cpids),
                                rows=len(cpids) * p_max,
                                backend=_own_backend(pindex),
                                quantized=use_sq, q_bucket=b,
                                launches=_scan_launches() - l0,
                                compiled=compiled, cache_hit=compiled == 0)
            finally:
                # the scan is enqueued on the stream every later fault
                # write into these frames uses, so unpinning here is safe
                cache.unpin(frames)
            run_s, run_i = merge_topk(run_s, run_i, cs, ci, k_run)
    finally:
        if pending is not None:
            _wait_stage(pending)
    if use_sq:
        # the frame scan emits asset ids: rerank the k' candidates from the
        # durable tier
        cand = torch.where(run_s >= MASKED_SCORE,
                           torch.full_like(run_i, INVALID_ID), run_i)
        k_scan = min(k, k_run)
        s_m, i_m = _rerank_from_store(cache.store, q, cand, k_scan,
                                      cfg.metric)
    elif n:
        k_scan = k_run
        s_m, i_m = run_s, run_i
    else:
        k_scan = 0
        s_m = torch.zeros((b, 0), dtype=torch.float32, device=dev)
        i_m = torch.zeros((b, 0), dtype=torch.int32, device=dev)
    with obs_trace.stage(obs_trace.STAGE_MERGE) as st:
        s_f, i_f = _merge_epilogue(pindex.delta, cfg.metric, q, s_m, i_m, k,
                                   k_scan, attr_filter, qmask=qmask)
        if st:
            st.note(k=int(k), k_scan=int(k_scan), fused=0)
    if b != Q:
        s_f, i_f = s_f[:Q], i_f[:Q]
    return ResultSet(ids=i_f, scores=s_f, spec=spec)


# the executor's instruments in the process registry, beside the pager's,
# the front door's and the scheduler's
_OBS = obs_metrics.default_registry().scope(component="executor")
_OBS.gauge("run_count", fn=run_count)
_OBS.gauge("kernel_loads", fn=build.load_count)
