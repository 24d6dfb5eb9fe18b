"""Distributed MicroNN (port of repro.distributed.sharded_index): the
paper's ANN search over partitions split across the ranks of a
`torch.distributed` device mesh.

Index layout on a (data, model) mesh:
  * centroids        split with their partitions (each rank scores its own)
  * partitions       [k, p_max, d] split on k over the `model` dimension:
                     rank r holds [r * k/m, (r+1) * k/m)  (`shard_index`)
  * delta            replicated, scored on model rank 0 only
  * queries          each rank passes its slice along the data dimensions;
                     the ranks of one model group hold the same queries

Search is Alg. 2 in four phases on every rank (`distributed_query`):
  1. local centroid scores            [Q, k/m] and a local top-n
  2. global top-n probe ids           hypercube tournament (or all-gather)
                                      over `model`: the union of the local
                                      top-n holds the global top-n
  3. owned-partition scan             the list of this rank's probed
                                      partitions with its per-query
                                      selection, through the executor's
                                      fused scan (K1 on the card, its plain
                                      version on the CPU)
  4. global top-k result merge        the delta on model rank 0, then the
                                      tournament (or all-gather) over
                                      `model`, dedup and the l2 restore

Collective bytes per batch: phase 2 moves n ids and scores per rank, phase 4
k results per rank; partition data never crosses ranks.

Differences from the JAX package, each deliberate:
  * the mesh is a `torch.distributed.device_mesh.DeviceMesh` with
    `mesh_dim_names`; `shard_index` returns this rank's local IVFIndex (the
    counterpart of `index_shardings`' placement);
  * phase 3 runs K1 (`ivf_scan_topk`) on the card: the reference forces
    XLA only because a `shard_map` body cannot host a Pallas call. The
    backend follows the shard's device (None, "cuda" or "torch");
  * phase 4 ends in the single-device epilogue (`dedup_by_id`, then
    ||q||^2 restored on l2), and the delta is scored by the executor's own
    helper, so a row's score has the bits `executor.run` gives it; the
    reference returns rank-convention scores;
  * equal scores resolve as in single-device search: each rank scans its
    probed partitions in the single-device union order (votes desc,
    partition asc, known to every rank from the probe ids) and the merges
    carry each candidate's single-device tie key (union position * p_max
    + slot; delta rows after all of them), so every rank ends with the
    same buffer; the reference ties by rank. The probe list pads with
    slots that scan nothing (the reference pads with partition 0 and can
    scan it twice);
  * `k % m != 0` is refused by name (the reference's `shard_map` needs it
    too) and nothing is padded; the refusals are ValueErrors;
  * on a gloo group, CUDA buffers cross through host memory
    (core/topk.py `_through_host`), counted and logged.

`local_cap` bounds the probe list per rank. Its default, the reference's
`n_probe`, covers one query; a batch whose probes on one rank exceed it
drops that rank's partitions with the fewest votes (the reference: the
highest-numbered), so pass `min(k/m, Q * n_probe)` for an exact batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core import executor
from ..core import topk as topk_lib
from ..core.query import Q, QuerySpec, ResultSet
from ..core.types import (INVALID_ID, MASKED_SCORE, IVFIndex,
                          normalize_if_cosine, pairwise_sum)

_MERGES = {"tournament": topk_lib.tournament_merge,
           "allgather": topk_lib.allgather_merge}


def _axis(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise ValueError(f"mesh has no dimension {name!r} (its dimensions: "
                         f"{names})")
    return names.index(name)


def shard_index(index: IVFIndex, mesh, model_axis: str = "model",
                device=None) -> IVFIndex:
    """This rank's local IVFIndex on a mesh: partitions [r * k/m, (r+1) *
    k/m) for model rank r of m, with `centroids`, `csizes`, `counts` (and
    `drift`) sliced to match; `vectors`, `ids`, `attrs` and `valid` on
    `device` (default: the index's); the delta and `base_mean_size`
    replicated; when quantized, the codes and code norms sliced and the
    quantizer stats replicated. A `k` that m does not divide raises
    ValueError."""
    m = mesh.size(_axis(mesh, model_axis))
    r = mesh.get_local_rank(model_axis)
    k = index.k
    if k % m:
        raise ValueError(f"shard_index: k={k} partitions do not split "
                         f"evenly over the {m} ranks of {model_axis!r}")
    dev = index.device if device is None else torch.device(device)
    lo, hi = r * (k // m), (r + 1) * (k // m)

    def part(t):
        return None if t is None else t[lo:hi].to(dev)

    def whole(t):
        return None if t is None else t.to(dev)

    d = index.delta
    qs = index.qstats
    return IVFIndex(
        centroids=part(index.centroids), csizes=part(index.csizes),
        vectors=part(index.vectors), ids=part(index.ids),
        attrs=part(index.attrs), valid=part(index.valid),
        counts=part(index.counts),
        delta=dataclasses.replace(
            d, vectors=whole(d.vectors), ids=whole(d.ids),
            attrs=whole(d.attrs), valid=whole(d.valid),
            codes=whole(d.codes)),
        base_mean_size=index.base_mean_size,
        codes=part(index.codes),
        qstats=None if qs is None else dataclasses.replace(
            qs, lo=whole(qs.lo), scale=whole(qs.scale)),
        code_norms=part(index.code_norms),
        drift=part(index.drift),
        config=index.config)


def _check_spec(spec: QuerySpec, merge: str) -> None:
    """Refuse what the sharded path cannot honour, rather than diverge
    silently from the same spec run through executor.run."""
    if spec.kind != "ann":
        raise ValueError("sharded execution serves ANN specs (exact = "
                         "n_probe >= k partitions)")
    if spec.predicate is not None:
        raise ValueError("sharded execution takes no predicate")
    if spec.u_max is not None or spec.cap is not None:
        raise ValueError("union_cap / prefilter are not supported in "
                         "sharded execution")
    if spec.use_quantized not in (None, False):
        raise ValueError("sharded execution scans the float32 tier (no "
                         "sharded code tier)")
    if spec.k > executor.MAX_SCAN_K:
        raise ValueError(f"QuerySpec k={spec.k}: the scan's k_scan="
                         f"{spec.k} exceeds MAX_SCAN_K="
                         f"{executor.MAX_SCAN_K}")
    if merge not in _MERGES:
        raise ValueError(f"merge must be one of {sorted(_MERGES)}: "
                         f"{merge!r}")


def distributed_query(
    index_shard: IVFIndex,
    queries,                         # [Q, d]: this rank's data slice
    spec: QuerySpec,
    mesh,
    *,
    data_axes: Tuple[str, ...] = ("data",),
    model_axis: str = "model",
    local_cap: Optional[int] = None,
    merge: str = "tournament",       # tournament | allgather
) -> ResultSet:
    """Alg. 2 over a model-sharded index, driven by a QuerySpec: every rank
    of a model group calls it with its shard (`shard_index`) and the same
    queries, and gets the group's global top-k as its ResultSet. Ids equal
    single-device search (ties included), and on the card so do the
    scores, bit for bit, unless two centroids tie at the n_probe boundary
    within the rounding of the centroid product (its shape differs per
    rank)."""
    _check_spec(spec, merge)
    for a in data_axes:
        _axis(mesh, a)
    m = mesh.size(_axis(mesh, model_axis))
    executor._check_backend(index_shard, spec.on_backend)
    group = mesh.get_group(model_axis)
    me = mesh.get_local_rank(model_axis)
    merge_fn = _MERGES[merge]
    cfg = index_shard.config
    metric = cfg.metric
    dev = index_shard.device
    k, n_probe = spec.k, spec.n_probe
    k_local, p_max = index_shard.k, index_shard.p_max
    cap = min(local_cap or n_probe, k_local)
    q = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32,
                                         device=dev))
    q = normalize_if_cosine(q, metric)

    # -- phase 1: local centroid scores and a local top-n --------------------
    cd = executor._centroid_scores(index_shard.centroids,
                                   index_shard.counts, metric, q)
    local_i = executor._stable_topk_idx(cd, min(n_probe, k_local))
    local_s = torch.gather(cd, -1, local_i)
    gids = (local_i + me * k_local).to(torch.int32)

    # -- phase 2: the global top-n probe ids (ties by partition id, as the
    # single-device probe orders them) ---------------------------------------
    _, gi, _ = merge_fn(local_s, gids, n_probe, group, keys=gids.long())

    # -- phase 3: scan this rank's probed partitions -------------------------
    # the single-device union order (votes desc, partition asc) over all
    # k = m * k_local partitions, known to every rank from the probe ids
    kg = k_local * m
    sel = torch.zeros((q.shape[0], kg + 1), dtype=torch.bool, device=dev)
    sel.scatter_(1, torch.where(gi >= 0, gi, kg).long(), True)
    sel = sel[:, :kg]
    upart = executor._stable_topk_idx(-sel.sum(dim=0), kg)
    pos = torch.empty_like(upart)
    pos[upart] = torch.arange(kg, device=dev)
    lo = me * k_local
    # this rank's probed partitions in union order, cut to the cap
    wanted = sel[:, lo:lo + k_local].any(dim=0)
    order, plist = torch.sort(torch.where(wanted, pos[lo:lo + k_local],
                                          torch.full_like(pos[:1], kg)))
    pvalid = order[:cap] < kg
    plist = torch.where(pvalid, plist[:cap], torch.zeros_like(plist[:cap]))
    qsel = sel[:, lo + plist] & pvalid[None, :]              # [Q, cap]
    k_scan = min(k, cap * p_max)
    # flat local rows (p * p_max + slot) out, so each candidate carries its
    # single-device tie key: union position * p_max + slot
    ls, row = executor.fused_scan(
        q, index_shard.vectors, index_shard.valid, None,
        plist.to(torch.int32), k_scan, metric=metric, qsel=qsel)
    got = row >= 0
    row = torch.where(got, row, torch.zeros_like(row)).long()
    li = torch.where(got, index_shard.ids.reshape(-1)[row],
                     torch.full_like(row, INVALID_ID)).to(torch.int32)
    lkey = torch.where(got, pos[lo + row // p_max] * p_max + row % p_max,
                       torch.full_like(row, -1))

    # the delta partition: replicated, scored once, on model rank 0; its
    # rows tie after every scanned row, as in the single-device merge
    ds, di = executor._delta_candidates_from(index_shard.delta, metric, q,
                                             None)
    if me != 0:
        ds = torch.full_like(ds, MASKED_SCORE)
    dkey = kg * p_max + torch.arange(ds.shape[-1], device=dev)
    ls, li, lkey = topk_lib.topk_smallest_by_key(
        torch.cat([ls, ds], dim=-1), torch.cat([li, di], dim=-1),
        torch.cat([lkey, dkey.expand_as(ds)], dim=-1),
        min(k, k_scan + ds.shape[-1]))

    # -- phase 4: the global result merge, then the single-device epilogue ---
    fs, fi, _ = merge_fn(ls, li, k, group, keys=lkey)
    fs, fi = topk_lib.dedup_by_id(fs, fi)
    if metric == "l2":
        q2 = pairwise_sum(q * q)[:, None]
        fs = torch.where(fi == INVALID_ID,
                         torch.full_like(fs, MASKED_SCORE), fs + q2)
    return ResultSet(ids=fi, scores=fs, spec=spec)


def distributed_search(index_shard: IVFIndex, queries, k: int, n_probe: int,
                       mesh, **kwargs) -> ResultSet:
    """Kwarg shim over distributed_query."""
    return distributed_query(index_shard, queries,
                             Q.knn(k=k, n_probe=n_probe), mesh, **kwargs)
