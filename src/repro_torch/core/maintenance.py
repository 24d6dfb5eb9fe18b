"""Index maintenance (paper §3.6; port of repro.core.maintenance): the
incremental delta flush, LIRE-style local repair (split / merge /
recluster / tombstone repack), and the full rebuild.

Incremental flush: each live delta vector goes to the partition with the
nearest centroid; centroids update by the running-mean rule
c' = (v*c + sum x) / (v + m).

Local repair: an oversized partition is 2-means-split, an underfull one is
merged into a sibling, a drifted neighbourhood is reclustered, and only
the rows of the touched partitions move. The planners (`plan_split`,
`plan_merge`, `plan_local_recluster`) are the reference's host numpy
code, copied, over a `RowBlock` fetch callback, so the resident and paged
engines -- and the JAX package -- make bit-identical plans from the same
rows. `apply_plan` rewrites the resident packed layout on the index's
device: only the touched partitions' slots are written (k and p_max grow
where needed, codes and code norms move with their rows), into fresh
tensors, so a query holding the previous index keeps its snapshot. The
flush and the repack write the same way. `full_rebuild` re-clusters
everything through ivf.build_index (its final assignment runs the
kmeans_assign kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ivf, quantize
from .types import (DeltaStore, INVALID_ID, IVFConfig, IVFIndex,
                    pairwise_scores)


@dataclasses.dataclass
class MaintenanceStats:
    kind: str                 # "incremental" | "full" | "split" | "merge"
    #                            | "recluster"
    rows_moved: int
    partitions_touched: int
    bytes_written: int        # host-tier write I/O (flash-wear metric)
    p_max_before: int
    p_max_after: int


def assign_nearest_centroid(dx: np.ndarray, centroids: torch.Tensor
                            ) -> np.ndarray:
    """Nearest-centroid assignment for a flush batch, l2 over the
    (metric-normalised) rows -- for cosine data rows and centroids are
    unit-norm, so l2 order == cosine order."""
    x = torch.as_tensor(np.asarray(dx, np.float32), device=centroids.device)
    return torch.argmin(pairwise_scores(x, centroids, "l2"),
                        dim=-1).cpu().numpy()


def running_mean_update(cent: np.ndarray, csizes: np.ndarray,
                        dx: np.ndarray, assign: np.ndarray,
                        touched: np.ndarray,
                        drift: Optional[np.ndarray] = None):
    """c' = (v*c + sum x)/(v+m) per touched partition, in place, as one
    np.add.at scatter (rows accumulate in row order, like a loop). When
    `drift` is given, each touched centroid's displacement accumulates."""
    sums = np.zeros_like(cent)
    np.add.at(sums, assign, dx)
    m = np.bincount(assign, minlength=cent.shape[0]).astype(csizes.dtype)
    t = np.asarray(touched)
    old = cent[t].copy() if drift is not None else None
    v = csizes[t]
    cent[t] = (v[:, None] * cent[t] + sums[t]) \
        / np.maximum(v + m[t], 1.0)[:, None]
    csizes[t] = v + m[t]
    if drift is not None:
        drift[t] += np.linalg.norm(cent[t] - old, axis=-1)


def _row_bytes(index: IVFIndex) -> int:
    codes = index.dim if index.codes is not None else 0
    return 4 * index.dim + 4 + 4 * index.n_attr + 1 + codes


def _padded(n: int, pad: int) -> int:
    return -(-int(n) // pad) * pad


def compact_delta(d: DeltaStore, keep: np.ndarray, n_attr: int,
                  quantized: bool, qstats=None) -> DeltaStore:
    """The delta rows listed in `keep`, compacted into a fresh DeltaStore
    (the tail of a partial flush)."""
    cap, dim = d.capacity, d.vectors.shape[1]
    dev = d.vectors.device
    out = DeltaStore.empty(cap, dim, n_attr, quantized=quantized, device=dev)
    if keep.size == 0:
        return out
    r = keep.size
    kt = torch.as_tensor(keep, device=dev)
    out.vectors[:r] = d.vectors[kt]
    out.ids[:r] = d.ids[kt]
    out.attrs[:r] = d.attrs[kt]
    out.valid[:r] = True
    out.count = r
    if quantized:
        out.codes[:r] = d.codes[kt] if d.codes is not None \
            else quantize.encode(qstats, out.vectors[:r])
    return out


# ---------------------------------------------------------------------------
# Writing partitions of the resident layout on the device
# ---------------------------------------------------------------------------


def _grown(t: torch.Tensor, k: int, p_max: int, fill) -> torch.Tensor:
    """A fresh copy of the [k0, p0, ...] tensor `t` grown to [k, p_max, ...]
    (new slots hold `fill`)."""
    k0, p0 = t.shape[:2]
    if (k0, p0) == (k, p_max):
        return t.clone()
    out = torch.full((k, p_max) + tuple(t.shape[2:]), fill, dtype=t.dtype,
                     device=t.device)
    out[:k0, :p0] = t
    return out


def _partition_rows(index: IVFIndex, pids: Sequence[int]):
    """Host copies of partitions `pids`: (vectors, ids, attrs, valid, codes
    or None), each [len(pids), p_max, ...] -- one gather on the device."""
    pt = torch.as_tensor(np.asarray(pids, np.int64), device=index.device)
    return (index.vectors[pt].cpu().numpy(), index.ids[pt].cpu().numpy(),
            index.attrs[pt].cpu().numpy(), index.valid[pt].cpu().numpy(),
            None if index.codes is None else index.codes[pt].cpu().numpy())


def _write_partitions(index: IVFIndex, pids: Sequence[int], rows,
                      k: int, p_max: int) -> dict:
    """The packed tensors of `index` grown to [k, p_max] with partitions
    `pids` replaced by `rows` (per pid: host vecs [m, d], ids [m], attrs
    [m, n_attr], codes [m, d] or None), packed from slot 0. Untouched
    partitions are copied on the device; the rewritten ones' code norms
    are recomputed (a row's norm has the same bits in any batch), and
    grown slots carry the norm of a zero code, as a full recompute would
    give. -> the dataclasses.replace fields."""
    dev = index.device
    L, d, n_attr = len(pids), index.dim, index.n_attr
    quantized = index.codes is not None
    bv = np.zeros((L, p_max, d), np.float32)
    bi = np.full((L, p_max), INVALID_ID, np.int32)
    ba = np.zeros((L, p_max, n_attr), np.float32)
    bok = np.zeros((L, p_max), bool)
    bc = np.zeros((L, p_max, d), np.int8) if quantized else None
    for j, (v, i, a, c) in enumerate(rows):
        m = len(i)
        bv[j, :m] = v
        bi[j, :m] = i
        ba[j, :m] = a
        bok[j, :m] = True
        if quantized:
            bc[j, :m] = c
    pt = torch.as_tensor(np.asarray(pids, np.int64), device=dev)
    out = {}
    for name, block, fill in (("vectors", bv, 0.0), ("ids", bi, INVALID_ID),
                              ("attrs", ba, 0.0), ("valid", bok, False),
                              ("codes", bc, 0)):
        if block is None:
            continue
        t = _grown(getattr(index, name), k, p_max, fill)
        t[pt] = torch.from_numpy(block).to(dev)
        out[name] = t
    if quantized:
        zero = quantize.row_norms(index.qstats, torch.zeros(
            (1, d), dtype=torch.int8, device=dev))[0]
        norms = _grown(index.code_norms, k, p_max, 0.0)
        k0, p0 = index.code_norms.shape
        norms[k0:] = zero
        norms[:, p0:] = zero
        norms[pt] = quantize.row_norms(index.qstats, out["codes"][pt])
        out["code_norms"] = norms
    return out


def _grown_vec(t: torch.Tensor, k: int) -> torch.Tensor:
    """A fresh copy of the [k0, ...] tensor `t` zero-padded to k rows."""
    if t.shape[0] == k:
        return t.clone()
    out = torch.zeros((k,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[:t.shape[0]] = t
    return out


def flush_delta(index: IVFIndex, max_rows: Optional[int] = None,
                assign: Optional[np.ndarray] = None
                ) -> Tuple[IVFIndex, MaintenanceStats]:
    """Fold live delta rows into the IVF partitions. `max_rows` bounds the
    work (the first `max_rows` live rows in slot order; the rest stay in
    the delta, compacted); `assign` skips the assignment when the caller
    already computed it. Each touched partition keeps its live rows in
    slot order and appends its new rows; only those partitions are
    written."""
    cfg = index.config
    k, p_max, d = index.vectors.shape
    dev = index.device
    quantized = index.codes is not None
    live = np.nonzero(index.delta.valid.cpu().numpy())[0]
    deferred = np.zeros((0,), np.int64)
    if max_rows is not None and live.size > max_rows:
        live, deferred = live[:max_rows], live[max_rows:]
    if live.size == 0:
        new = dataclasses.replace(
            index, delta=compact_delta(index.delta, deferred, index.n_attr,
                                       quantized, index.qstats))
        return new, MaintenanceStats("incremental", 0, 0, 0, p_max, p_max)

    dx = index.delta.vectors.cpu().numpy()[live]
    dids = index.delta.ids.cpu().numpy()[live]
    dattrs = index.delta.attrs.cpu().numpy()[live]
    if quantized:
        dcod = (index.delta.codes.cpu().numpy()[live]
                if index.delta.codes is not None
                else quantize.encode_np(index.qstats, dx))
    if assign is None:
        assign = assign_nearest_centroid(dx, index.centroids)
    if len(assign) != live.size:
        raise ValueError("flush assignment does not match the live rows")

    touched = np.unique(assign)
    vec, vid, vat, val, cod = _partition_rows(index, touched)
    # grow p_max if a partition would overflow (tombstoned slots are
    # reused first)
    add = np.bincount(assign, minlength=k)[touched]
    new_p_max = max(p_max, _padded((val.sum(-1) + add).max(), cfg.pad_to))
    rows = []
    for j, p in enumerate(touched):
        keep = np.nonzero(val[j])[0]
        sel = assign == p
        rows.append((np.concatenate([vec[j][keep], dx[sel]]),
                     np.concatenate([vid[j][keep], dids[sel]]),
                     np.concatenate([vat[j][keep], dattrs[sel]]),
                     np.concatenate([cod[j][keep], dcod[sel]])
                     if quantized else None))
    fields = _write_partitions(index, touched, rows, k, new_p_max)
    counts = index.counts.cpu().numpy().copy()
    counts[touched] = [len(r[1]) for r in rows]
    csizes = index.csizes.cpu().numpy().copy()
    cent = index.centroids.cpu().numpy().copy()
    drift = index.drift.cpu().numpy().astype(np.float32).copy() \
        if index.drift is not None else np.zeros((k,), np.float32)
    running_mean_update(cent, csizes, dx, assign, touched, drift=drift)

    stats = MaintenanceStats(
        kind="incremental", rows_moved=int(live.size),
        partitions_touched=int(len(touched)),
        # a clustered B-tree append touches only the inserted rows' pages:
        # moved rows + the touched partitions' centroid rewrites
        bytes_written=int(live.size * _row_bytes(index)
                          + len(touched) * d * 4),
        p_max_before=p_max, p_max_after=new_p_max)
    new_index = dataclasses.replace(
        index, **fields,
        centroids=torch.from_numpy(cent).to(dev),
        csizes=torch.from_numpy(csizes).to(dev),
        counts=torch.from_numpy(counts).to(dev),
        delta=compact_delta(index.delta, deferred, index.n_attr, quantized,
                            index.qstats),
        drift=torch.from_numpy(drift).to(dev))
    return new_index, stats


# ---------------------------------------------------------------------------
# LIRE-style local repair: split / merge / recluster over a partition
# neighbourhood. Planning is host numpy shared by both engines (and equal
# to the reference's); application is mode-specific.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowBlock:
    """Live rows of one partition, sorted ascending by asset id (the order
    the packed resident layout after repack and SQLite's clustered scan
    agree on). `attrs`/`codes` ride along only where the fetcher has them
    resident (the paged apply re-reads them from SQLite instead)."""

    ids: np.ndarray                       # [m] int32
    vecs: np.ndarray                      # [m, d] f32, metric-normalised
    attrs: Optional[np.ndarray] = None    # [m, n_attr] f32
    codes: Optional[np.ndarray] = None    # [m, d] int8


# fetch callback: pids -> {pid: RowBlock} (one batched read per repair)
RowFetch = Callable[[Sequence[int]], Dict[int, "RowBlock"]]


@dataclasses.dataclass
class RepairPlan:
    """One planned local repair: the touched partitions, where every
    affected row lands, and the neighbourhood's new centroid state."""

    kind: str                 # "split" | "merge" | "recluster"
    pids: np.ndarray          # [L] int64 -- touched partitions (split: the
    #                           new slot is last)
    new_pid: Optional[int]    # slot a split allocated (reused empty slot,
    #                           or == k_before when appending)
    k_after: int              # partition count after the repair
    row_ids: np.ndarray       # [m] int32 -- every live row in the
    #                           neighbourhood (block order per pids)
    row_vecs: np.ndarray      # [m, d] f32 metric-normalised
    row_attrs: Optional[np.ndarray]   # [m, n_attr] (resident fetch only)
    row_codes: Optional[np.ndarray]   # [m, d] int8 (resident fetch only)
    src: np.ndarray           # [m] int64 -- current partition per row
    assign: np.ndarray        # [m] int64 -- new partition per row
    centroids: np.ndarray     # [L, d] f32 -- new centroids for `pids`
    csizes: np.ndarray        # [L] f32 -- restarted running counts

    @property
    def rows(self) -> int:
        return int(self.row_ids.size)

    @property
    def moved(self) -> np.ndarray:
        return self.assign != self.src


def two_means(rows: np.ndarray, iters: int = 8
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic 2-means over [m, d] float32 rows: farthest-point init
    from the partition mean, fixed Lloyd iterations, ties to side 0."""
    mu = rows.mean(0)
    c1 = rows[int(((rows - mu) ** 2).sum(-1).argmax())]
    c2 = rows[int(((rows - c1) ** 2).sum(-1).argmax())]
    assign = np.zeros((rows.shape[0],), np.int64)
    for _ in range(iters):
        d1 = ((rows - c1) ** 2).sum(-1)
        d2 = ((rows - c2) ** 2).sum(-1)
        new = (d2 < d1).astype(np.int64)
        if (new == 0).all() or (new == 1).all():
            assign = new
            break
        c1n, c2n = rows[new == 0].mean(0), rows[new == 1].mean(0)
        done = np.array_equal(new, assign)
        assign = new
        if done:
            break
        c1, c2 = c1n, c2n
    return np.stack([c1, c2]), assign


def neighborhood(centroids: np.ndarray, counts: np.ndarray,
                 seeds: Sequence[int], row_budget: Optional[int],
                 n_extra: int) -> List[int]:
    """The seed partitions plus up to `n_extra` nearest non-empty
    partitions whose rows still fit the row budget; ordered by centroid
    distance to the first seed, ties by partition id."""
    base = [int(p) for p in seeds]
    used = int(counts[base].sum())
    if n_extra <= 0:
        return base
    ref = centroids[base[0]]
    dist = ((centroids - ref) ** 2).sum(-1)
    order = np.lexsort((np.arange(len(centroids)), dist))
    out = list(base)
    for q in order:
        if len(out) - len(base) >= n_extra:
            break
        q = int(q)
        if q in base or counts[q] <= 0:
            continue
        if row_budget is not None and used + int(counts[q]) > row_budget:
            continue
        out.append(q)
        used += int(counts[q])
    return out


def _gather_blocks(blocks: Dict[int, RowBlock], pids: Sequence[int]):
    """Concatenate the neighbourhood's RowBlocks in pid-list order."""
    have = [p for p in pids if p in blocks]
    if not have:
        return (np.zeros((0,), np.int32), np.zeros((0, 0), np.float32),
                None, None, np.zeros((0,), np.int64))
    vecs = np.concatenate([blocks[p].vecs for p in have])
    src = np.concatenate([np.full((len(blocks[p].ids),), p, np.int64)
                          for p in have])
    attrs = np.concatenate([blocks[p].attrs for p in have]) \
        if all(blocks[p].attrs is not None for p in have) else None
    codes = np.concatenate([blocks[p].codes for p in have]) \
        if all(blocks[p].codes is not None for p in have) else None
    return (np.concatenate([blocks[p].ids for p in have]), vecs, attrs,
            codes, src)


def _finalize_plan(kind, local, new_pid, k_after, row_ids, row_vecs,
                   row_attrs, row_codes, src, local_cents) -> RepairPlan:
    """Shared tail of every planner: reassign the neighbourhood's rows to
    their nearest local centroid, then restate each touched partition's
    centroid as the mean of its new members (running-mean restart).
    Partitions left empty keep their (masked-by-count) old centroid."""
    d2 = ((row_vecs[:, None, :] - local_cents[None, :, :]) ** 2).sum(-1)
    pick = d2.argmin(axis=1)                      # ties -> lowest index
    assign = np.asarray(local, np.int64)[pick]
    cents = local_cents.copy().astype(np.float32)
    csz = np.zeros((len(local),), np.float32)
    for j in range(len(local)):
        sel = pick == j
        m = int(sel.sum())
        csz[j] = m
        if m:
            cents[j] = row_vecs[sel].mean(0)
    return RepairPlan(
        kind=kind, pids=np.asarray(local, np.int64), new_pid=new_pid,
        k_after=k_after, row_ids=row_ids, row_vecs=row_vecs,
        row_attrs=row_attrs, row_codes=row_codes, src=src, assign=assign,
        centroids=cents, csizes=csz)


def plan_split(centroids: np.ndarray, csizes: np.ndarray,
               counts: np.ndarray, pid: int, fetch: RowFetch, *,
               row_budget: Optional[int] = None, n_local: int = 2
               ) -> Optional[RepairPlan]:
    """2-means split of an oversized partition + local reassignment of the
    touched neighbourhood. The freed half lands in a reused empty slot
    when one exists, else in a new slot k. None when the partition is
    degenerate (all rows identical) or nothing would move."""
    k = centroids.shape[0]
    pid = int(pid)
    nbrs = neighborhood(centroids, counts, [pid], row_budget, n_local)
    blocks = fetch(nbrs)
    seed = blocks.get(pid)
    if seed is None or len(seed.ids) < 2:
        return None
    (c1, c2), halves = two_means(seed.vecs)
    if (halves == 0).all() or (halves == 1).all():
        return None
    if (halves == 1).sum() > (halves == 0).sum():
        # the larger half stays in place (fewer durable row moves)
        c1, c2 = c2, c1
    empty = [int(p) for p in np.nonzero(counts == 0)[0] if p not in nbrs]
    new_pid = empty[0] if empty else k
    k_after = max(k, new_pid + 1)
    local = nbrs + [new_pid]
    row_ids, row_vecs, row_attrs, row_codes, src = _gather_blocks(
        blocks, nbrs)
    local_cents = np.concatenate(
        [np.stack([c1]), centroids[nbrs[1:]], np.stack([c2])]) \
        .astype(np.float32)
    plan = _finalize_plan("split", local, new_pid, k_after, row_ids,
                          row_vecs, row_attrs, row_codes, src, local_cents)
    if not plan.moved.any():
        return None
    return plan


def choose_merge_partner(centroids: np.ndarray, counts: np.ndarray,
                         victim: int, split_bar: float,
                         exclude: Sequence[int] = ()) -> Optional[int]:
    """Best-fit bin packing: among the non-empty partitions whose merged
    size still fits under the split bar, the one with the least post-merge
    slack; ties by centroid distance to the victim, then partition id.
    None when nothing fits.

    The reference's choice, computed in O(k) plus O(d) per least-slack
    candidate: the distance decides only among those, so only theirs are
    formed (each row's sum has the bits of the reference's [k, d] one),
    and the exclusions are one vectorised mask. The monitor calls this
    once per underfull partition, which at k = 10,000 made the reference's
    O(k d) form the bulk of a work_queue call."""
    victim = int(victim)
    counts = np.asarray(counts)
    k = centroids.shape[0]
    merged = counts + counts[victim]
    ok = (counts > 0) & (merged <= split_bar)
    ok[victim] = False
    ex = np.asarray(exclude if isinstance(exclude, np.ndarray)
                    else list(exclude), np.int64).reshape(-1)
    ok[ex[(ex >= 0) & (ex < k)]] = False
    if not ok.any():
        return None
    slack = np.where(ok, split_bar - merged, np.inf)
    cand = np.nonzero(slack == slack.min())[0]
    if cand.size == 1:
        return int(cand[0])
    dist = ((centroids[cand] - centroids[victim]) ** 2).sum(-1)
    # lexsort: last key is primary -> (distance, pid)
    return int(cand[np.lexsort((cand, dist))[0]])


def plan_merge(centroids: np.ndarray, csizes: np.ndarray,
               counts: np.ndarray, into: int, victim: int, fetch: RowFetch
               ) -> Optional[RepairPlan]:
    """Merge an underfull partition into a sibling: every row of `victim`
    moves to `into`, whose centroid restarts at the merged rows' mean. The
    victim keeps its (masked-by-count) slot for a later split."""
    into, victim = int(into), int(victim)
    local = [into, victim]
    blocks = fetch(local)
    row_ids, row_vecs, row_attrs, row_codes, src = _gather_blocks(
        blocks, local)
    if row_ids.size == 0:
        return None
    assign = np.full((row_ids.size,), into, np.int64)
    cents = np.stack([row_vecs.mean(0),
                      centroids[victim]]).astype(np.float32)
    csz = np.asarray([row_ids.size, 0.0], np.float32)
    return RepairPlan(
        kind="merge", pids=np.asarray(local, np.int64), new_pid=None,
        k_after=centroids.shape[0], row_ids=row_ids, row_vecs=row_vecs,
        row_attrs=row_attrs, row_codes=row_codes, src=src, assign=assign,
        centroids=cents, csizes=csz)


def plan_local_recluster(centroids: np.ndarray, csizes: np.ndarray,
                         counts: np.ndarray, pid: int, fetch: RowFetch, *,
                         row_budget: Optional[int] = None, n_local: int = 2
                         ) -> Optional[RepairPlan]:
    """Local repair of a drifted (or tombstone-heavy) partition: reassign
    the rows of its centroid neighbourhood to their nearest local centroid
    and restart those centroids at their members' means (a no-move plan
    still resets the drift signal)."""
    nbrs = neighborhood(centroids, counts, [int(pid)], row_budget, n_local)
    blocks = fetch(nbrs)
    row_ids, row_vecs, row_attrs, row_codes, src = _gather_blocks(
        blocks, nbrs)
    if row_ids.size == 0:
        return None
    return _finalize_plan("recluster", nbrs, None, centroids.shape[0],
                          row_ids, row_vecs, row_attrs, row_codes, src,
                          centroids[nbrs].astype(np.float32))


def apply_plan(index: IVFIndex, plan: RepairPlan) -> IVFIndex:
    """Rewrite the resident packed layout per a RepairPlan: only the
    touched partitions' slots change (rows packed ascending by asset id,
    as recover() would pack the repaired durable state), k / p_max grow
    as needed, codes move with their rows, and the touched partitions'
    drift resets."""
    k, p_max, _ = index.vectors.shape
    quantized = index.codes is not None
    if plan.row_attrs is None or (quantized and plan.row_codes is None):
        raise ValueError("the resident apply needs the rows' attrs (and "
                         "codes): fetch them from the resident layout")
    k_new = max(k, plan.k_after)
    rows = []
    for p in plan.pids:
        sel = plan.assign == p
        order = np.argsort(plan.row_ids[sel], kind="stable")
        rows.append((plan.row_vecs[sel][order], plan.row_ids[sel][order],
                     plan.row_attrs[sel][order],
                     plan.row_codes[sel][order] if quantized else None))
    sizes = np.asarray([len(r[1]) for r in rows])
    new_p_max = max(p_max, _padded(max(sizes.max(), 1),
                                   index.config.pad_to))
    fields = _write_partitions(index, plan.pids, rows, k_new, new_p_max)
    dev = index.device
    pt = torch.as_tensor(plan.pids, device=dev)
    counts = _grown_vec(index.counts, k_new)
    counts[pt] = torch.as_tensor(sizes, dtype=counts.dtype, device=dev)
    cent = _grown_vec(index.centroids, k_new)
    cent[pt] = torch.as_tensor(plan.centroids, device=dev)
    csz = _grown_vec(index.csizes, k_new)
    csz[pt] = torch.as_tensor(plan.csizes, device=dev)
    drift = _grown_vec(index.drift if index.drift is not None else
                       torch.zeros((k,), dtype=torch.float32, device=dev),
                       k_new)
    drift[pt] = 0.0
    return dataclasses.replace(index, **fields, counts=counts,
                               centroids=cent, csizes=csz, drift=drift)


def repack_partition(index: IVFIndex, pid: int) -> IVFIndex:
    """Device-only tombstone repack of one partition: live rows re-pack
    ascending by asset id (the order paged frames and recover() use) and
    dead slots clear. No centroid, drift or durable change."""
    pid = int(pid)
    vec, vid, vat, val, cod = _partition_rows(index, [pid])
    sel = np.nonzero(val[0])[0]
    rows = sel[np.argsort(vid[0][sel], kind="stable")]
    row = (vec[0][rows], vid[0][rows], vat[0][rows],
           None if cod is None else cod[0][rows])
    fields = _write_partitions(index, [pid], [row], index.k, index.p_max)
    return dataclasses.replace(index, **fields)


def live_rows(index: IVFIndex):
    """All live rows (main + delta) as host arrays (vectors, ids, attrs)."""
    val = index.valid.cpu().numpy()
    vec = index.vectors.cpu().numpy()[val]
    vid = index.ids.cpu().numpy()[val]
    vat = index.attrs.cpu().numpy()[val]
    dval = index.delta.valid.cpu().numpy()
    if dval.any():
        vec = np.concatenate([vec, index.delta.vectors.cpu().numpy()[dval]])
        vid = np.concatenate([vid, index.delta.ids.cpu().numpy()[dval]])
        vat = np.concatenate([vat, index.delta.attrs.cpu().numpy()[dval]])
    return vec, vid, vat


def full_rebuild(index: IVFIndex, cfg: Optional[IVFConfig] = None
                 ) -> Tuple[IVFIndex, MaintenanceStats]:
    """Re-cluster everything from scratch (the paper's fallback when
    average partition growth crosses the threshold), on the index's
    device."""
    cfg = cfg or index.config
    vec, vid, vat = live_rows(index)
    new = ivf.build_index(vec, vid, vat, cfg=cfg, device=index.device)
    stats = MaintenanceStats(
        kind="full", rows_moved=int(len(vec)),
        partitions_touched=int(new.k),
        bytes_written=int(len(vec) * _row_bytes(index) + new.k * new.dim * 4),
        p_max_before=index.p_max, p_max_after=new.p_max)
    return new, stats
