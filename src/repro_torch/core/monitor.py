"""Index monitor (paper Fig. 1, §3.6; port of repro.core.monitor): tracks
quality signals on updates and decides what maintenance the index needs.

  * `check(index)` -- the single verdict ("none" | "flush" | "rebuild")
    that maintain() with no `force` acts on;
  * `work_queue(index)` -- per-partition size / drift / tombstone signals
    as a prioritised list of `WorkItem`s, drained in bounded quanta by
    storage/scheduler.MaintenanceScheduler: oversized partitions split,
    underfull ones merge, drifted neighbourhoods recluster locally,
    tombstone-heavy partitions repack.

Signals: delta pressure (live delta rows / capacity), per-partition size
against the clustering target, per-partition drift (the centroid's
cumulative displacement since its last repair, against the mean
nearest-centroid spacing) and the tombstone ratio.

Difference from the JAX package, deliberate: the nearest-centroid spacing
is computed in row blocks on the index's device (`centroid_spacing`), with
the reference's difference-square formula, never as the reference's
[k, k, d] temporary (about 51 GB at k = 10,000, d = 128) nor a [k, k]
matrix; it agrees with the reference's within float32 summation order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from . import maintenance
from .types import IVFIndex


@dataclasses.dataclass
class MonitorConfig:
    delta_flush_fraction: float = 0.75   # flush when delta is this full
    growth_rebuild_threshold: float = 0.5  # paper: 50% mean-size growth
    tombstone_rebuild_fraction: float = 0.3
    # split a partition past split_threshold * target_partition_size rows
    # (the B-tree doubling point: a split yields two target-sized halves)
    split_threshold: float = 2.0
    # merge a partition below merge_threshold * target_partition_size rows
    # (into a sibling, if the pair stays under the split bar)
    merge_threshold: float = 0.4
    # recluster a partition whose accumulated centroid drift exceeds this
    # fraction of the mean nearest-centroid spacing
    drift_recluster_threshold: float = 0.5
    # nearest neighbours a drift recluster pulls into its neighbourhood
    repair_neighbors: int = 2
    # neighbours a split reassigns besides the split partition itself
    split_neighbors: int = 0


@dataclasses.dataclass
class IndexHealth:
    n_live: int
    delta_pressure: float
    mean_partition_size: float
    growth: float            # relative growth vs base_mean_size
    tombstone_fraction: float
    action: str              # "none" | "flush" | "rebuild"


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One unit of incremental maintenance. `pids` is () for a flush, a
    1-tuple for split/recluster/repack, (into, victim) for a merge. `rows`
    estimates the rows the item touches (the scheduler budgets on it)."""

    action: str        # "flush" | "split" | "merge" | "recluster" | "repack"
    pids: Tuple[int, ...]
    rows: int
    priority: float


# elements of one block's [rows, k, d] difference tensor (256 MB of f32)
SPACING_BLOCK_ELEMS = 1 << 26


def centroid_spacing(centroids: torch.Tensor, live: np.ndarray) -> float:
    """Mean over live partitions of the distance to the nearest other live
    centroid, on the centroids' device, in blocks of rows: each block forms
    ((c_i - c_j) ** 2).sum(-1) for its rows against every centroid, so no
    [k, k, d] or [k, k] tensor exists at once."""
    k, d = centroids.shape
    dev = centroids.device
    live_t = torch.as_tensor(live, device=dev)
    dead_cols = ~live_t[None, :]
    rows = max(1, SPACING_BLOCK_ELEMS // max(1, k * d))
    mins = []
    for s in range(0, k, rows):
        blk = centroids[s:s + rows]
        d2 = ((blk[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        d2 = d2.masked_fill(dead_cols, float("inf"))
        r = torch.arange(blk.shape[0], device=dev)
        d2[r, r + s] = float("inf")                      # the diagonal
        mins.append(d2.min(dim=1).values)
    nearest = torch.cat(mins)[live_t]
    return float(torch.sqrt(nearest).mean())


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class IndexMonitor:
    def __init__(self, cfg: MonitorConfig | None = None):
        self.cfg = cfg or MonitorConfig()
        self.history: list[IndexHealth] = []

    def check(self, index: IVFIndex) -> IndexHealth:
        cfg = self.cfg
        counts = _host(index.counts)
        live_main = int(index.valid.sum())
        delta_live = int(index.delta.valid.sum())
        delta_cursor = int(index.delta.count)
        nonempty = max(1, int((counts > 0).sum()))
        mean_size = live_main / nonempty
        base = float(index.base_mean_size) or 1.0
        growth = mean_size / base - 1.0
        # tombstones: occupied slots (cursor-written or once-valid) now dead
        dead_main = int((index.ids != -1).sum()) - live_main
        tomb = dead_main / max(1, live_main + dead_main)

        if growth >= cfg.growth_rebuild_threshold or \
           tomb >= cfg.tombstone_rebuild_fraction:
            action = "rebuild"
        elif delta_cursor >= cfg.delta_flush_fraction * index.delta.capacity:
            action = "flush"
        else:
            action = "none"

        health = IndexHealth(
            n_live=live_main + delta_live,
            delta_pressure=delta_cursor / max(1, index.delta.capacity),
            mean_partition_size=mean_size, growth=growth,
            tombstone_fraction=tomb, action=action)
        self.history.append(health)
        return health

    def work_queue(self, index) -> List[WorkItem]:
        """Per-partition signals -> a prioritised list of maintenance work,
        for a resident IVFIndex or a PagedIndex. Flushes (the delta gates
        the write path) outrank splits (recall and p_max pressure), then
        merges (scan waste), tombstone repacks (resident only: the paged
        tier deletes rows at once) and drift reclustering."""
        cfg = self.cfg
        target = max(1, int(index.config.target_partition_size))
        counts = _host(index.counts)
        k = counts.shape[0]
        items: List[WorkItem] = []

        delta_cursor = int(index.delta.count)
        delta_live = int(index.delta.valid.sum())
        if delta_cursor >= cfg.delta_flush_fraction * index.delta.capacity:
            pressure = delta_cursor / max(1, index.delta.capacity)
            items.append(WorkItem("flush", (), delta_live,
                                  100.0 + pressure))
        elif delta_live:
            # below the pressure bar the flush is still pending work --
            # "idle" means an empty delta -- just the lowest priority
            items.append(WorkItem("flush", (), delta_live, 0.5))

        split_bar = cfg.split_threshold * target
        for p in np.nonzero(counts > split_bar)[0]:
            items.append(WorkItem("split", (int(p),), int(counts[p]),
                                  10.0 + counts[p] / split_bar))

        merge_bar = cfg.merge_threshold * target
        cents = None
        if k > 1:
            small = np.nonzero((counts > 0) & (counts < merge_bar))[0]
            taken = np.zeros((k,), bool)       # partitions already paired
            for q in small:
                q = int(q)
                if taken[q]:
                    continue
                if cents is None:
                    cents = _host(index.centroids)
                # best-fit partner under the split bar, ties by centroid
                # distance then pid (maintenance.choose_merge_partner)
                into = maintenance.choose_merge_partner(
                    cents, counts, q, split_bar,
                    exclude=np.nonzero(taken)[0])
                if into is None:
                    continue
                taken[[q, into]] = True
                items.append(WorkItem(
                    "merge", (into, q), int(counts[into] + counts[q]),
                    5.0 + (1.0 - counts[q] / merge_bar)))

        # drift: a running mean that wandered a good fraction of the
        # centroid spacing no longer represents its rows -> local repair
        drift = getattr(index, "drift", None)
        if drift is not None and k > 1:
            drift = _host(drift)
            live = counts > 0
            if live.sum() > 1:
                spacing = centroid_spacing(index.centroids, live)
                bar = cfg.drift_recluster_threshold * max(spacing, 1e-12)
                for p in np.nonzero(live & (drift[:k] >= bar))[0]:
                    items.append(WorkItem(
                        "recluster", (int(p),), int(counts[p]),
                        1.0 + float(drift[p]) / bar))

        # per-partition tombstone repack: only the resident packed layout
        # carries tombstones, so this is a device-only repack with no
        # durable effect (the two modes' durable states stay identical)
        ids = getattr(index, "ids", None)
        if ids is not None:
            valid = index.valid
            dead = _host(((ids != -1) & ~valid).sum(-1))
            occ = dead + _host(valid.sum(-1))
            frac = dead / np.maximum(occ, 1)
            hit = (frac >= cfg.tombstone_rebuild_fraction) & (dead > 0)
            for p in np.nonzero(hit)[0]:
                items.append(WorkItem(
                    "repack", (int(p),), int(counts[p]),
                    3.0 + float(frac[p])))

        items.sort(key=lambda it: (-it.priority, it.action, it.pids))
        return items
