"""MicroNN: the embeddable engine facade (port of repro.storage.engine).

    eng = MicroNN(dim=128, n_attr=2, path="db.sqlite")   # device "cuda"
    with eng.session() as s:         # batched writes: ONE transaction
        s.upsert(ids, vecs, attrs)
        s.delete(stale_ids)
    eng.build()                      # initial clustering
    rs = eng.query(q, Q.knn(k=100).probe(8))
    rs = eng.query(q, Q.knn(k=10).where(Pred(0, "==", 3.0)))  # optimizer
    eng.maintain(until_idle=True)    # drain incremental maintenance
    eng.maintain_step()              # ... or one bounded quantum at a time
    eng.scheduler.start_daemon()     # ... or on a background thread

    paged = MicroNN(dim=128, path="db.sqlite", quantize="int8",
                    memory_budget_mb=10)   # disk-resident mode
    paged.recover()                  # metadata only; partitions fault in

Writes are serialised (single writer, paper §3.6); every write lands in
SQLite (durable, WAL) and in the device index (delta-store), so readers see
updates at once while the host copy guarantees recoverability --
`recover()` rebuilds device state from SQLite after a crash. The database
schema is the JAX package's, so either engine recovers the other's file.

Resident mode keeps the whole index on the engine's device; a predicate
query with `hybrid="auto"` is resolved by the hybrid optimizer (paper
Eqs. 1-3) into the pre-filter or the post-filter plan. Paged mode
(`memory_budget_mb`) is the paper's disk-resident mode: only metadata and
the delta are on the device, and the scan tier is paged from SQLite
through a budget-bounded frame pool (storage/pager.py), private or shared
(`frame_pool` + `tenant`). Both run on the engine's device: "cuda" unless
the caller asks for the CPU (`device="cpu"`, where the kernels' plain
versions run).

Maintenance (paper §3.6): the monitor (core/monitor.py) turns per-partition
signals into a prioritised work queue that the scheduler
(storage/scheduler.py) drains in bounded quanta -- partial delta flushes,
2-means splits, merges, local reclusters, tombstone repacks -- each made
durable as codes first, then one SQLite repair transaction; both modes
leave identical durable states after the same steps. `maintain()` with no
argument acts on the monitor's single verdict, `force="rebuild"`
re-clusters everything (through the kmeans_assign kernel).

Observability (obs/*): the engine owns a labeled scope of the process
metrics registry (`self.metrics`; the pager, scheduler and front door
register under it) and a TraceRing (`self.traces`: the last traced
queries, the maintenance event log and the slow-query log).
`query(..., trace=True)` and `explain()` record a per-stage QueryTrace;
the write path keeps `stage_s{action="write"}` histograms of each session
commit and each inline delta flush; `stats()` is a derived view of the
registry. The flight recorder (obs/recorder.py) captures `query()` calls
while one is installed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import delta as delta_ops
from ..core import executor, ivf, kmeans, maintenance, quantize
from ..core.hybrid import AttributeStats, Node
from ..core.monitor import IndexMonitor, MonitorConfig, WorkItem
from ..core.optimizer import HybridOptimizer
from ..core.query import Q, QuerySpec, ResultSet
from ..core.types import (INVALID_ID, DeltaStore, IVFConfig, PagedIndex,
                          normalize_if_cosine, normalize_rows,
                          resolve_device)
from ..kernels import build, ops
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs import trace as obs_trace
from . import pager
from .scheduler import MaintenanceScheduler, StepReport
from .store import VectorStore


def _n_rows(queries) -> int:
    """Query rows of a [q, d] batch or a single [d] vector."""
    return int(queries.shape[0]) if len(queries.shape) == 2 else 1


def _locked(fn):
    """Run the method under the engine's write mutex (`self.lock`): a
    session commit, a direct upsert/delete and a maintenance quantum
    (hand-cranked or the daemon's) never interleave partial transactions.
    Re-entrant, since write paths nest (upsert -> maintain(force="flush"))."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self.lock:
            return fn(self, *args, **kwargs)
    return wrapper


class WriteSession:
    """Batched write scope: `with db.session() as s: s.upsert(...);
    s.delete(...)`. Ops are buffered and coalesced (last write per asset
    id wins) until the block exits cleanly, then committed as one SQLite
    transaction and one delta-encode batch. An exception inside the block
    discards the session."""

    def __init__(self, engine: "MicroNN"):
        self._engine = engine
        self._ops: List[tuple] = []
        self._closed = False

    def _check_open(self):
        if self._closed:
            raise RuntimeError("session already committed/discarded")

    def upsert(self, ids: np.ndarray, vecs: np.ndarray,
               attrs: Optional[np.ndarray] = None):
        self._check_open()
        n_attr = self._engine.store.n_attr
        attrs = np.zeros((len(ids), n_attr), np.float32) if attrs is None \
            else np.array(attrs, np.float32, copy=True)
        self._ops.append(("up", np.array(ids, np.int64, copy=True),
                          np.array(vecs, np.float32, copy=True), attrs))

    def delete(self, ids: np.ndarray):
        self._check_open()
        self._ops.append(("del", np.array(ids, np.int64, copy=True)))

    def commit(self):
        self._check_open()
        self._closed = True
        if self._ops:
            self._engine._commit_session(self._ops)
        self._ops = []

    def discard(self):
        self._closed = True
        self._ops = []

    def __enter__(self) -> "WriteSession":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.commit()
        else:
            self.discard()
        return False


class MicroNN:
    def __init__(self, dim: int, n_attr: int = 0, path: str = ":memory:",
                 config: Optional[IVFConfig] = None,
                 monitor: Optional[MonitorConfig] = None,
                 quantize: Optional[str] = None,
                 rerank_factor: Optional[int] = None,
                 device=None,
                 memory_budget_mb: Optional[float] = None,
                 max_rows_per_step: int = 4096,
                 trace_ring_capacity: int = 256,
                 slow_query_ms: float = 100.0,
                 frame_pool=None,
                 tenant: Optional[str] = None):
        """`quantize="int8"` turns on the scalar-quantized tier: searches
        scan int8 codes and rerank `rerank_factor * k` candidates at
        float32; codes are durable in the SQLite `codes` table.

        `device` is where the index lives and the kernels run: None means
        "cuda" (raises without a GPU); pass "cpu" for the plain versions.

        `memory_budget_mb` switches to the disk-resident (paged) mode: the
        scan tier (int8 codes when quantized, float32 vectors otherwise)
        stays in SQLite and is paged on demand into a frame pool of at
        most that many bytes on the device; an int8 index reranks from
        the store. `frame_pool` + `tenant` page through a shared
        fleet.pool.FramePool (on the same device) under its budget
        instead of a private pool; `tenant` names this engine's frames.

        `monitor` sets the maintenance triggers (core/monitor.py);
        `max_rows_per_step` bounds one maintenance quantum: one
        `maintain_step()` touches at most that many rows.

        `trace_ring_capacity` sizes the ring of recent traces and
        maintenance events (`self.traces`); traced queries at or above
        `slow_query_ms` are also kept in its slow-query log."""
        if memory_budget_mb is not None and not memory_budget_mb > 0:
            raise ValueError(f"memory_budget_mb must be > 0: "
                             f"{memory_budget_mb}")
        if frame_pool is not None and (memory_budget_mb is None
                                       or tenant is None):
            raise ValueError("a shared frame pool implies paged mode: pass "
                             "memory_budget_mb and a stable tenant name")
        self.device = resolve_device(device)
        self.memory_budget_mb = memory_budget_mb
        self._frame_pool = frame_pool
        self.tenant = None if tenant is None else str(tenant)
        self.lock = threading.RLock()
        # this engine's labeled view of the process metrics registry; a
        # fleet tenant's scope is labeled by name, so a reopened tenant
        # resumes its series
        if self.tenant is not None:
            self.metrics = obs_metrics.default_registry().scope(
                component="engine", tenant=self.tenant)
        else:
            self.metrics = obs_metrics.default_registry().scope(
                component="engine", inst=str(obs_metrics.next_instance()))
        self.store = VectorStore(path, dim=dim, n_attr=n_attr,
                                 metrics=self.metrics.scope(
                                     component="store"))
        cfg = config or IVFConfig(dim=dim)
        if quantize is not None:
            cfg = dataclasses.replace(cfg, quantize=quantize)
        if rerank_factor is not None:
            cfg = dataclasses.replace(cfg, rerank_factor=rerank_factor)
        self.config = cfg
        self.monitor = IndexMonitor(monitor)
        self.index = None   # IVFIndex (resident) or PagedIndex (paged)
        self.optimizer: Optional[HybridOptimizer] = None
        self.maintenance_log = []
        self.traces = obs_trace.TraceRing(capacity=trace_ring_capacity,
                                          slow_ms=slow_query_ms)
        self._c_queries = self.metrics.counter("queries")
        # a fleet tenant's query-latency histogram: the SLO layer's source
        # (Fleet.health()); a solo engine keeps the untimed path
        self._h_query_s = self.metrics.histogram("query_s") \
            if self.tenant is not None else None
        self.scheduler = MaintenanceScheduler(
            self, max_rows_per_step=max_rows_per_step,
            metrics=self.metrics.scope(component="scheduler"))
        # the serving front door attached to this engine, if any
        # (serving/frontdoor.py sets it; stats() reports its counters)
        self._frontdoor = None

    @property
    def paged(self) -> bool:
        return self.memory_budget_mb is not None

    # -- lifecycle -----------------------------------------------------------
    @_locked
    def build(self):
        """Initial clustering from the durable tier. With quantize="int8"
        the build trains the quantizer and persists codes + stats durably
        before the clustering swap (the crash ordering of the reference).
        Paged mode streams the build from SQLite (_build_paged).

        The resident build runs under its own trace: each of its stages
        (obs.trace.BUILD_STAGES) is observed in the engine's
        `stage_s{action="build", stage=...}` histogram and the build
        enters the trace ring as one MaintEvent of kind "build". No stage
        waits for the device: where a stage's device work is not waited
        for within it, the next stage that waits holds it."""
        if self.paged:
            self._build_paged()
            return
        tr = obs_trace.QueryTrace(mode="build")
        with obs_trace.activate(tr):
            with obs_trace.stage("load"):
                ids, _, vecs = self.store.all_rows()
                attrs = self.store.attributes_for(ids)
            self.index = ivf.build_index(vecs, ids.astype(np.int32), attrs,
                                         cfg=self.config, device=self.device)
            if self.index.codes is not None:
                with obs_trace.stage("codes"):
                    self._persist_codes()
            with obs_trace.stage("partitions"):
                assign = self._current_assignment()
                self.store.set_partitions(ids, assign[ids],
                                          *self._centroid_state())
                self._persist_maintenance_state()
            with obs_trace.stage("stats"):
                self._refresh_stats()
        self._observe_build(tr.finish(), rows=len(ids))

    def _observe_build(self, tr: obs_trace.QueryTrace, rows: int):
        """A finished build trace into the `stage_s{action="build"}`
        histograms and the ring's "build" MaintEvent (nothing when tracing
        is disabled)."""
        if not tr.spans:
            return
        stages = {name: s.dur_ms for name, s in tr.spans.items()}
        for name, ms in stages.items():
            self.metrics.histogram("stage_s", action="build",
                                   stage=name).observe(ms / 1e3)
        self.traces.append(obs_trace.MaintEvent(
            kind="build", action="build", rows=int(rows),
            dur_ms=tr.total_ms, stages=stages))

    @_locked
    def recover(self):
        """Rebuild device state from SQLite after a crash/restart (paged
        mode: metadata and the pending delta rows only)."""
        if self.paged:
            self._recover_paged()
            return
        ids, parts, vecs = self.store.all_rows()
        attrs = self.store.attributes_for(ids)
        cents, csizes = self.store.centroids()
        if len(cents) == 0:
            # no durable clustering: drop all derived state
            self.index = None
            self.optimizer = None
            return
        live = parts >= 0
        # the durable tier stores raw rows; the packed index holds
        # metric-normalised ones. Pending delta rows stay raw: the replay
        # upsert below normalises them, exactly once.
        vecs_live = normalize_if_cosine(
            torch.from_numpy(np.ascontiguousarray(vecs[live], np.float32)),
            self.config.metric).numpy()
        qstats = None
        codes_live = None
        if self.config.quantize == "int8":
            qs = self.store.qstats()
            if qs is not None:
                # durable codes are authoritative; rows without one are
                # re-encoded from float32
                qstats = quantize.stats_from_arrays(*qs, device=self.device)
                codes_live, found = self.store.codes_for(ids[live])
                if not found.all():
                    codes_live[~found] = quantize.encode_np(
                        qstats, vecs_live[~found])
        packed = ivf.pack_partitions(
            vecs_live, ids[live].astype(np.int32), attrs[live],
            parts[live].astype(np.int64), len(cents),
            pad_to=self.config.pad_to, codes=codes_live)
        counts = packed[4]
        idx = ivf.index_from_packed(
            packed, cents, csizes, self.config, qstats, self.device,
            float(np.float32(max(counts.mean(), 1.0))))
        mstate = self.store.maintenance_state()
        if mstate is not None:
            base, drift = mstate
            if drift.shape[0] == len(cents):
                idx = dataclasses.replace(
                    idx, drift=torch.as_tensor(drift, device=self.device),
                    base_mean_size=float(np.float32(base)))
        self.index = idx
        # replay delta rows (partition -1) in capacity-sized chunks, with a
        # flush in between when the delta fills
        if (~live).any():
            self._delta_append(ids[~live], vecs[~live], attrs[~live])
        self._refresh_stats()

    def close(self):
        self.scheduler.stop_daemon()
        self.store.close()

    # -- writes ---------------------------------------------------------------
    @_locked
    def upsert(self, ids: np.ndarray, vecs: np.ndarray,
               attrs: Optional[np.ndarray] = None):
        n_attr = self.store.n_attr
        attrs = np.zeros((len(ids), n_attr), np.float32) if attrs is None \
            else attrs
        old_main = self._old_partitions(ids)
        self.store.upsert(ids, vecs, attrs, partition_id=-1)
        if self.index is None:
            return
        self._drop_from_partitions(old_main)
        with self._write_trace():
            self._delta_append(np.asarray(ids), np.asarray(vecs, np.float32),
                               np.asarray(attrs, np.float32))

    @_locked
    def delete(self, ids: np.ndarray):
        old_main = self._old_partitions(ids)
        self.store.delete(ids)
        if self.index is None:
            return
        ids_t = torch.as_tensor(np.asarray(ids), dtype=torch.int32)
        if self.paged:
            self._drop_from_partitions(old_main)
            self.index.delta = delta_ops.delta_only_delete(self.index.delta,
                                                           ids_t)
            return
        self.index = delta_ops.delete(self.index, ids_t)

    def _old_partitions(self, ids) -> Optional[np.ndarray]:
        """Paged mode: the main-tier partitions holding the given assets,
        read BEFORE a durable write moves or removes them (one entry per
        unique id: one durable row, one count decrement)."""
        if not self.paged or self.index is None:
            return None
        old = self.store.partitions_for(np.unique(np.asarray(ids)))
        return old[old >= 0]

    def _drop_from_partitions(self, old_main: Optional[np.ndarray]):
        """Paged mode: after the durable write, invalidate the frames of
        the partitions that lost rows and take the rows off their counts
        (resident mode tombstones on the device instead)."""
        if old_main is None or not old_main.size:
            return
        self.index.cache.invalidate(np.unique(old_main))
        self.index.counts = self.index.counts - np.bincount(
            old_main, minlength=self.index.k)

    def session(self) -> WriteSession:
        """Open a batched write session (one SQLite transaction + one
        delta-encode batch when the `with` block exits cleanly)."""
        return WriteSession(self)

    @_locked
    def _commit_session(self, ops: List[tuple]):
        """Apply a session's coalesced net effect atomically: per-id
        last-write-wins, as sequential upsert()/delete() calls would."""
        id_chunks, kind_chunks, row_chunks = [], [], []
        vec_chunks, attr_chunks = [], []
        row_off = 0
        for op in ops:
            if op[0] == "up":
                _, ids, vecs, attrs = op
                row_chunks.append(row_off + np.arange(len(ids)))
                vec_chunks.append(vecs)
                attr_chunks.append(attrs)
                row_off += len(ids)
                kind_chunks.append(np.ones(len(ids), bool))
            else:
                ids = op[1]
                row_chunks.append(np.full(len(ids), -1))
                kind_chunks.append(np.zeros(len(ids), bool))
            id_chunks.append(ids)
        ids_all = np.concatenate(id_chunks)
        kind_all = np.concatenate(kind_chunks)
        rows_all = np.concatenate(row_chunks)
        _, first_rev = np.unique(ids_all[::-1], return_index=True)
        last = len(ids_all) - 1 - first_rev          # last op per id
        is_up = kind_all[last]
        up_ids = ids_all[last[is_up]]
        del_ids = ids_all[last[~is_up]]
        vecs_all = np.concatenate(vec_chunks) if vec_chunks \
            else np.zeros((0, self.store.dim), np.float32)
        attrs_all = np.concatenate(attr_chunks) if attr_chunks \
            else np.zeros((0, self.store.n_attr), np.float32)
        up_vecs = vecs_all[rows_all[last[is_up]]]
        up_attrs = attrs_all[rows_all[last[is_up]]]
        old_main = self._old_partitions(np.concatenate([up_ids, del_ids]))
        with self._write_trace():
            with obs_trace.stage("commit"), self.store.transaction():
                # ONE durable transaction
                if len(up_ids):
                    self.store.upsert(up_ids, up_vecs, up_attrs,
                                      partition_id=-1)
                if len(del_ids):
                    self.store.delete(del_ids)
            if self.index is None:
                return
            if self.paged:
                # one deferred invalidation pass for the whole session
                self._drop_from_partitions(old_main)
                if len(del_ids):
                    self.index.delta = delta_ops.delta_only_delete(
                        self.index.delta, torch.as_tensor(del_ids,
                                                          dtype=torch.int32))
            elif len(del_ids):
                self.index = delta_ops.delete(
                    self.index, torch.as_tensor(del_ids, dtype=torch.int32))
            self._delta_append(up_ids, up_vecs, up_attrs)

    def _delta_append(self, ids: np.ndarray, vecs: np.ndarray,
                      attrs: np.ndarray):
        """Append rows to the device delta in capacity-sized chunks,
        flushing when full."""
        cap = self.config.delta_capacity
        for s in range(0, len(ids), cap):
            e = min(s + cap, len(ids))
            if delta_ops.delta_free_slots(self.index) < e - s:
                with obs_trace.stage("flush"):
                    self.maintain(force="flush")
            v = torch.as_tensor(np.ascontiguousarray(vecs[s:e], np.float32))
            i = torch.as_tensor(np.asarray(ids[s:e]).astype(np.int32))
            a = torch.as_tensor(np.ascontiguousarray(attrs[s:e], np.float32))
            if self.paged:
                self.index.delta = delta_ops.delta_only_upsert(
                    self.index.delta, v, i, a, self.config.metric,
                    self.index.qstats)
            else:
                self.index = delta_ops.upsert(self.index, v, i, a)

    @contextlib.contextmanager
    def _write_trace(self):
        """The write trace of a session or an upsert, as build() has its
        own: on leaving the block its "commit" span (a session's durable
        transaction) and "flush" span (each inline delta flush a full delta
        forced) go to the `stage_s{action="write"}` histograms, each of a
        span's calls at the span's mean (nothing when tracing is
        disabled)."""
        tr = obs_trace.QueryTrace(mode="write")
        with obs_trace.activate(tr):
            yield
        for name in ("commit", "flush"):
            span = tr.spans.get(name)
            if span is None:
                continue
            h = self.metrics.histogram("stage_s", action="write", stage=name)
            for _ in range(span.calls):
                h.observe(span.dur_ms / span.calls / 1e3)

    # -- maintenance ----------------------------------------------------------
    @_locked
    def maintain(self, force: Optional[str] = None,
                 until_idle: bool = False,
                 max_steps: Optional[int] = None):
        """Run maintenance.

        `maintain(until_idle=True)` is the steady-state path: the
        scheduler drains the monitor's work queue (partial flushes,
        splits, merges, local reclusters, repacks) in `max_rows_per_step`
        quanta, never a full rebuild, and returns the StepReports
        (`max_steps` bounds how many).

        `maintain(force="flush" | "rebuild")`, or no argument for the
        monitor's verdict, runs whole-index maintenance and returns the
        action taken ("flush", "rebuild" or None). The resident forced
        flush folds the delta on the device (the durable rows stay in the
        pending partition until the next build, as in the reference); the
        paged flush moves them durably. A rebuild re-clusters every live
        row through ivf.build_index (resident) or the streamed paged build,
        both of which run the kmeans_assign kernel."""
        if force not in (None, "flush", "rebuild"):
            raise ValueError(f"force must be None, 'flush' or 'rebuild': "
                             f"{force!r}")
        if self.index is None:
            return [] if until_idle else None
        if until_idle:
            if force is not None:
                raise ValueError("until_idle excludes force")
            return self.scheduler.drain(max_steps=max_steps)
        if self.paged:
            return self._maintain_paged(force)
        action = force or self.monitor.check(self.index).action
        if action == "flush":
            self.index, stats = maintenance.flush_delta(self.index)
            self.maintenance_log.append(stats)
            self.store.update_centroids(*self._centroid_state())
            self._persist_maintenance_state()
            return "flush"
        if action == "rebuild":
            self.index, stats = maintenance.full_rebuild(self.index)
            self.maintenance_log.append(stats)
            # a rebuild retrains the quantizer, so every code changes:
            # codes + stats persist before the clustering swap (build()'s
            # crash ordering)
            self._persist_codes()
            ids, _, _ = self.store.all_rows()
            assign = self._current_assignment()
            self.store.set_partitions(ids, assign[ids],
                                      *self._centroid_state())
            self._persist_maintenance_state()
            self._refresh_stats()
            return "rebuild"
        return None

    @_locked
    def maintain_step(self) -> Optional[StepReport]:
        """One bounded maintenance quantum (<= max_rows_per_step rows): the
        highest-priority item of the monitor's work queue. Queries between
        steps see a consistent mixed old/new partition state. None when
        the index is idle."""
        if self.index is None:
            return None
        return self.scheduler.step()

    def _execute_work_item(self, item: WorkItem,
                           max_rows: int) -> Optional[StepReport]:
        """Scheduler callback: run one work item. None when it plans to a
        no-op (the scheduler then skips it)."""
        if item.action == "flush":
            return self._flush_step(max_rows)
        if item.action == "repack":
            # device-only tombstone repack: no durable I/O by contract
            if self.paged:
                raise ValueError("paged frames carry no tombstones")
            self.index = maintenance.repack_partition(self.index,
                                                      item.pids[0])
            return StepReport("repack", item.pids, item.rows, 0)
        idx = self.index
        cents, csz = self._centroid_state()
        counts = np.asarray(idx.counts) if self.paged \
            else idx.counts.cpu().numpy()
        fetch = self._fetch_rows_paged if self.paged \
            else self._fetch_rows_resident
        mcfg = self.monitor.cfg
        if item.action == "split":
            plan = maintenance.plan_split(
                cents, csz, counts, item.pids[0], fetch, row_budget=max_rows,
                n_local=mcfg.split_neighbors)
        elif item.action == "merge":
            plan = maintenance.plan_merge(cents, csz, counts, item.pids[0],
                                          item.pids[1], fetch)
        elif item.action == "recluster":
            plan = maintenance.plan_local_recluster(
                cents, csz, counts, item.pids[0], fetch, row_budget=max_rows,
                n_local=mcfg.repair_neighbors)
        else:
            raise ValueError(f"unknown maintenance action {item.action!r}")
        if plan is None:
            return None
        return self._apply_repair(plan)

    def _flush_step(self, max_rows: int) -> StepReport:
        """A (possibly partial) delta flush as one scheduler quantum. Unlike
        the forced resident flush it also moves the rows durably (as the
        paged flush does), so the two modes leave identical durable states
        behind every step."""
        if self.paged:
            stats = self._paged_flush(max_rows=max_rows)
            if stats is None:
                return StepReport("flush", (), 0, 0)
            return StepReport("flush", (), stats.rows_moved,
                              stats.bytes_written)
        d = self.index.delta
        live = np.nonzero(d.valid.cpu().numpy())[0][:max_rows]
        dids = d.ids.cpu().numpy()[live]
        dx = d.vectors.cpu().numpy()[live]     # metric-normalised
        dcod = d.codes.cpu().numpy()[live] if d.codes is not None else None
        assign = maintenance.assign_nearest_centroid(
            dx, self.index.centroids) if live.size \
            else np.zeros((0,), np.int64)
        self.index, stats = maintenance.flush_delta(
            self.index, max_rows=max_rows, assign=assign)
        self.maintenance_log.append(stats)
        with self.store.transaction():        # one atomic durable flush
            if live.size and dcod is not None:
                # codes first (the crash contract: valid either way)
                self.store.set_code_tier(
                    dids, dcod, *quantize.stats_to_arrays(self.index.qstats))
            # row moves + the touched centroids only (never O(k) a quantum)
            touched = np.unique(assign)
            cents, csz = self._centroid_state()
            self.store.apply_repair(dids, assign, touched, cents[touched],
                                    csz[touched])
            self._persist_maintenance_state()
        return StepReport("flush", (), stats.rows_moved,
                          stats.bytes_written)

    # -- local repair (split / merge / recluster) -----------------------------
    def _fetch_rows_resident(self, pids):
        """RowFetch over the packed device layout: one gather of the listed
        partitions, rows sorted by asset id (the order SQLite's clustered
        scan yields -- the paged planner sees the same rows)."""
        pids = [int(p) for p in pids]
        vec, vid, vat, val, cod = maintenance._partition_rows(self.index,
                                                              pids)
        out = {}
        for j, p in enumerate(pids):
            sel = np.nonzero(val[j])[0]
            ids = vid[j][sel]
            order = np.argsort(ids, kind="stable")
            out[p] = maintenance.RowBlock(
                ids=ids[order].astype(np.int32), vecs=vec[j][sel][order],
                attrs=vat[j][sel][order],
                codes=None if cod is None else cod[j][sel][order])
        return out

    def _fetch_rows_paged(self, pids):
        """RowFetch streaming the neighbourhood from SQLite in one batched
        read; rows arrive sorted by asset id and are metric-normalised as
        the pager's fault path does."""
        counts = self.index.counts
        pids = [int(p) for p in pids]
        p_max = int(max(max(counts[p] for p in pids), 1))
        blocks = self.store.scan_partitions(pids, p_max, with_vecs=True)
        vecs = normalize_rows(blocks.vecs, self.config.metric)
        out = {}
        for j, p in enumerate(pids):
            m = int(blocks.valid[j].sum())
            out[p] = maintenance.RowBlock(
                ids=blocks.ids[j, :m].astype(np.int32), vecs=vecs[j, :m])
        return out

    def _apply_repair(self, plan) -> StepReport:
        """Persist + apply one RepairPlan: (1) codes for the touched rows
        that lack one (the existing quantizer, so valid under either
        clustering); (2) the row moves + touched centroids as ONE
        transaction (VectorStore.apply_repair) -- a crash between the two
        serves the pre-repair clustering; only then the device or paged
        state."""
        idx = self.index
        quantized = idx.quantized
        code_bytes = 0
        if quantized and plan.rows:
            _, found = self.store.codes_for(plan.row_ids)
            if not found.all():
                missing = ~found
                enc = quantize.encode_np(idx.qstats, plan.row_vecs[missing])
                self.store.set_code_tier(
                    plan.row_ids[missing], enc,
                    *quantize.stats_to_arrays(idx.qstats))
                code_bytes = int(missing.sum()) * self.store.dim
        # only the durably moved rows get UPDATEs (rows still in the
        # pending partition are promoted too), only the touched partitions
        # centroid rewrites
        old_pid = self.store.partitions_for(plan.row_ids)
        movedm = old_pid != plan.assign
        if self.paged:
            self._fit_frames(max((plan.assign == p).sum()
                                 for p in plan.pids))
        self.store.apply_repair(
            plan.row_ids[movedm], plan.assign[movedm], plan.pids,
            plan.centroids, plan.csizes)
        n_attr = self.store.n_attr
        row_b = 4 * self.store.dim + 4 + 4 * n_attr + 1
        bytes_written = int(movedm.sum()) * row_b \
            + len(plan.pids) * self.store.dim * 4 + code_bytes
        p_max_before = idx.p_max
        if self.paged:
            self._apply_repair_paged(plan)
        else:
            self.index = maintenance.apply_plan(self.index, plan)
        self.maintenance_log.append(maintenance.MaintenanceStats(
            kind=plan.kind, rows_moved=int(movedm.sum()),
            partitions_touched=len(plan.pids), bytes_written=bytes_written,
            p_max_before=p_max_before, p_max_after=self.index.p_max))
        self._persist_maintenance_state()
        return StepReport(plan.kind, tuple(int(p) for p in plan.pids),
                          plan.rows, bytes_written)

    def _apply_repair_paged(self, plan):
        """Paged apply: the durable tier is the scan tier, so the repair is
        already in place -- update the resident metadata (centroids,
        csizes, counts, drift) and invalidate exactly the touched frames
        (_apply_repair grew the frame geometry before the durable write)."""
        idx = self.index
        k = idx.k
        k_new = max(k, plan.k_after)
        cents, csz = self._centroid_state()
        counts = np.array(idx.counts)
        drift = np.array(idx.drift, np.float32) if idx.drift is not None \
            else np.zeros((k,), np.float32)
        if k_new > k:
            grow = k_new - k
            cents = np.pad(cents, [(0, grow), (0, 0)])
            csz = np.pad(csz, (0, grow))
            counts = np.pad(counts, (0, grow))
            drift = np.pad(drift, (0, grow))
        cents[plan.pids] = plan.centroids
        csz[plan.pids] = plan.csizes
        sizes = np.asarray([(plan.assign == p).sum() for p in plan.pids])
        counts[plan.pids] = sizes
        drift[plan.pids] = 0.0
        idx.centroids = torch.as_tensor(cents, device=self.device)
        idx.csizes = torch.as_tensor(csz, device=self.device)
        idx.counts = counts
        idx.drift = drift
        idx.cache.invalidate([int(p) for p in plan.pids])

    def _fit_frames(self, rows: int):
        """Paged mode: grow the frame geometry so a partition of `rows`
        rows fits. Called before the durable write that makes a partition
        that large, so a concurrent reader's fault (through the snapshot
        connection) never meets a partition larger than a frame."""
        cache = self.index.cache
        pad = self.config.pad_to
        need = -(-int(max(rows, 1)) // pad) * pad
        if need > cache.p_max:
            cache.resize(need)

    # -- queries --------------------------------------------------------------
    def query(self, queries: np.ndarray, spec: Optional[QuerySpec] = None,
              *, trace: bool = False) -> ResultSet:
        """THE query entry point: execute a declarative QuerySpec against
        a snapshot of the index (reads never take the write mutex).

        `trace=True` records a per-query QueryTrace: every layer the query
        crosses (planner, probe, pager, scan, rerank, merge) adds its span,
        the trace enters the engine's ring (`self.traces`) and rides back
        on `result.trace`. Untraced, no span is allocated -- unless an
        outer trace is active on this thread (the front door's shared
        fused-call trace), which the layers then record into. A fleet
        tenant (`tenant` set) observes each call's latency, up to its
        answer being ready on the device, in its `query_s` histogram."""
        t0 = time.perf_counter() if self._h_query_s is not None else 0.0
        if trace and obs_trace.enabled():
            res = self._query_traced(queries, spec)
        else:
            res = self._query_inner(queries, spec)
        if self._h_query_s is not None:
            # a tenant's latency is until its answer is ready on the device
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._h_query_s.observe(time.perf_counter() - t0)
        # recording off costs this one global load and branch
        rec = obs_recorder._ACTIVE
        if rec is not None:
            rec.record(obs_recorder.SITE_ENGINE, self.tenant, queries, spec,
                       result=res)
        return res

    def _query_traced(self, queries, spec: Optional[QuerySpec]) -> ResultSet:
        tr = obs_trace.QueryTrace(mode="paged" if self.paged else "resident")
        with obs_trace.activate(tr):
            res = self._query_inner(queries, spec)
        tr.finish()
        tr.refer(res)
        res.trace = tr
        self.traces.append(tr)
        return res

    def explain(self, queries: np.ndarray,
                spec: Optional[QuerySpec] = None) -> obs_trace.QueryTrace:
        """Execute the query traced and return its QueryTrace (the result
        rides on `trace.result`): the per-stage wall time and work counters
        of this spec on this engine."""
        res = self.query(queries, spec, trace=True)
        if res.trace is not None:
            res.trace.result = res
        return res.trace

    def _query_inner(self, queries, spec: Optional[QuerySpec]) -> ResultSet:
        idx, optimizer = self.index, self.optimizer
        if idx is None:
            raise RuntimeError("build() or recover() first")
        self._c_queries.inc()
        spec = self._resolve_spec_traced(
            idx, optimizer, QuerySpec() if spec is None else spec,
            _n_rows(queries))
        res = executor.run(idx, queries, spec)
        if spec.gather_attrs and self.store.n_attr:
            res.attrs = self._gather_attrs(res.to_numpy()[0])
        return res

    def query_batched(self, chunks: List[np.ndarray],
                      spec: Optional[QuerySpec] = None) -> List[ResultSet]:
        """Per-caller query chunks sharing ONE spec run as a single fused
        scan and come back split per caller, each equal to its solo
        query()."""
        idx, optimizer = self.index, self.optimizer
        if idx is None:
            raise RuntimeError("build() or recover() first")
        self._c_queries.inc(len(chunks))
        # the optimizer's rewrite depends on the spec and the stats only,
        # so one resolution serves every chunk
        spec = self._resolve_spec_traced(
            idx, optimizer, QuerySpec() if spec is None else spec,
            sum(_n_rows(c) for c in chunks))
        results = executor.run_coalesced(idx, chunks, spec)
        if spec.gather_attrs and self.store.n_attr:
            for rs in results:
                rs.attrs = self._gather_attrs(rs.to_numpy()[0])
        return results

    def _resolve_spec_traced(self, idx, optimizer, spec: QuerySpec,
                             n_queries: int) -> QuerySpec:
        """_resolve_spec as the `plan` stage (with a trace active: the
        hybrid decision and the resolved shape)."""
        with obs_trace.stage(obs_trace.STAGE_PLAN) as st:
            spec = self._resolve_spec(idx, optimizer, spec)
            if st:
                st.note(kind=spec.kind, k=int(spec.k),
                        n_probe=int(spec.n_probe), hybrid=spec.hybrid,
                        predicate=spec.predicate is not None)
                st.trace.spec = spec
                st.trace.n_queries += n_queries
        return spec

    def _resolve_spec(self, idx, optimizer: Optional[HybridOptimizer],
                      spec: QuerySpec) -> QuerySpec:
        """Resolve the hybrid pre/post choice (and size the pre-filter cap)
        from the selectivity estimate (paper Eqs. 1-3). Resident mode only:
        paged mode runs predicates as post-filters over the frame scan.
        Hand-written filter callables have no estimate and run as
        post-filters."""
        if not self.paged and spec.predicate_tree is not None \
                and spec.kind == "ann" \
                and (spec.hybrid == "auto"
                     or (spec.hybrid == "pre" and spec.cap is None)):
            spec, _ = optimizer.plan_spec(idx, spec)
        return spec

    def search(self, queries: np.ndarray, k: int = 100, n_probe: int = 8,
               predicate: Optional[Node] = None, exact: bool = False,
               batch_mqo: Optional[bool] = None,
               backend: Optional[str] = None) -> ResultSet:
        """Kwarg shim: kwargs -> QuerySpec -> query(). `batch_mqo` has no
        effect (a batched ANN spec is the MQO shared scan) and warns;
        `exact=True` with a predicate runs the filtered exact oracle."""
        if batch_mqo is not None:
            warnings.warn(
                "MicroNN.search(batch_mqo=...) is deprecated and has no "
                "effect: a batched ANN QuerySpec is the MQO shared scan; "
                "use MicroNN.query(vecs, Q.knn(...))",
                DeprecationWarning, stacklevel=2)
        spec = Q.exact(k=k) if exact else Q.knn(k=k, n_probe=n_probe)
        if predicate is not None:
            spec = spec.where(predicate)
        if backend is not None:
            spec = spec.backend(backend)
        return self.query(queries, spec)

    def _gather_attrs(self, ids: np.ndarray) -> np.ndarray:
        """[Q, k] result ids -> [Q, k, n_attr] attribute rows from the
        durable tier (zeros where INVALID)."""
        Qn, k = ids.shape
        flat = ids.reshape(-1)
        got = flat != INVALID_ID
        out = np.zeros((Qn * k, self.store.n_attr), np.float32)
        if got.any():
            out[got] = self.store.attributes_for(flat[got])
        return out.reshape(Qn, k, self.store.n_attr)

    # -- observability --------------------------------------------------------
    def stats(self) -> dict:
        """Operational counters with the reference's keys in both modes,
        each a derived view of the metrics registry: pager hits/misses/
        evictions (zero in resident mode), resident scan-tier bytes
        (resident: the f32 tier + codes; paged: the frame pool, at most
        the budget), the maintenance scheduler's queue depth, daemon state
        and counters, and `frontdoor`, the attached front door's counters
        (zeroed without one). In place of the reference's jit keys
        (`trace_count`, `compile_cache_size`) the port reports `run_count`
        (fused scan calls) and `kernel_loads` (kernel libraries loaded),
        plus the kernel launch counts of this process."""
        from ..serving import frontdoor as frontdoor_mod
        sched = self.scheduler
        fd = self._frontdoor
        out = {"paged": self.paged, "hits": 0, "misses": 0, "evictions": 0,
               "resident_bytes": 0, "budget_bytes": None,
               "device": str(self.device),
               "run_count": executor.run_count(),
               "kernel_loads": build.load_count(),
               "scheduler_depth": sched.queue_depth(),
               "daemon_alive": sched.daemon_alive,
               "daemon_steps": sched.daemon_steps,
               "scheduler": sched.stats(),
               "frontdoor": fd.stats() if fd is not None
               else frontdoor_mod.empty_stats(),
               "launches": ops.launch_counts()}
        idx = self.index
        if idx is None:
            return out
        if self.paged:
            out.update(idx.cache.stats())
            return out
        resident = sum(t.numel() * t.element_size() for t in
                       (idx.vectors, idx.ids, idx.valid, idx.attrs))
        if idx.codes is not None:
            resident += idx.codes.numel()
        out["resident_bytes"] = int(resident)
        return out

    # -- paged lifecycle (memory_budget_mb mode) ------------------------------
    def _build_paged(self):
        """Cluster + persist durably, then attach a paged view, streamed
        from SQLite: host memory stays O(batch + ids). The quantizer trains
        with train_from_store, codes encode batch by batch, mini-batch
        k-means samples from disk, the final assignment (the kmeans_assign
        kernel) streams the clustered scan, and the generation swap moves
        partition ids with keyed UPDATEs. Codes + stats land before the
        clustering swap (build()'s crash ordering)."""
        cfg = self.config
        store = self.store
        batch = max(cfg.minibatch_size, 4096)
        ids = store.iter_asset_ids()
        if cfg.quantize == "int8":
            qstats = quantize.train_from_store(store, cfg.metric, batch,
                                               device=self.device)

            def _code_chunks():
                off = 0
                for b in store.iter_batches(batch):
                    yield (ids[off:off + len(b)], quantize.encode_np(
                        qstats, normalize_rows(b, cfg.metric)))
                    off += len(b)
            # one transaction for the whole stream: a crash never leaves
            # old codes paired with the retrained stats
            store.set_code_tier_streaming(
                _code_chunks(), *quantize.stats_to_arrays(qstats))
        km = kmeans.MiniBatchKMeans(cfg, device=self.device)
        km.fit(lambda size, rng: store.sample(size, rng), len(ids))
        assign = km.assign(store.iter_batches(batch))
        store.reassign_partitions(ids, assign, km.centroids, km.counts)
        self._attach_paged()
        # a fresh clustering resets the maintenance signals
        self._persist_maintenance_state()

    def _attach_paged(self):
        """Build the PagedIndex from durable metadata only: centroids,
        per-partition counts, quantizer stats, and an empty frame pool
        sized to the byte budget."""
        cfg = self.config
        cents, csizes = self.store.centroids()
        if len(cents) == 0:
            self.index = None
            self.optimizer = None
            return
        counts = self.store.partition_counts(len(cents))
        qstats, payload = None, "f32"
        if cfg.quantize == "int8":
            qs = self.store.qstats()
            if qs is not None:
                qstats = quantize.stats_from_arrays(*qs, device=self.device)
                payload = "int8"
        pad = cfg.pad_to
        p_max = int(max(counts.max() if len(counts) else 0, 1))
        p_max = max(pad, -(-p_max // pad) * pad)
        # the pager's counters live under this engine's scope, so they stay
        # cumulative across rebuilds (get-or-create returns the same ones)
        cache = pager.PartitionCache(
            self.store, p_max=p_max,
            budget_bytes=int(self.memory_budget_mb * 2 ** 20),
            payload=payload, metric=cfg.metric, qstats=qstats,
            with_attrs=self.store.n_attr > 0,
            metrics=self.metrics.scope(component="pager"),
            pool=self._frame_pool, tenant=self.tenant, device=self.device)
        nonempty = counts[counts > 0]
        self.index = PagedIndex(
            centroids=torch.as_tensor(np.asarray(cents, np.float32),
                                      device=self.device),
            csizes=torch.as_tensor(np.asarray(csizes, np.float32),
                                   device=self.device),
            counts=counts,
            delta=DeltaStore.empty(cfg.delta_capacity, self.store.dim,
                                   self.store.n_attr,
                                   quantized=payload == "int8",
                                   device=self.device),
            cache=cache,
            base_mean_size=float(nonempty.mean()) if nonempty.size else 1.0,
            qstats=qstats,
            drift=np.zeros((len(cents),), np.float32),
            config=cfg)
        self.optimizer = None

    def _recover_paged(self):
        """Paged recovery restores metadata, centroids and the pending
        delta rows; partitions fault in on their first probe."""
        self._attach_paged()
        if self.index is None:
            return
        mstate = self.store.maintenance_state()
        if mstate is not None:
            base, drift = mstate
            if drift.shape[0] == self.index.k:
                self.index.drift = np.asarray(drift, np.float32)
                self.index.base_mean_size = float(base)
        pids, pvecs = self.store.scan_partition(-1)
        if len(pids):
            self._delta_append(pids, pvecs, self.store.attributes_for(pids))

    def _maintain_paged(self, force: Optional[str]) -> Optional[str]:
        """Paged whole-index maintenance: the forced action, or the
        monitor's growth / delta-pressure verdict."""
        idx = self.index
        mcfg = self.monitor.cfg
        action = force
        if action is None:
            nonempty = idx.counts[idx.counts > 0]
            mean_size = float(nonempty.mean()) if nonempty.size else 0.0
            growth = mean_size / max(idx.base_mean_size, 1.0) - 1.0
            if growth >= mcfg.growth_rebuild_threshold:
                action = "rebuild"
            elif idx.delta.count >= \
                    mcfg.delta_flush_fraction * idx.delta.capacity:
                action = "flush"
        if action == "flush":
            self._paged_flush()
            return "flush"
        if action == "rebuild":
            # a full re-cluster straight from the durable tier (pending rows
            # included); _attach_paged re-sizes the pool and drops every
            # frame, which is the rebuild's cache invalidation
            n_rows = self.store.count()
            p_before = idx.cache.p_max
            self._build_paged()
            row_b = 4 * self.store.dim + 4 + 4 * self.store.n_attr + 1 \
                + (self.store.dim if self.config.quantize == "int8" else 0)
            self.maintenance_log.append(maintenance.MaintenanceStats(
                kind="full", rows_moved=n_rows,
                partitions_touched=self.index.k,
                bytes_written=n_rows * row_b
                + self.index.k * self.store.dim * 4,
                p_max_before=p_before, p_max_after=self.index.cache.p_max))
            return "rebuild"
        return None

    def _paged_flush(self, max_rows: Optional[int] = None):
        """Paged flush: move the live delta rows (the first `max_rows` of
        them; the rest stay searchable in the delta) into their nearest
        partitions durably (the clustered SQLite table is the scan tier
        here), write their codes, update the touched centroids by the
        running-mean rule, then invalidate the touched frames. Rows stay
        searchable in the delta until the delta is replaced at the end (a
        copy seen twice meanwhile is deduped by id). Returns the flush's
        MaintenanceStats (None without live rows)."""
        idx = self.index
        d = idx.delta
        quantized = idx.quantized
        live = np.nonzero(d.valid.cpu().numpy())[0]
        deferred = np.zeros((0,), np.int64)
        if max_rows is not None and live.size > max_rows:
            live, deferred = live[:max_rows], live[max_rows:]
        p_before = idx.cache.p_max
        stats = None
        if live.size:
            dx = d.vectors.cpu().numpy()[live]          # metric-normalised
            dids = d.ids.cpu().numpy()[live]
            assign = maintenance.assign_nearest_centroid(dx, idx.centroids)
            touched = np.unique(assign)
            if quantized:
                # the insert-time codes move verbatim
                dcod = d.codes.cpu().numpy()[live] if d.codes is not None \
                    else quantize.encode_np(idx.qstats, dx)
                self.store.set_code_tier(
                    dids, dcod, *quantize.stats_to_arrays(idx.qstats))
            cent, csz = self._centroid_state()
            if idx.drift is None:
                idx.drift = np.zeros((idx.k,), np.float32)
            maintenance.running_mean_update(cent, csz, dx, assign, touched,
                                            drift=idx.drift)
            counts = idx.counts + np.bincount(assign, minlength=idx.k)
            self._fit_frames(int(counts.max()))
            # row moves + the touched centroids in one transaction
            self.store.apply_repair(dids, assign, touched, cent[touched],
                                    csz[touched])
            idx.cache.invalidate(touched)
            idx.counts = counts
            idx.centroids = torch.as_tensor(cent, device=self.device)
            idx.csizes = torch.as_tensor(csz, device=self.device)
            self._persist_maintenance_state()
            stats = maintenance.MaintenanceStats(
                kind="incremental", rows_moved=int(live.size),
                partitions_touched=int(len(touched)),
                bytes_written=int(live.size
                                  * (4 * idx.dim + 4 + 4 * idx.n_attr + 1
                                     + (idx.dim if quantized else 0))
                                  + len(touched) * idx.dim * 4),
                p_max_before=p_before, p_max_after=idx.cache.p_max)
            self.maintenance_log.append(stats)
        idx.delta = maintenance.compact_delta(d, deferred, idx.n_attr,
                                              quantized, idx.qstats)
        return stats

    # -- helpers --------------------------------------------------------------
    def _refresh_stats(self):
        """Rebuild the hybrid optimizer from the live main-tier attribute
        rows (one device-to-host copy of those rows per refresh)."""
        idx = self.index
        self.optimizer = HybridOptimizer(
            AttributeStats(idx.attrs[idx.valid].cpu().numpy()),
            metrics=self.metrics.scope(component="planner"))

    def _persist_maintenance_state(self):
        """Mirror drift + the rebuild baseline into the store's meta table
        so recover() resumes them."""
        idx = self.index
        if idx is None:
            return
        if idx.drift is None:
            drift = np.zeros((idx.k,), np.float32)
        elif isinstance(idx.drift, torch.Tensor):
            drift = idx.drift.cpu().numpy().astype(np.float32)
        else:
            drift = np.asarray(idx.drift, np.float32)
        self.store.set_maintenance_state(float(idx.base_mean_size), drift)

    def _persist_codes(self):
        """Mirror the code tier (+ quantizer stats) durably in one
        transaction."""
        idx = self.index
        if idx is None or idx.codes is None:
            return
        val = idx.valid.cpu().numpy()
        self.store.set_code_tier(idx.ids.cpu().numpy()[val],
                                 idx.codes.cpu().numpy()[val],
                                 *quantize.stats_to_arrays(idx.qstats))

    def _current_assignment(self) -> np.ndarray:
        """asset id -> partition id for every live main-tier row."""
        idx = self.index
        vid = idx.ids.cpu().numpy()
        val = idx.valid.cpu().numpy()
        out = np.full(int(vid.max()) + 1 if vid.size else 1, -1, np.int64)
        parts = np.broadcast_to(
            np.arange(idx.k, dtype=np.int64)[:, None], vid.shape)[val]
        out[vid[val]] = parts
        return out

    def _centroid_state(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host copies of the centroids and their running counts."""
        return (self.index.centroids.cpu().numpy().copy(),
                self.index.csizes.cpu().numpy().astype(np.float32))
