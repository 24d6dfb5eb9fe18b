"""MicroNN: the embeddable engine facade (port of repro.storage.engine).

    eng = MicroNN(dim=128, n_attr=2, path="db.sqlite")   # device "cuda"
    with eng.session() as s:         # batched writes: ONE transaction
        s.upsert(ids, vecs, attrs)
        s.delete(stale_ids)
    eng.build()                      # initial clustering
    rs = eng.query(q, Q.knn(k=100).probe(8))
    rs = eng.query(q, Q.knn(k=10).where(Pred(0, "==", 3.0)))  # optimizer

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
versions run). Not ported yet (ROADMAP Queue A): maintenance beyond the
forced flush, tracing and the flight recorder.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import delta as delta_ops
from ..core import executor, ivf, kmeans, maintenance, quantize
from ..core.hybrid import AttributeStats, Node
from ..core.optimizer import HybridOptimizer
from ..core.query import Q, QuerySpec, ResultSet
from ..core.types import (INVALID_ID, DeltaStore, IVFConfig, PagedIndex,
                          normalize_if_cosine, normalize_rows,
                          resolve_device)
from ..kernels import ops
from . import pager
from .store import VectorStore

_MAINTENANCE_TODO = (
    "only maintain(force='flush') is ported (ROADMAP Queue A item 11: "
    "maintenance planning)")


def _locked(fn):
    """Run the method under the engine's write mutex (`self.lock`): a
    session commit, a direct upsert/delete and a flush never interleave
    partial transactions. Re-entrant, since write paths nest (upsert ->
    maintain(force="flush"))."""

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
                 quantize: Optional[str] = None,
                 rerank_factor: Optional[int] = None,
                 device=None,
                 memory_budget_mb: Optional[float] = None,
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
        instead of a private pool; `tenant` names this engine's frames."""
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
        self.store = VectorStore(path, dim=dim, n_attr=n_attr)
        cfg = config or IVFConfig(dim=dim)
        if quantize is not None:
            cfg = dataclasses.replace(cfg, quantize=quantize)
        if rerank_factor is not None:
            cfg = dataclasses.replace(cfg, rerank_factor=rerank_factor)
        self.config = cfg
        self.index = None   # IVFIndex (resident) or PagedIndex (paged)
        self.optimizer: Optional[HybridOptimizer] = None

    @property
    def paged(self) -> bool:
        return self.memory_budget_mb is not None

    # -- lifecycle -----------------------------------------------------------
    @_locked
    def build(self):
        """Initial clustering from the durable tier. With quantize="int8"
        the build trains the quantizer and persists codes + stats durably
        before the clustering swap (the crash ordering of the reference).
        Paged mode streams the build from SQLite (_build_paged)."""
        if self.paged:
            self._build_paged()
            return
        ids, _, vecs = self.store.all_rows()
        attrs = self.store.attributes_for(ids)
        self.index = ivf.build_index(vecs, ids.astype(np.int32), attrs,
                                     cfg=self.config, device=self.device)
        self._persist_codes()
        assign = self._current_assignment()
        self.store.set_partitions(ids, assign[ids], *self._centroid_state())
        self._persist_maintenance_state()
        self._refresh_stats()

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
        with self.store.transaction():    # ONE durable transaction
            if len(up_ids):
                self.store.upsert(up_ids, up_vecs, up_attrs, partition_id=-1)
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

    # -- maintenance ----------------------------------------------------------
    @_locked
    def maintain(self, force: Optional[str] = None):
        """The forced delta flush: fold every live delta row into its
        nearest partition. Resident mode flushes on the device (the durable
        rows stay in the pending partition until the next build, as in the
        reference's forced flush); paged mode moves them durably
        (_paged_flush). Automatic decisions and force="rebuild" are not
        ported yet."""
        if force != "flush":
            raise NotImplementedError(_MAINTENANCE_TODO)
        if self.index is None:
            return None
        if self.paged:
            self._paged_flush()
            return "flush"
        self.index, _ = maintenance.flush_delta(self.index)
        self.store.update_centroids(self.index.centroids.cpu().numpy(),
                                    self.index.csizes.cpu().numpy())
        self._persist_maintenance_state()
        return "flush"

    # -- queries --------------------------------------------------------------
    def query(self, queries: np.ndarray,
              spec: Optional[QuerySpec] = None) -> ResultSet:
        """THE query entry point: execute a declarative QuerySpec against
        a snapshot of the index (reads never take the write mutex)."""
        idx, optimizer = self.index, self.optimizer
        if idx is None:
            raise RuntimeError("build() or recover() first")
        spec = self._resolve_spec(idx, optimizer,
                                  QuerySpec() if spec is None else spec)
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
        # the optimizer's rewrite depends on the spec and the stats only,
        # so one resolution serves every chunk
        spec = self._resolve_spec(idx, optimizer,
                                  QuerySpec() if spec is None else spec)
        results = executor.run_coalesced(idx, chunks, spec)
        if spec.gather_attrs and self.store.n_attr:
            for rs in results:
                rs.attrs = self._gather_attrs(rs.to_numpy()[0])
        return results

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
        """Operational counters with the reference's keys in both modes:
        pager hits/misses/evictions (zero in resident mode), resident
        scan-tier bytes (resident: the f32 tier + codes; paged: the frame
        pool, at most the budget), plus the kernel launch counts of this
        process."""
        out = {"paged": self.paged, "hits": 0, "misses": 0, "evictions": 0,
               "resident_bytes": 0, "budget_bytes": None,
               "device": str(self.device),
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
        old = self.index.cache if isinstance(self.index, PagedIndex) \
            else None
        cache = pager.PartitionCache(
            self.store, p_max=p_max,
            budget_bytes=int(self.memory_budget_mb * 2 ** 20),
            payload=payload, metric=cfg.metric, qstats=qstats,
            with_attrs=self.store.n_attr > 0, pool=self._frame_pool,
            tenant=self.tenant, device=self.device)
        if old is not None:     # counters are cumulative across rebuilds
            for name in ("hits", "misses", "evictions", "bytes_read",
                         "bytes_staged", "staged_consumed"):
                setattr(cache, name, getattr(old, name))
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

    def _paged_flush(self):
        """Paged flush: move the live delta rows into their nearest
        partitions durably (the clustered SQLite table is the scan tier
        here), write their codes, update the touched centroids by the
        running-mean rule, then invalidate the touched frames. Rows stay
        searchable in the delta until the delta is replaced at the end
        (a copy seen twice meanwhile is deduped by id)."""
        idx = self.index
        d = idx.delta
        quantized = idx.quantized
        live = np.nonzero(d.valid.cpu().numpy())[0]
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
            cent = idx.centroids.cpu().numpy().copy()
            csz = idx.csizes.cpu().numpy().copy()
            if idx.drift is None:
                idx.drift = np.zeros((idx.k,), np.float32)
            maintenance.running_mean_update(cent, csz, dx, assign, touched,
                                            drift=idx.drift)
            # row moves + the touched centroids in one transaction
            self.store.apply_repair(dids, assign, touched, cent[touched],
                                    csz[touched])
            idx.cache.invalidate(touched)
            idx.counts = idx.counts + np.bincount(assign, minlength=idx.k)
            idx.centroids = torch.as_tensor(cent, device=self.device)
            idx.csizes = torch.as_tensor(csz, device=self.device)
            self._persist_maintenance_state()
            pad = self.config.pad_to
            new_p_max = max(idx.cache.p_max,
                            -(-int(idx.counts.max()) // pad) * pad)
            if new_p_max > idx.cache.p_max:   # a partition outgrew a frame
                idx.cache.resize(new_p_max)
        idx.delta = maintenance.compact_delta(
            d, np.zeros((0,), np.int64), idx.n_attr, quantized, idx.qstats)

    # -- helpers --------------------------------------------------------------
    def _refresh_stats(self):
        """Rebuild the hybrid optimizer from the live main-tier attribute
        rows (one device-to-host copy of those rows per refresh)."""
        idx = self.index
        self.optimizer = HybridOptimizer(
            AttributeStats(idx.attrs[idx.valid].cpu().numpy()))

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
        return (self.index.centroids.cpu().numpy(),
                self.index.csizes.cpu().numpy())
