"""MicroNN: the embeddable engine facade, resident mode (port of
repro.storage.engine).

    eng = MicroNN(dim=128, n_attr=2, path="db.sqlite")   # device "cuda"
    with eng.session() as s:         # batched writes: ONE transaction
        s.upsert(ids, vecs, attrs)
        s.delete(stale_ids)
    eng.build()                      # initial clustering
    rs = eng.query(q, Q.knn(k=100).probe(8))
    rs = eng.query(q, Q.knn(k=10).where(Pred(0, "==", 3.0)).postfilter())

Writes are serialised (single writer, paper §3.6); every write lands in
SQLite (durable, WAL) and in the device index (delta-store), so readers see
updates at once while the host copy guarantees recoverability --
`recover()` rebuilds device state from SQLite after a crash. The database
schema is the JAX package's, so either engine recovers the other's file.

The index lives on the engine's device: "cuda" unless the caller asks for
the CPU (`device="cpu"`, where the kernels' plain versions run). Not
ported yet (ROADMAP Queue A): paged mode (`memory_budget_mb`, shared frame
pools), incremental maintenance beyond the forced flush, the hybrid
optimizer, tracing and the flight recorder.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import delta as delta_ops
from ..core import executor, ivf, maintenance, quantize
from ..core.query import QuerySpec, ResultSet
from ..core.types import (INVALID_ID, IVFConfig, IVFIndex,
                          normalize_if_cosine, resolve_device)
from ..kernels import ops
from .store import VectorStore


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
                 frame_pool=None):
        """`quantize="int8"` turns on the scalar-quantized tier: searches
        scan int8 codes and rerank `rerank_factor * k` candidates at
        float32; codes are durable in the SQLite `codes` table.

        `device` is where the index lives and the kernels run: None means
        "cuda" (raises without a GPU); pass "cpu" for the plain versions.
        Paged mode (`memory_budget_mb`, `frame_pool`) is not ported."""
        if memory_budget_mb is not None or frame_pool is not None:
            raise NotImplementedError(
                "paged mode is not ported yet (ROADMAP Queue A: paged mode)")
        self.device = resolve_device(device)
        self.lock = threading.RLock()
        self.store = VectorStore(path, dim=dim, n_attr=n_attr)
        cfg = config or IVFConfig(dim=dim)
        if quantize is not None:
            cfg = dataclasses.replace(cfg, quantize=quantize)
        if rerank_factor is not None:
            cfg = dataclasses.replace(cfg, rerank_factor=rerank_factor)
        self.config = cfg
        self.index: Optional[IVFIndex] = None

    # -- lifecycle -----------------------------------------------------------
    @_locked
    def build(self):
        """Initial clustering from the durable tier. With quantize="int8"
        the build trains the quantizer and persists codes + stats durably
        before the clustering swap (the crash ordering of the reference)."""
        ids, _, vecs = self.store.all_rows()
        attrs = self.store.attributes_for(ids)
        self.index = ivf.build_index(vecs, ids.astype(np.int32), attrs,
                                     cfg=self.config, device=self.device)
        self._persist_codes()
        assign = self._current_assignment()
        self.store.set_partitions(ids, assign[ids], *self._centroid_state())
        self._persist_maintenance_state()

    @_locked
    def recover(self):
        """Rebuild device state from SQLite after a crash/restart."""
        ids, parts, vecs = self.store.all_rows()
        attrs = self.store.attributes_for(ids)
        cents, csizes = self.store.centroids()
        if len(cents) == 0:
            self.index = None       # no durable clustering: no index
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

    def close(self):
        self.store.close()

    # -- writes ---------------------------------------------------------------
    @_locked
    def upsert(self, ids: np.ndarray, vecs: np.ndarray,
               attrs: Optional[np.ndarray] = None):
        n_attr = self.store.n_attr
        attrs = np.zeros((len(ids), n_attr), np.float32) if attrs is None \
            else attrs
        self.store.upsert(ids, vecs, attrs, partition_id=-1)
        if self.index is None:
            return
        self._delta_append(np.asarray(ids), np.asarray(vecs, np.float32),
                           np.asarray(attrs, np.float32))

    @_locked
    def delete(self, ids: np.ndarray):
        self.store.delete(ids)
        if self.index is None:
            return
        self.index = delta_ops.delete(
            self.index, torch.as_tensor(np.asarray(ids), dtype=torch.int32))

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
        with self.store.transaction():    # ONE durable transaction
            if len(up_ids):
                self.store.upsert(up_ids, up_vecs, up_attrs, partition_id=-1)
            if len(del_ids):
                self.store.delete(del_ids)
        if self.index is None:
            return
        if len(del_ids):
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
            self.index = delta_ops.upsert(
                self.index,
                torch.as_tensor(np.ascontiguousarray(vecs[s:e], np.float32)),
                torch.as_tensor(np.asarray(ids[s:e]).astype(np.int32)),
                torch.as_tensor(np.ascontiguousarray(attrs[s:e],
                                                     np.float32)))

    # -- maintenance ----------------------------------------------------------
    @_locked
    def maintain(self, force: Optional[str] = None):
        """The forced delta flush: fold every live delta row into its
        nearest partition (device-side; the durable rows stay in the
        pending partition until the next build, as in the reference's
        forced flush). Other maintenance is not ported yet."""
        if force != "flush":
            raise NotImplementedError(
                "only maintain(force='flush') is ported (ROADMAP Queue A: "
                "maintenance planning)")
        if self.index is None:
            return None
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
        idx = self.index
        if idx is None:
            raise RuntimeError("build() or recover() first")
        spec = QuerySpec() if spec is None else spec
        res = executor.run(idx, queries, spec)
        if spec.gather_attrs and self.store.n_attr:
            res.attrs = self._gather_attrs(res.to_numpy()[0])
        return res

    def query_batched(self, chunks: List[np.ndarray],
                      spec: Optional[QuerySpec] = None) -> List[ResultSet]:
        """Per-caller query chunks sharing ONE spec run as a single fused
        scan and come back split per caller, each equal to its solo
        query()."""
        idx = self.index
        if idx is None:
            raise RuntimeError("build() or recover() first")
        spec = QuerySpec() if spec is None else spec
        results = executor.run_coalesced(idx, chunks, spec)
        if spec.gather_attrs and self.store.n_attr:
            for rs in results:
                rs.attrs = self._gather_attrs(rs.to_numpy()[0])
        return results

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
        """Operational counters with the reference's resident keys (pager
        counters are zero in resident mode), plus the kernel launch
        counts of this process."""
        out = {"paged": False, "hits": 0, "misses": 0, "evictions": 0,
               "resident_bytes": 0, "budget_bytes": None,
               "device": str(self.device),
               "launches": ops.launch_counts()}
        idx = self.index
        if idx is None:
            return out
        resident = sum(t.numel() * t.element_size() for t in
                       (idx.vectors, idx.ids, idx.valid, idx.attrs))
        if idx.codes is not None:
            resident += idx.codes.numel()
        out["resident_bytes"] = int(resident)
        return out

    # -- helpers --------------------------------------------------------------
    def _persist_maintenance_state(self):
        """Mirror drift + the rebuild baseline into the store's meta table
        so recover() resumes them."""
        idx = self.index
        if idx is None:
            return
        drift = idx.drift.cpu().numpy().astype(np.float32) \
            if idx.drift is not None else np.zeros((idx.k,), np.float32)
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
