"""Disk-resident partition pager: an engine's view of a memory-budgeted
frame pool (port of repro.storage.pager; the paper's "~10 MB resident at
million scale").

The pool mechanics -- preallocated device frames, CLOCK eviction, the
scan-resistant admission ring, pins, read-ahead staging, the in-place
fault write -- live in `fleet.pool.FramePool`, keyed by (tenant, pid), so
several engines may share one pool under one budget. `PartitionCache` is
the per-tenant view an engine holds: it owns the fetch path (its
VectorStore, metric normalisation, quantizer stats, the int8 pool's norms)
and the tenant's cumulative counters, and delegates frames, eviction and
pins to the pool. A solo engine builds a private single-tenant pool.

Fault path: every missing partition of a probe chunk is fetched in ONE SQL
round-trip (VectorStore.scan_partitions) and written into the pool in one
batch. Float32 frames hold metric-normalised rows, normalised on the host
by the same torch op recover() uses for the resident tier. Int8 frames
skip the float32 blobs; a row without a durable code is backfilled from
the float32 tier with the build's deterministic encode, and each faulted
int8 frame gets its norms from quantize.row_norms on the device.

Invalidation contract: any write that changes a partition's durable rows
(a flush into it, an upsert or delete of one of its rows) must call
invalidate(pids); the next fault re-reads the partition. A rebuild
attaches a new view, whose registration drops the tenant's frames.
Counters (hits, misses, evictions, bytes read and staged) are cumulative
metrics-registry counters under the engine's `component=pager` scope, so a
re-attached view (a paged rebuild) keeps its series; MicroNN.stats() reads
them. With a trace active, every fault records the `pager_fault` span,
whose counters equal the registry deltas of the call.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import quantize
from ..core.types import normalize_rows
from ..fleet.pool import FramePool
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

_COUNTERS = ("hits", "misses", "evictions", "bytes_read", "bytes_staged",
             "staged_consumed")


class PartitionCache:
    """Per-tenant view over a FramePool of partition frames.

    Solo mode (pool=None): a private single-tenant pool on `device` sized
    from `budget_bytes`. Shared mode: pass the `pool` and a stable
    `tenant` name; frames then compete under the pool's budget."""

    def __init__(self, store, *, p_max: int, budget_bytes: int,
                 payload: str = "f32", metric: str = "l2", qstats=None,
                 with_attrs: bool = False, metrics=None,
                 pool: Optional[FramePool] = None,
                 tenant: Optional[str] = None, device=None):
        if payload not in ("f32", "int8"):
            raise ValueError(f"payload must be 'f32' or 'int8': {payload!r}")
        if payload == "int8" and qstats is None:
            raise ValueError("int8 frames need quantizer stats")
        self.store = store
        self.metric = metric
        self.payload = payload
        self.qstats = qstats
        self.with_attrs = bool(with_attrs and store.n_attr)
        # cumulative counters (the pool bumps them under its lock). The
        # engine passes its own scope, so a re-attached view gets the same
        # counter objects back; a standalone cache starts at zero under a
        # fresh instance label.
        if metrics is None:
            metrics = obs_metrics.default_registry().scope(
                component="pager", inst=str(obs_metrics.next_instance()))
        self._metrics = metrics
        for name in _COUNTERS:
            setattr(self, f"_c_{name}", metrics.counter(name))
        # the last fault's (hits, misses, staged frames consumed, bytes
        # read), for the active trace's fault span
        self._last_fault = (0, 0, 0, 0)
        self._private_pool = pool is None
        if pool is None:
            pool = FramePool(
                dim=store.dim, p_max=p_max, budget_bytes=budget_bytes,
                payload=payload,
                n_attr=store.n_attr if self.with_attrs else 0,
                device=device)
            tenant = "solo" if tenant is None else tenant
        elif tenant is None:
            raise ValueError("a shared FramePool view needs a stable tenant "
                             "name")
        self._pool = pool
        self.tenant = str(tenant)
        self._tid = pool.register(self, self.tenant, p_max=p_max)

    # -- cumulative counters (registry-backed; plain ints out) ---------------
    @property
    def hits(self) -> int:
        return self._c_hits.value

    @property
    def misses(self) -> int:
        return self._c_misses.value

    @property
    def evictions(self) -> int:
        return self._c_evictions.value

    @property
    def bytes_read(self) -> int:
        return self._c_bytes_read.value

    @property
    def bytes_staged(self) -> int:
        return self._c_bytes_staged.value

    @property
    def staged_consumed(self) -> int:
        return self._c_staged_consumed.value

    # -- pool geometry (delegated) -------------------------------------------
    @property
    def budget_bytes(self) -> int:
        return self._pool.budget_bytes

    @property
    def p_max(self) -> int:
        return self._pool.p_max

    @property
    def frame_bytes(self) -> int:
        return self._pool.frame_bytes

    @property
    def capacity(self) -> int:
        return self._pool.capacity

    @property
    def scan_frames(self) -> int:
        return self._pool.scan_frames

    @property
    def payload_pool(self) -> torch.Tensor:
        return self._pool.payload_pool

    @property
    def ids_pool(self) -> torch.Tensor:
        return self._pool.ids_pool

    @property
    def valid_pool(self) -> torch.Tensor:
        return self._pool.valid_pool

    @property
    def attrs_pool(self) -> Optional[torch.Tensor]:
        return self._pool.attrs_pool

    @property
    def norms_pool(self) -> Optional[torch.Tensor]:
        return self._pool.norms_pool

    @property
    def resident_bytes(self) -> int:
        return self._pool.resident_bytes

    # -- frame-table views (tests + introspection; the pool holds the truth)
    @property
    def _pid_frame(self) -> dict:
        return self._pool.tenant_frames(self._tid)

    @property
    def _staged(self) -> dict:
        return self._pool.tenant_staged(self._tid)

    @property
    def _frame_pid(self) -> np.ndarray:
        return self._pool._frame_pid

    @property
    def _pins(self) -> np.ndarray:
        return self._pool._pins

    @property
    def _stale(self) -> np.ndarray:
        return self._pool._stale

    @property
    def _transient(self) -> np.ndarray:
        return self._pool._transient

    @property
    def _ring(self) -> list:
        return self._pool._ring

    def resize(self, p_max: int):
        """Reallocate the pool for a larger partition size (a flush grew a
        partition past p_max). Drops every frame, keeps the counters and
        the budget. A shared pool only grows."""
        if not self._private_pool:
            p_max = max(int(p_max), self._pool.p_max)
        self._pool.resize(p_max)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "bytes_read": self.bytes_read,
                "bytes_staged": self.bytes_staged,
                "staged_consumed": self.staged_consumed,
                "resident_bytes": self.resident_bytes,
                "budget_bytes": self.budget_bytes,
                "capacity_frames": self.capacity,
                "frame_bytes": self.frame_bytes,
                "resident_partitions": self._pool.resident_count(self._tid)}

    # -- fetch ---------------------------------------------------------------
    def _fetch_blocks(self, pids: Sequence[int]):
        """One batched SQL round-trip for the listed partitions, packed to
        the pool's layout on the host: (payload, ids, valid, attrs) numpy
        blocks of shape [len(pids), p_max, ...] (attrs None without an
        attrs pool). Pure read: no pool, frame table or counter is touched,
        so stage() may run it off the lock."""
        sq = self.payload == "int8"
        blocks = self.store.scan_partitions(
            list(pids), self.p_max,
            with_codes=sq, with_attrs=self.with_attrs, with_vecs=not sq)
        if sq:
            payload = blocks.codes
            stale = blocks.valid & ~blocks.code_ok
            if stale.any():
                # rare: rows without a durable code -- re-encode them from
                # the float32 tier
                rows, _ = self.store.vectors_for(blocks.ids[stale])
                payload[stale] = quantize.encode_np(
                    self.qstats, normalize_rows(rows, self.metric))
        else:
            payload = normalize_rows(blocks.vecs, self.metric)
        attrs = blocks.attrs if self.with_attrs else None
        return payload, blocks.ids, blocks.valid, attrs

    def frame_norms(self, codes: torch.Tensor) -> torch.Tensor:
        """[m, p_max, d] int8 frames on the device -> [m, p_max] norms, the
        resident tier's code_norms for the same rows, bit for bit. A fault
        may fill the whole pool at once, so the rows are decoded in chunks
        of a quarter of the budget's bytes as float32: the norms' scratch
        stays under the budget (decoding every frame at once took 8 times
        the pool's int8 bytes)."""
        rows = max(1, self.budget_bytes // (16 * codes.shape[-1]))
        return quantize.row_norms(self.qstats, codes, chunk_rows=rows)

    def stage(self, pids: Sequence[int]):
        """Read ahead: fetch and pack the listed partitions' host blocks so
        the next fault() skips its SQL round-trip. Takes no frames and no
        pins; advisory (an invalidate() meanwhile discards it)."""
        self._pool.stage(self._tid, pids)

    # -- fault / pin / invalidate -------------------------------------------
    def fault(self, pids: Sequence[int], admit: bool = True) -> np.ndarray:
        """Seat every listed partition; returns the frame per pid (input
        order), each PINNED -- the caller unpins after its scan. `admit=
        False` marks a one-off stream (paged exact): misses land in the
        scan ring and hits leave reference bits alone. The fault is the
        `pager_fault` stage; with a trace active its counters are read
        under the pool lock, so they are this fault's alone. The frame
        writes it enqueues are not waited for."""
        with obs_trace.stage(obs_trace.STAGE_FAULT) as span:
            if not span:
                return self._pool.fault(self._tid, pids, admit)
            with self._pool._lock:
                frames = self._pool.fault(self._tid, pids, admit)
                h, m, st, nb = self._last_fault
            span.note(hits=h, misses=m, staged=st, bytes_read=nb,
                      admitted=bool(admit))
        return frames

    def unpin(self, frames: np.ndarray):
        self._pool.unpin(frames)

    def invalidate(self, pids: Sequence[int]):
        """Drop the listed partitions' frames (durable rows changed)."""
        self._pool.invalidate(self._tid, pids)

    def invalidate_all(self):
        """Drop every frame this tenant holds (a fleet spill)."""
        self._pool.invalidate_tenant(self._tid)
