"""Budget-bounded frame pool of partition frames, shared by one or many
tenants (port of repro.fleet.pool).

F frames are preallocated on the device up front from the byte budget, in
the resident tier's padded layout, so the scan kernels run over the pool
with frame indices as their probe list:

    payload  [F, p_max, d]   int8 codes or f32 vectors
    ids      [F, p_max]      asset ids, INVALID_ID marks padding
    valid    [F, p_max]      live-row mask
    attrs    [F, p_max, a]   optional, for predicates
    norms    [F, p_max]      int8 pools only: ||decode(c)||^2 per row

F = budget_bytes // frame_bytes, and the pool never grows, so resident
bytes are at most the budget by construction. The int8 pool's norms frame
is the l2 constant the resident tier keeps beside its codes
(IVFIndex.code_norms), computed at fault time by the same
quantize.row_norms: the paged int8 scan then reads the very bits the
resident scan reads, instead of decoding in the kernel (a different
rounding), so paged and resident searches rank alike. Its 4 bytes a row
are counted in the frame size.

The frame table is host-side and keyed by (tenant, pid); tenants are
storage.pager.PartitionCache views registered with `register`. Eviction is
one global CLOCK with second chance across all tenants' frames. Faults
flagged `admit=False` (a one-off exact stream) cycle through a small scan
ring of at most `scan_frames` frames and never touch admitted frames'
reference bits. A fault pins its frames until the caller unpins them after
its scan; invalidating a pinned frame defers its release to the last
unpin. `stage` reads ahead into a host-side dict (no frames, no pins) that
the next fault consumes; a generation counter discards stages that raced
an invalidation. Every public method takes the pool's RLock.

Fault writes go in place: the fetched blocks are copied to the device
through pinned host buffers (asynchronously; torch's pinned-memory cache
does not hand a buffer out again before its copy has finished) and
`index_copy_`-ed into the victim frames on the device's current stream.
Scans run on the same stream, so a write into a frame is ordered after
every scan enqueued before it, and a pinned frame is never a victim.
The tenants' hit / miss / eviction / byte counters live in the metrics
registry (each view's `component=pager` scope); a fault leaves its own
breakdown in the view's `_last_fault` for the active trace's fault span.
Evictions are charged to (victim, evictor) pairs in a host matrix and in
`evictions_attributed` registry counters under this pool's
`component=frame_pool` scope, both bounded.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.types import INVALID_ID, resolve_device, to_device
from ..obs import metrics as obs_metrics

_PAYLOAD_DTYPE = {"f32": torch.float32, "int8": torch.int8}


def compute_frame_bytes(p_max: int, dim: int, payload: str = "f32",
                        n_attr: int = 0) -> int:
    """Bytes one partition frame costs: payload + ids + valid + attrs, and
    an int8 pool's norms."""
    if payload == "int8":
        per_row = dim + 4 + 1 + 4 * n_attr + 4
    else:
        per_row = 4 * dim + 4 + 1 + 4 * n_attr
    return p_max * per_row


class FramePool:
    """Budget-bounded pool of partition frames shared across tenants."""

    def __init__(self, *, dim: int, p_max: int, budget_bytes: int,
                 payload: str = "f32", n_attr: int = 0, device=None):
        if payload not in _PAYLOAD_DTYPE:
            raise ValueError(f"payload must be 'f32' or 'int8': {payload!r}")
        self.dim = int(dim)
        self.payload = payload
        self.n_attr = int(n_attr)
        self.budget_bytes = int(budget_bytes)
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        # tenant bookkeeping: name -> stable tid, tid -> live view, and
        # per-tenant pin / resident-frame accounting
        self._tid_by_name: Dict[str, int] = {}
        self._name_by_tid: Dict[int, str] = {}
        self._tenants: Dict[int, object] = {}
        self._tids = itertools.count()
        self._t_pins: Dict[int, int] = {}
        self._t_resident: Dict[int, int] = {}
        # noisy-neighbour attribution: evictions by (victim, evictor),
        # bounded at attr_max_pairs distinct pairs (overflow counted apart)
        self.attr_max_pairs = 4096
        self._evict_pairs: Dict[Tuple[int, int], int] = {}
        self._evict_pair_counters: Dict[Tuple[int, int], object] = {}
        self._evict_overflow = 0
        self._metrics = obs_metrics.default_registry().scope(
            component="frame_pool", inst=obs_metrics.next_instance())
        self._alloc(p_max)

    # -- registration --------------------------------------------------------
    def register(self, view, name: str, p_max: int) -> int:
        """Attach a tenant view; returns its tid. One pool = one frame
        geometry (payload, dim, attr width); a larger p_max grows the pool
        for everyone (dropping all frames, like any resize). Re-registering
        a name drops the old view's frames and rebinds the tid."""
        if view.payload != self.payload:
            raise ValueError(f"pool holds {self.payload} frames, tenant "
                             f"{name!r} wants {view.payload}")
        if view.store.dim != self.dim:
            raise ValueError(f"pool geometry is dim={self.dim}, tenant "
                             f"{name!r} has dim={view.store.dim}")
        n_attr = view.store.n_attr if view.with_attrs else 0
        if n_attr != self.n_attr:
            raise ValueError(f"pool geometry is n_attr={self.n_attr}, "
                             f"tenant {name!r} has n_attr={n_attr}")
        with self._lock:
            tid = self._tid_by_name.get(name)
            if tid is None:
                tid = next(self._tids)
                self._tid_by_name[name] = tid
                self._name_by_tid[tid] = name
            else:
                # re-attachment: the old view's frames describe an index
                # generation that no longer exists
                self._invalidate_tenant_locked(tid)
            self._tenants[tid] = view
            self._t_pins.setdefault(tid, 0)
            self._t_resident.setdefault(tid, 0)
        if p_max > self.p_max:
            self.resize(p_max)
        return tid

    # -- pool allocation ----------------------------------------------------
    def _alloc(self, p_max: int):
        # validate before mutating any state: a failed resize leaves the
        # pool usable at its old geometry
        frame_bytes = compute_frame_bytes(p_max, self.dim, self.payload,
                                          self.n_attr)
        cap = self.budget_bytes // frame_bytes
        if cap < 1:
            raise ValueError(
                f"memory budget {self.budget_bytes}B cannot seat one "
                f"partition frame ({frame_bytes}B at p_max={p_max})")
        self.p_max = int(p_max)
        self.frame_bytes = frame_bytes
        self.capacity = int(cap)
        dev = self.device
        self.payload_pool = torch.zeros(
            (self.capacity, self.p_max, self.dim),
            dtype=_PAYLOAD_DTYPE[self.payload], device=dev)
        self.ids_pool = torch.full((self.capacity, self.p_max), INVALID_ID,
                                   dtype=torch.int32, device=dev)
        self.valid_pool = torch.zeros((self.capacity, self.p_max),
                                      dtype=torch.bool, device=dev)
        self.attrs_pool = torch.zeros(
            (self.capacity, self.p_max, self.n_attr), dtype=torch.float32,
            device=dev) if self.n_attr else None
        self.norms_pool = torch.zeros(
            (self.capacity, self.p_max), dtype=torch.float32,
            device=dev) if self.payload == "int8" else None
        # host frame table: frame -> (tenant, partition)
        self._frame_pid = np.full(self.capacity, -1, np.int64)
        self._frame_tid = np.full(self.capacity, -1, np.int64)
        self._key_frame: Dict[Tuple[int, int], int] = {}
        self._ref = np.zeros(self.capacity, bool)
        self._pins = np.zeros(self.capacity, np.int64)
        # invalidated-while-pinned frames: freed at the last unpin
        self._stale = np.zeros(self.capacity, bool)
        self._hand = 0
        # scan-resistant admission: the ring of frames owned by one-off
        # stream faults; scan_frames bounds how much a full scan may dirty
        self.scan_frames = max(1, self.capacity // 4)
        self._transient = np.zeros(self.capacity, bool)
        self._ring: List[int] = []
        self._ring_hand = 0
        # read-ahead staging: (tid, pid) -> (payload, ids, valid, attrs)
        # host blocks; the generation lets invalidate()/resize() discard
        # stages still in flight
        self._staged: Dict[Tuple[int, int], tuple] = {}
        self._stage_gen = getattr(self, "_stage_gen", 0) + 1
        for tid in self._t_resident:
            self._t_resident[tid] = 0

    def resize(self, p_max: int):
        """Reallocate for a larger partition size. Drops every tenant's
        frames but keeps the budget and the counters. Waits for in-flight
        scans to unpin first (the pin table is rebuilt)."""
        deadline = time.monotonic() + 30.0
        while True:
            with self._lock:
                if not self._pins.any():
                    self._alloc(p_max)
                    return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "resize timed out waiting for pinned frames -- a scan "
                    "leaked a pin (missing unpin())")
            time.sleep(0.001)

    # -- budget accounting ---------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        pools = [self.payload_pool, self.ids_pool, self.valid_pool,
                 self.attrs_pool, self.norms_pool]
        return int(sum(p.numel() * p.element_size() for p in pools
                       if p is not None))

    def resident_count(self, tid: int) -> int:
        with self._lock:
            return self._t_resident.get(tid, 0)

    def pinned_count(self, tid: int) -> int:
        with self._lock:
            return self._t_pins.get(tid, 0)

    def _note_eviction(self, victim_tid: int, evictor_tid: int):
        """Charge one CLOCK eviction to (victim, evictor), with the pool
        lock held, on the fault's miss path only. The matrix folds pairs
        past `attr_max_pairs` into one overflow count; the registry's
        per-name series guard bounds the counters."""
        key = (victim_tid, evictor_tid)
        n = self._evict_pairs.get(key)
        if n is None and len(self._evict_pairs) >= self.attr_max_pairs:
            self._evict_overflow += 1
            return
        self._evict_pairs[key] = 1 if n is None else n + 1
        c = self._evict_pair_counters.get(key)
        if c is None:
            c = self._metrics.counter(
                "evictions_attributed",
                victim=self._name_by_tid.get(victim_tid, str(victim_tid)),
                evictor=self._name_by_tid.get(evictor_tid,
                                              str(evictor_tid)))
            self._evict_pair_counters[key] = c
        c.inc()

    def eviction_matrix(self) -> Dict[str, Dict[str, int]]:
        """victim name -> {evictor name -> evictions}."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for (vt, et), n in self._evict_pairs.items():
                v = self._name_by_tid.get(vt, str(vt))
                e = self._name_by_tid.get(et, str(et))
                out.setdefault(v, {})[e] = n
            return out

    def top_evictors(self, n: int = 5) -> List[dict]:
        """The heaviest (evictor, victim) pairs, most evictions first: the
        noisy-neighbour shortlist Fleet.health() reports."""
        with self._lock:
            pairs = sorted(self._evict_pairs.items(),
                           key=lambda kv: -kv[1])[:max(n, 0)]
            return [{"evictor": self._name_by_tid.get(et, str(et)),
                     "victim": self._name_by_tid.get(vt, str(vt)),
                     "evictions": c}
                    for (vt, et), c in pairs]

    def stats(self) -> dict:
        """Pool-wide view: geometry, per-tenant frames, eviction matrix."""
        with self._lock:
            by_name = {name: {"resident_frames":
                              self._t_resident.get(tid, 0),
                              "pinned_frames": self._t_pins.get(tid, 0)}
                       for name, tid in self._tid_by_name.items()}
            return {"budget_bytes": self.budget_bytes,
                    "resident_bytes": self.resident_bytes,
                    "capacity_frames": self.capacity,
                    "frame_bytes": self.frame_bytes,
                    "p_max": self.p_max,
                    "resident_partitions": len(self._key_frame),
                    "tenants": by_name,
                    "eviction_matrix": self.eviction_matrix(),
                    "eviction_matrix_overflow": self._evict_overflow}

    # -- clock eviction ------------------------------------------------------
    def _release_ring(self, f: int):
        """Remove a frame from the scan ring (promotion or reclaim)."""
        self._transient[f] = False
        if f in self._ring:
            self._ring.remove(f)
            self._ring_hand = 0

    def _clock_victim(self) -> int:
        """Second-chance sweep across all tenants' frames: skip pinned
        frames, clear reference bits, reclaim the first cold unpinned frame
        (ring frames carry no reference bit, so they fall out first)."""
        for _ in range(3 * self.capacity):
            f = self._hand
            self._hand = (self._hand + 1) % self.capacity
            if self._pins[f] > 0:
                continue
            if self._ref[f] and not self._transient[f]:
                self._ref[f] = False
                continue
            if self._transient[f]:
                self._release_ring(f)
            return f
        raise RuntimeError(
            "all cache frames pinned -- probe chunk exceeds pool capacity")

    def _victim(self) -> int:
        """Victim for an admitted fault: scan-ring frames first, then the
        CLOCK sweep."""
        for f in self._ring:
            if self._pins[f] == 0:
                self._release_ring(f)
                return f
        return self._clock_victim()

    def _scan_victim(self) -> int:
        """Victim for a non-admitted fault: reuse ring frames round-robin;
        grow the ring (through the sweep) only up to scan_frames."""
        for _ in range(len(self._ring)):
            f = self._ring[self._ring_hand % len(self._ring)]
            self._ring_hand += 1
            if self._pins[f] == 0:
                return f
        if len(self._ring) < self.scan_frames:
            f = self._clock_victim()
            self._ring.append(f)
            self._transient[f] = True
            return f
        raise RuntimeError(
            "scan ring exhausted -- chunk a non-admitted scan to at most "
            f"scan_frames={self.scan_frames} missing partitions")

    # -- staging -------------------------------------------------------------
    def stage(self, tid: int, pids: Sequence[int]):
        """Read ahead for one tenant: fetch and pack the listed partitions'
        host blocks so its next fault skips the SQL round-trip. Host work
        only: no frames, no pins, no device writes. Advisory: an
        invalidate() meanwhile discards the whole in-flight stage."""
        view = self._tenants[tid]
        with self._lock:
            gen = self._stage_gen
            want = [int(p) for p in pids
                    if (tid, int(p)) not in self._key_frame
                    and (tid, int(p)) not in self._staged]
        if not want:
            return
        payload, ids, valid, attrs = view._fetch_blocks(want)
        with self._lock:
            view._c_bytes_staged.inc(
                payload.nbytes + ids.nbytes + valid.nbytes
                + (0 if attrs is None else attrs.nbytes))
            if gen != self._stage_gen:
                return          # a writer invalidated mid-fetch: drop all
            # bound leftovers (a scan that raised never consumes its chunk)
            if len(self._staged) > 2 * self.capacity:
                self._staged.clear()
            for i, p in enumerate(want):
                if (tid, p) in self._key_frame:  # faulted while we fetched
                    continue
                self._staged[(tid, p)] = (payload[i], ids[i], valid[i],
                                          None if attrs is None
                                          else attrs[i])

    # -- fault / pin / invalidate -------------------------------------------
    def fault(self, tid: int, pids: Sequence[int],
              admit: bool = True) -> np.ndarray:
        """Seat every listed partition of tenant `tid`; returns the frame
        per pid (input order), each PINNED until the caller unpins it."""
        with self._lock:
            return self._fault_locked(tid, pids, admit)

    def _fault_locked(self, tid: int, pids: Sequence[int],
                      admit: bool) -> np.ndarray:
        view = self._tenants[tid]
        want = [int(p) for p in pids]
        if len(want) > self.capacity:
            raise ValueError(
                f"probe set of {len(want)} partitions exceeds the pool's "
                f"{self.capacity} frames -- chunk the scan")
        frames = np.empty(len(want), np.int32)
        missing = []
        hit_frames = []
        for j, p in enumerate(want):
            f = self._key_frame.get((tid, p))
            if f is not None:
                if admit:
                    self._ref[f] = True
                    if self._transient[f]:
                        # an admitted hit proves the frame hot: promote it
                        # out of the scan ring
                        self._release_ring(f)
                self._pins[f] += 1
                self._t_pins[tid] += 1
                frames[j] = f
                hit_frames.append(f)
            else:
                missing.append((j, p))
        if hit_frames:
            view._c_hits.inc(len(hit_frames))
        if not missing:
            view._last_fault = (len(hit_frames), 0, 0, 0)
            return frames
        new_frames = []
        n_evicted = 0
        for j, p in missing:
            f = self._victim() if admit else self._scan_victim()
            old_pid = int(self._frame_pid[f])
            if old_pid >= 0:
                old_tid = int(self._frame_tid[f])
                del self._key_frame[(old_tid, old_pid)]
                self._t_resident[old_tid] -= 1
                n_evicted += 1
                self._note_eviction(old_tid, tid)
            self._frame_pid[f] = p
            self._frame_tid[f] = tid
            self._key_frame[(tid, p)] = f
            self._t_resident[tid] += 1
            self._ref[f] = admit
            self._pins[f] += 1
            self._t_pins[tid] += 1
            frames[j] = f
            new_frames.append(f)
        # counted before the fetch: a failed fetch still paid the miss (and
        # already evicted its victims)
        view._c_misses.inc(len(missing))
        if n_evicted:
            view._c_evictions.inc(n_evicted)
        n_bytes = 0
        try:
            # staged read-ahead first; the rest in one SQL round-trip
            staged = {p: self._staged.pop((tid, p))
                      for _, p in missing if (tid, p) in self._staged}
            n_staged = len(staged)
            if n_staged:
                view._c_staged_consumed.inc(n_staged)
            fetch = [p for _, p in missing if p not in staged]
            if fetch:
                f_pay, f_ids, f_val, f_att = view._fetch_blocks(fetch)
                n_bytes = f_pay.nbytes + f_ids.nbytes + f_val.nbytes \
                    + (0 if f_att is None else f_att.nbytes)
                view._c_bytes_read.inc(n_bytes)
                for i, p in enumerate(fetch):
                    staged[p] = (f_pay[i], f_ids[i], f_val[i],
                                 None if f_att is None else f_att[i])
            self._write_frames(view, new_frames,
                               [staged[p] for _, p in missing])
        except BaseException:
            # roll back the provisional registrations: the frames never
            # received data, so a later fault must not count them as hits,
            # and no pin may leak (the caller gets no frames to unpin)
            for (j, p), f in zip(missing, new_frames):
                if self._key_frame.pop((tid, p), None) is not None:
                    self._t_resident[tid] -= 1
                self._frame_pid[f] = -1
                self._frame_tid[f] = -1
                self._ref[f] = False
                self._pins[f] -= 1
                self._t_pins[tid] -= 1
            for f in hit_frames:
                self._pins[f] -= 1
                self._t_pins[tid] -= 1
            raise
        view._last_fault = (len(hit_frames), len(missing), n_staged,
                            n_bytes)
        return frames

    def _write_frames(self, view, frames: List[int], entries: List[tuple]):
        """Copy fetched host blocks into the victim frames, in place."""
        dev = self.device
        fidx = to_device([np.asarray(frames, np.int64)], dev)[0]
        payload = to_device([e[0] for e in entries], dev)
        self.payload_pool.index_copy_(0, fidx, payload)
        self.ids_pool.index_copy_(0, fidx, to_device(
            [e[1] for e in entries], dev))
        self.valid_pool.index_copy_(0, fidx, to_device(
            [e[2] for e in entries], dev))
        if self.attrs_pool is not None:
            self.attrs_pool.index_copy_(0, fidx, to_device(
                [e[3] for e in entries], dev))
        if self.norms_pool is not None:
            self.norms_pool.index_copy_(0, fidx, view.frame_norms(payload))

    def _free_frame(self, f: int):
        self._frame_pid[f] = -1
        self._frame_tid[f] = -1
        self._ref[f] = False
        self._stale[f] = False

    def unpin(self, frames: np.ndarray):
        with self._lock:
            for f in np.asarray(frames, np.int64):
                if self._pins[f] <= 0:
                    raise RuntimeError(f"frame {f} is not pinned")
                self._pins[f] -= 1
                tid = int(self._frame_tid[f])
                if tid >= 0:
                    self._t_pins[tid] -= 1
                if self._pins[f] == 0 and self._stale[f]:
                    # invalidated while a scan read it: released now
                    self._free_frame(f)

    def invalidate(self, tid: int, pids: Sequence[int]):
        """Drop one tenant's listed frames (durable rows changed); the next
        fault re-reads them. A pinned frame is released at its last unpin:
        the scan keeps its snapshot, the mapping is gone at once."""
        with self._lock:
            # discard staged blocks of the changed partitions, and bump the
            # generation so a stage() in flight drops its whole batch
            self._stage_gen += 1
            for p in pids:
                self._staged.pop((tid, int(p)), None)
                f = self._key_frame.pop((tid, int(p)), None)
                if f is None:
                    continue
                self._t_resident[tid] -= 1
                if self._pins[f] > 0:
                    self._stale[f] = True
                    continue
                self._free_frame(f)

    def _invalidate_tenant_locked(self, tid: int):
        self.invalidate(tid, [p for (t, p) in list(self._key_frame)
                              if t == tid])
        self._staged = {k: v for k, v in self._staged.items()
                        if k[0] != tid}

    def invalidate_tenant(self, tid: int):
        """Drop every frame and staged block of one tenant (a spill, a
        close or a rebuild)."""
        with self._lock:
            self._invalidate_tenant_locked(tid)

    # -- per-tenant views ----------------------------------------------------
    def tenant_frames(self, tid: int) -> Dict[int, int]:
        """pid -> frame for one tenant."""
        with self._lock:
            return {p: f for (t, p), f in self._key_frame.items()
                    if t == tid}

    def tenant_staged(self, tid: int) -> Dict[int, tuple]:
        with self._lock:
            return {p: v for (t, p), v in self._staged.items()
                    if t == tid}
