"""Concurrent serving front door for MicroNN (port of
repro.serving.frontdoor): admission queue, cross-request micro-batching,
and daemonized maintenance.

    eng = MicroNN(dim=128, path="db.sqlite")
    ...build...
    with FrontDoor(eng, maintenance=True) as fd:
        rs = fd.query(vec, Q.knn(k=10))        # any thread, blocking
        fut = fd.submit(vec, Q.knn(k=10))      # ... or async via a Future

Three mechanisms:

  * **Admission queue.** Caller threads `submit()` `(vecs, spec)` pairs
    and block on a `concurrent.futures.Future`; one dispatcher thread owns
    execution, so query-side work is serialised without locking the
    engine.

  * **Cross-request micro-batching.** Within a bounded window (`window_s`,
    default 2 ms) the dispatcher drains the queue and coalesces SAME-spec
    requests into one fused call through `MicroNN.query_batched` ->
    `executor.run_coalesced`: the chunks concatenate, the executor pads to
    the Q bucket and runs ONE fused K1 / K2 scan, and `ResultSet.split`
    hands each caller its own rows back. A query's scores do not depend on
    its batch (each query masks onto its own probes inside the shared
    union, and the kernels' fixed reduction trees give a row the same bits
    in any batch), so every caller's slice is bit-identical (ids + scores)
    to the solo `query()` it replaced. On the CPU's "torch" backend a
    bucket of at most 8 queries takes the gather plan, so there the
    equality holds while the solo and the coalesced calls land on the same
    plan. Distinct specs in one drain each get their own fused call;
    `max_batch_rows` caps a fused call's rows.

  * **Daemonized maintenance.** `maintenance=True` runs the engine's
    `MaintenanceScheduler` as a daemon thread that takes bounded quanta
    while this queue is idle, each under the engine's write mutex
    (`MicroNN.lock`), so sessions, upserts and repairs serialise while
    reads proceed against consistent snapshots (the resident index is
    replaced, never edited, by maintenance; the pager's RLock defers the
    release of pinned frames; the store's WAL snapshot read connection).

Consistency note: when the store has no snapshot read connection
(`:memory:` databases are private to one connection), the dispatcher runs
paged and attr-gathering queries under the engine's write mutex: a read on
the shared connection could otherwise observe another thread's open
transaction. File-backed stores keep reads unserialised.

Observability: queue-wait / execute / total latencies are registry
histograms under this front door's scope, and `stats()` derives its keys
from them. Traced submits (`submit(..., trace=True)`) get a per-caller
QueryTrace with the request's own queue_wait and its slice of the
coalesced batch (`split`), which then ADOPTS the shared fused-call trace
the dispatcher recorded, so N coalesced callers each see the one fused
scan they shared.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from ..core.query import QuerySpec, ResultSet
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..obs import trace as obs_trace

_STAT_KEYS = ("queued", "inflight", "submitted", "completed", "failed",
              "coalesced", "batches", "solo", "batch_occupancy",
              "queue_wait_p50_ms", "queue_wait_p99_ms",
              "execute_p50_ms", "execute_p99_ms",
              "total_p50_ms", "total_p99_ms",
              "window_ms", "arrival_ewma_ms")

_FLOAT_KEYS = ("batch_occupancy", "window_ms", "arrival_ewma_ms")


def empty_stats() -> Dict:
    """The zeroed counter dict MicroNN.stats() reports when no front
    door is attached -- same keys as FrontDoor.stats(), so dashboards
    and tests read one uniform shape in every mode."""
    return {k: 0 if k not in _FLOAT_KEYS else 0.0 for k in _STAT_KEYS}


@dataclasses.dataclass
class _Request:
    """One admitted query: the caller blocks on `future`."""

    vecs: np.ndarray          # [q, d] float32 (q >= 1 rows)
    spec: QuerySpec
    future: Future
    t_submit: float           # monotonic seconds at admission
    n: int                    # rows (q)
    trace: Optional[obs_trace.QueryTrace] = None   # traced submit


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """Serving knobs (all times in seconds).

    window_s         micro-batching window: after the first request is
                     seen the dispatcher waits up to this long for more
                     same-spec arrivals before executing (0 disables
                     coalescing -- every request executes alone, the
                     one-request-at-a-time baseline)
    max_batch_rows   cap on one fused call's total query rows; a drain
                     larger than this executes in several fused calls
                     (bounds bucket padding and per-call latency)
    maintenance      start the engine's maintenance scheduler as a
                     daemon thread, draining quanta while this queue is
                     idle
    daemon_interval_s  the daemon's poll cadence
    adaptive_window  size the coalescing window from the OBSERVED
                     arrival rate instead of the fixed window_s: an
                     EWMA of inter-arrival gaps picks the wait that
                     coalesces ~coalesce_target requests, clamped to
                     [0, window_s] -- sparse traffic pays ~zero added
                     latency (window collapses to 0 when the next
                     arrival is unlikely inside window_s), dense
                     traffic still batches up to the cap
    coalesce_target  requests the adaptive window aims to coalesce
                     per fused call (the EWMA gap multiplier)
    """

    window_s: float = 0.002
    max_batch_rows: int = 64
    maintenance: bool = False
    daemon_interval_s: float = 0.002
    adaptive_window: bool = False
    coalesce_target: int = 8


class FrontDoor:
    """Admission queue + micro-batching dispatcher over one MicroNN."""

    def __init__(self, engine, config: Optional[FrontDoorConfig] = None,
                 **overrides):
        """`FrontDoor(eng)` with defaults, or pass a FrontDoorConfig /
        kwarg overrides (`FrontDoor(eng, window_s=0.005,
        maintenance=True)`)."""
        cfg = config or FrontDoorConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.engine = engine
        self.config = cfg
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._closed = False
        self._inflight = 0          # requests handed to the executor
        # -- registry metrics ----------------------------------------------
        # Each front door gets its own `fd` instance label: a closed and
        # re-opened front door on the same engine starts its serving
        # counters at zero (stats() is per-front-door, not cumulative
        # across attachments), while still living in the ONE process
        # registry for snapshot()/to_prometheus().
        base = getattr(engine, "metrics", None)
        if base is None:
            base = obs_metrics.default_registry().scope(
                inst=obs_metrics.next_instance())
        metrics = base.scope(component="frontdoor",
                             fd=obs_metrics.next_instance())
        self.metrics = metrics
        self._c_submitted = metrics.counter("submitted")
        self._c_completed = metrics.counter("completed")
        self._c_failed = metrics.counter("failed")
        self._c_coalesced = metrics.counter("coalesced")
        self._c_batches = metrics.counter("batches")
        self._c_solo = metrics.counter("solo")
        self._c_occupancy = metrics.counter("batch_occupancy_sum")
        self._h_wait = metrics.histogram("queue_wait_s")
        self._h_exec = metrics.histogram("execute_s")
        self._h_total = metrics.histogram("total_s")
        # adaptive coalescing window: EWMA of inter-arrival gaps
        # observed at submit(), and the effective window the dispatcher
        # last used -- both surfaced as registry gauges + stats() keys
        self._ewma_gap_s: Optional[float] = None
        self._last_arrival_s: Optional[float] = None
        self._window_s = cfg.window_s
        self._g_window = metrics.gauge("window_s")
        self._g_window.set(cfg.window_s)
        self._g_ewma = metrics.gauge("arrival_ewma_s")
        # -- threads -------------------------------------------------------
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="micronn-frontdoor",
            daemon=True)
        self._dispatcher.start()
        self._owns_daemon = False
        if cfg.maintenance:
            engine.scheduler.start_daemon(
                idle=self.queue_idle, interval_s=cfg.daemon_interval_s)
            self._owns_daemon = True
        engine._frontdoor = self

    # -- client API ----------------------------------------------------------
    def submit(self, vecs: np.ndarray,
               spec: Optional[QuerySpec] = None, *,
               trace: bool = False) -> Future:
        """Admit one query (a [q, d] batch or a single [d] vector) and
        return a Future resolving to its ResultSet. Thread-safe.

        `trace=True` attaches a per-caller QueryTrace to the resolved
        ResultSet (`rs.trace`): the caller's own queue_wait + its slice
        of the coalesced batch, adopting the shared fused-call spans."""
        spec = QuerySpec() if spec is None else spec
        v = np.atleast_2d(np.asarray(vecs, np.float32))
        # flight-recorder hook: one global load + branch when recording
        # is off. Captured at admission (the Future has not resolved, so no
        # result digest -- replay double-executes these)
        rec = obs_recorder._ACTIVE
        if rec is not None:
            rec.record(obs_recorder.SITE_FRONTDOOR, self.engine.tenant,
                       v, spec)
        tr = None
        if trace and obs_trace.enabled():
            tr = obs_trace.QueryTrace(
                mode="paged" if self.engine.paged else "resident")
            tr.n_queries = int(v.shape[0])
        req = _Request(vecs=v, spec=spec, future=Future(),
                       t_submit=time.monotonic(), n=int(v.shape[0]),
                       trace=tr)
        with self._cv:
            if self._closed:
                raise RuntimeError("FrontDoor is closed")
            self._queue.append(req)
            self._c_submitted.inc()
            if self.config.adaptive_window:
                # EWMA of inter-arrival gaps (alpha=0.2): the signal the
                # dispatcher sizes its coalescing window from
                last = self._last_arrival_s
                if last is not None:
                    gap = req.t_submit - last
                    e = self._ewma_gap_s
                    self._ewma_gap_s = gap if e is None \
                        else 0.2 * gap + 0.8 * e
                    self._g_ewma.set(self._ewma_gap_s)
                self._last_arrival_s = req.t_submit
            self._cv.notify_all()
        return req.future

    def submit_async(self, vecs: np.ndarray,
                     spec: Optional[QuerySpec] = None, *,
                     trace: bool = False) -> "asyncio.Future":
        """`submit()` for asyncio callers: the same admission queue and
        coalescing, returned as an awaitable asyncio Future bound to the
        RUNNING event loop (call from a coroutine / loop context). The
        dispatcher thread resolves the underlying concurrent Future and
        asyncio marshals the result back onto the loop -- no thread may
        block the loop, so one async server task per request coalesces
        exactly like N caller threads would."""
        import asyncio
        return asyncio.wrap_future(self.submit(vecs, spec, trace=trace))

    async def query_async(self, vecs: np.ndarray,
                          spec: Optional[QuerySpec] = None, *,
                          trace: bool = False) -> ResultSet:
        """Awaitable `query()`: the drop-in replacement for
        `engine.query(vecs, spec)` inside a coroutine."""
        return await self.submit_async(vecs, spec, trace=trace)

    def query(self, vecs: np.ndarray, spec: Optional[QuerySpec] = None,
              timeout: Optional[float] = None, *,
              trace: bool = False) -> ResultSet:
        """Blocking submit: the drop-in replacement for
        `engine.query(vecs, spec)` from any caller thread."""
        return self.submit(vecs, spec, trace=trace).result(timeout)

    def queue_idle(self) -> bool:
        """True when no request is queued or executing -- the daemon
        scheduler's back-pressure probe."""
        return not self._queue and self._inflight == 0

    def drain(self, timeout: float = 10.0):
        """Block until every admitted request has completed (test/bench
        quiesce point)."""
        deadline = time.monotonic() + timeout
        while not self.queue_idle():
            if time.monotonic() > deadline:
                raise TimeoutError("front door did not drain in time")
            time.sleep(0.0005)

    def close(self, timeout: float = 10.0):
        """Stop the dispatcher (after finishing queued requests) and the
        maintenance daemon this front door started. Idempotent."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._cv.notify_all()
        self._dispatcher.join(timeout)
        if self._owns_daemon:
            self.engine.scheduler.stop_daemon()
        if getattr(self.engine, "_frontdoor", None) is self:
            self.engine._frontdoor = None

    def __enter__(self) -> "FrontDoor":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- dispatcher ----------------------------------------------------------
    def _effective_window(self) -> float:
        """The coalescing wait for this drain. Fixed mode: window_s.
        Adaptive mode: enough EWMA inter-arrival gaps to gather
        ~coalesce_target requests, clamped to [0, window_s] -- and 0
        outright when even ONE more arrival is unlikely inside window_s
        (waiting would add latency and coalesce nothing)."""
        cfg = self.config
        if not cfg.adaptive_window:
            return cfg.window_s
        gap = self._ewma_gap_s
        if gap is None:                 # no signal yet: fixed behavior
            w = cfg.window_s
        elif gap >= cfg.window_s:
            w = 0.0
        else:
            w = min(cfg.window_s,
                    gap * max(cfg.coalesce_target - 1, 1))
        self._window_s = w
        self._g_window.set(w)
        return w

    def _dispatch_loop(self):
        cfg = self.config
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
                # micro-batching window: wait (woken per arrival) until
                # the window closes or enough rows queued for a full call
                window = self._effective_window() if cfg.window_s > 0 \
                    else 0.0
                if window > 0:
                    deadline = time.monotonic() + window
                    while not self._stop:
                        if sum(r.n for r in self._queue) \
                                >= cfg.max_batch_rows:
                            break
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                batch = list(self._queue)
                self._queue.clear()
                self._inflight += len(batch)
            # group by spec (frozen and hashable), preserving arrival order
            # within each group
            groups: Dict[QuerySpec, List[_Request]] = {}
            for r in batch:
                groups.setdefault(r.spec, []).append(r)
            for spec, reqs in groups.items():
                # cap fused-call size: chunk the group at max_batch_rows
                start, rows = 0, 0
                for i, r in enumerate(reqs):
                    if rows and rows + r.n > cfg.max_batch_rows:
                        self._execute(spec, reqs[start:i])
                        start, rows = i, 0
                    rows += r.n
                self._execute(spec, reqs[start:])

    def _exec_guard(self, spec: QuerySpec):
        """Serialize execution against writers ONLY when reads cannot be
        snapshot-isolated: an in-memory store shares one connection, so
        paged faults / attr gathers there must not observe an open write
        transaction. File-backed stores read through the WAL snapshot
        connection and need no lock."""
        eng = self.engine
        if not eng.store.snapshot_reads and (eng.paged or spec.gather_attrs):
            return eng.lock
        return contextlib.nullcontext()

    def _execute(self, spec: QuerySpec, reqs: List[_Request]):
        if not reqs:
            return
        # Any traced caller in the batch? Record ONE shared trace around
        # the fused call (activated thread-locally on this dispatcher
        # thread, so the plan/probe/fault/scan spans every layer records
        # land in it), then hand each traced caller a per-caller view.
        shared = None
        if obs_trace.enabled() and any(r.trace is not None for r in reqs):
            shared = obs_trace.QueryTrace(
                mode="paged" if self.engine.paged else "resident")
        t0 = time.monotonic()
        try:
            with self._exec_guard(spec), obs_trace.activate(shared):
                if len(reqs) == 1:
                    results = [self.engine.query(reqs[0].vecs, spec)]
                else:
                    results = self.engine.query_batched(
                        [r.vecs for r in reqs], spec)
        except BaseException as e:  # noqa: BLE001 -- fail the callers
            self._c_failed.inc(len(reqs))
            for r in reqs:
                r.future.set_exception(e)
            with self._cv:
                self._inflight -= len(reqs)
            return
        t1 = time.monotonic()
        if shared is not None:
            shared.finish()
        if len(reqs) > 1:
            self._c_batches.inc()
            self._c_coalesced.inc(len(reqs))
            self._c_occupancy.inc(len(reqs))
        else:
            self._c_solo.inc()
        self._c_completed.inc(len(reqs))
        for r in reqs:
            self._h_wait.observe(t0 - r.t_submit)
            self._h_exec.observe(t1 - t0)
            self._h_total.observe(t1 - r.t_submit)
        ring = getattr(self.engine, "traces", None)
        for r, rs in zip(reqs, results):
            if r.trace is not None and shared is not None:
                tr = r.trace
                tr.record(obs_trace.STAGE_QUEUE,
                          (t0 - r.t_submit) * 1e3, rows=r.n)
                if len(reqs) > 1:
                    tr.record(obs_trace.STAGE_SPLIT, 0.0,
                              callers=len(reqs), rows=r.n,
                              batch_rows=sum(x.n for x in reqs))
                tr.adopt(shared)
                tr.finish()
                tr.refer(rs)
                rs.trace = tr
                if ring is not None:
                    ring.append(tr)
            r.future.set_result(rs)
        with self._cv:
            self._inflight -= len(reqs)
        # queue just (possibly) went idle: let the maintenance daemon
        # use the gap rather than waiting out its poll interval
        if self._owns_daemon and self.queue_idle():
            self.engine.scheduler.kick()

    # -- observability --------------------------------------------------------
    def stats(self) -> Dict:
        """Serving counters + latency percentiles (ms). Keys match
        empty_stats(); MicroNN.stats() embeds this dict under
        "frontdoor", so resident and paged engines report uniformly.
        All values are derived views over this front door's registry
        series (one source of truth for stats(), BENCH snapshots, and
        the Prometheus exporter)."""
        batches = self._c_batches.value
        out = {
            "queued": len(self._queue),
            "inflight": self._inflight,
            "submitted": self._c_submitted.value,
            "completed": self._c_completed.value,
            "failed": self._c_failed.value,
            "coalesced": self._c_coalesced.value,
            "batches": batches,
            "solo": self._c_solo.value,
            "batch_occupancy": (self._c_occupancy.value / batches)
            if batches else 0.0,
        }
        for name, h in (("queue_wait", self._h_wait),
                        ("execute", self._h_exec),
                        ("total", self._h_total)):
            out[f"{name}_p50_ms"] = h.quantile(0.50) * 1e3
            out[f"{name}_p99_ms"] = h.quantile(0.99) * 1e3
        out["window_ms"] = self._window_s * 1e3
        out["arrival_ewma_ms"] = (self._ewma_gap_s or 0.0) * 1e3
        return out
