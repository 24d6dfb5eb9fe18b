"""Per-query trace spans and the maintenance event log (port of
repro.obs.trace; pure Python, the port's own copy).

`MicroNN.query(vecs, spec, trace=True)` (or `MicroNN.explain(vecs, spec)`)
activates a thread-local QueryTrace for that one query; every layer the
query flows through -- engine planner, executor probe/scan/rerank/merge,
pager fault path -- checks `trace.current()` and, when a trace is active,
records a named Span carrying wall time and work counters:

    plan          spec resolution (hybrid pre/post choice), kind, k
    probe         centroid probe: partitions in the probe union, n_probe
    pager_fault   paged only: frames hit/missed/staged-consumed, bytes
                  read from SQLite, summed over every chunk fault
    scan          the fused scan: partitions, rows, chunks, backend,
                  Q-bucket, the K1/K2 launches it made and the kernel
                  libraries it loaded (cache hit <=> compiled=0)
    rerank        quantized only: candidates, rows gathered
    merge         delta-merge epilogue
    queue_wait /  front-door requests only: admission latency and the
    split         coalesced-batch sub-span (callers, batch rows)

Kernels run asynchronously on the card, so while a trace is active the
executor synchronises the device at span boundaries (a span then measures
the work, not its launch); an untraced query never synchronises for it.

Tracing-off cost: `current()` is one module-bool test plus one
thread-local dict lookup; no span objects, dicts or registry entries are
allocated when no trace is active. `set_enabled(False)` is the global
kill-switch that makes every hook a no-op even under an activated trace;
it doubles as the baseline arm of the overhead measurement.

The engine owns a TraceRing: a bounded ring of the last N QueryTraces plus
the maintenance event log -- structured MaintEvents the scheduler emits
(work item planned, quantum executed, no-op plans, daemon errors) -- and a
slow-query log of traces above a latency threshold.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# -- canonical stage names (tests assert against these) ---------------------
STAGE_PLAN = "plan"
STAGE_PROBE = "probe"
STAGE_FAULT = "pager_fault"
STAGE_SCAN = "scan"
STAGE_RERANK = "rerank"
STAGE_MERGE = "merge"
STAGE_QUEUE = "queue_wait"
STAGE_SPLIT = "split"

# global kill-switch: False turns every hook into a no-op regardless of
# activated traces (the overhead benchmark's baseline arm)
_ENABLED = True

_tls = threading.local()


def set_enabled(flag: bool):
    global _ENABLED
    _ENABLED = bool(flag)


def enabled() -> bool:
    return _ENABLED


def current() -> Optional["QueryTrace"]:
    """The thread's active QueryTrace, or None (the hot-path check:
    one bool test + one dict lookup, no allocation)."""
    if not _ENABLED:
        return None
    return _tls.__dict__.get("active")


@contextlib.contextmanager
def activate(trace: "QueryTrace"):
    """Install `trace` as the thread's active trace for the block."""
    d = _tls.__dict__
    prev = d.get("active")
    d["active"] = trace
    try:
        yield trace
    finally:
        d["active"] = prev


@dataclasses.dataclass
class Span:
    """One named stage of a query: accumulated wall time + counters.
    Repeated record() calls with the same name ACCUMULATE (the paged
    fault span sums over every chunk fault): dur_ms and numeric counters
    add, string counters keep the latest value, `calls` counts the
    recordings."""

    name: str
    dur_ms: float = 0.0
    calls: int = 0
    counters: Dict[str, object] = dataclasses.field(default_factory=dict)

    def add(self, dur_ms: float, counters: Dict[str, object]):
        self.dur_ms += dur_ms
        self.calls += 1
        for k, v in counters.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                self.counters[k] = v
            else:
                self.counters[k] = self.counters.get(k, 0) + v

    def to_dict(self) -> Dict:
        return {"name": self.name, "dur_ms": self.dur_ms,
                "calls": self.calls, "counters": dict(self.counters)}


class QueryTrace:
    """The per-query record: ordered stage spans + identity fields.

    Created by MicroNN.query(trace=True) / explain() / the front door's
    traced submit; layers record into it through trace.current(). The
    front door additionally builds one per-caller trace per coalesced
    request that ADOPTS the shared fused-call spans and adds its own
    queue_wait/split sub-spans."""

    __slots__ = ("mode", "spec", "n_queries", "spans", "total_ms", "ts",
                 "result", "shared", "_t0")

    def __init__(self, mode: str = "resident", spec=None,
                 n_queries: int = 0):
        self.mode = mode            # "resident" | "paged"
        self.spec = spec            # resolved QuerySpec (set by the engine)
        self.n_queries = n_queries
        self.spans: Dict[str, Span] = {}    # insertion-ordered
        self.total_ms = 0.0
        self.ts = time.time()
        self.result = None          # ResultSet (explain() attaches it)
        self.shared = None          # fused-call trace (coalesced requests)
        self._t0 = time.perf_counter()

    # -- recording ----------------------------------------------------------
    def record(self, name: str, dur_ms: float = 0.0, **counters):
        span = self.spans.get(name)
        if span is None:
            span = Span(name)
            self.spans[name] = span
        span.add(dur_ms, counters)

    @contextlib.contextmanager
    def span(self, name: str, **counters):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.record(name, (time.perf_counter() - t0) * 1e3, **counters)

    def finish(self):
        self.total_ms = (time.perf_counter() - self._t0) * 1e3
        return self

    def adopt(self, other: "QueryTrace"):
        """Reference another trace's spans (the front door's per-caller
        traces adopt the shared fused-call spans -- no copying; the
        shared Span objects are read-only after the call completes)."""
        for name, span in other.spans.items():
            self.spans.setdefault(name, span)
        if self.spec is None:
            self.spec = other.spec
        self.shared = other

    # -- views --------------------------------------------------------------
    def get(self, name: str) -> Optional[Span]:
        return self.spans.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.spans

    @property
    def span_names(self) -> Tuple[str, ...]:
        return tuple(self.spans)

    def counter(self, span: str, key: str, default=0):
        s = self.spans.get(span)
        return default if s is None else s.counters.get(key, default)

    def to_dict(self) -> Dict:
        return {"mode": self.mode, "n_queries": self.n_queries,
                "total_ms": self.total_ms, "ts": self.ts,
                "spec": None if self.spec is None else repr(self.spec),
                "spans": [s.to_dict() for s in self.spans.values()]}

    def format(self) -> str:
        """Human-readable per-stage breakdown (what explain() prints)."""
        head = (f"QueryTrace mode={self.mode} q={self.n_queries} "
                f"total={self.total_ms:.2f}ms")
        if self.spec is not None:
            head += f"\n  spec: {self.spec!r}"
        rows = []
        for s in self.spans.values():
            kv = " ".join(f"{k}={v}" for k, v in s.counters.items())
            calls = f" x{s.calls}" if s.calls > 1 else ""
            rows.append(f"  {s.name:<12}{s.dur_ms:>9.3f}ms{calls}  {kv}")
        return "\n".join([head] + rows)

    def __repr__(self) -> str:
        return (f"QueryTrace(mode={self.mode!r}, q={self.n_queries}, "
                f"total_ms={self.total_ms:.2f}, "
                f"spans={list(self.spans)})")


@dataclasses.dataclass
class MaintEvent:
    """One structured maintenance event (the scheduler's event log):
    kind is "planned" (work item selected), "step" (quantum executed),
    "noop" (item planned to nothing and was skipped), or "daemon_error"
    (the daemon swallowed an exception)."""

    kind: str
    action: str = ""
    pids: Tuple[int, ...] = ()
    rows: int = 0
    bytes_written: int = 0
    dur_ms: float = 0.0
    error: str = ""
    daemon: bool = False
    ts: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class TraceRing:
    """Bounded ring of the last N records -- QueryTraces and MaintEvents
    share it (one timeline: a slow query next to the repair that caused
    it) -- plus the slow-query log: traces whose total_ms exceeded the
    threshold are ALSO kept in a separate small ring, so a latency spike
    survives long after the main ring has rotated past it."""

    def __init__(self, capacity: int = 256, slow_ms: float = 100.0,
                 slow_capacity: int = 64):
        assert capacity >= 1, capacity
        self.slow_ms = float(slow_ms)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._slow: deque = deque(maxlen=int(slow_capacity))

    def append(self, rec):
        with self._lock:
            self._ring.append(rec)
            if isinstance(rec, QueryTrace) and rec.total_ms >= self.slow_ms:
                self._slow.append(rec)

    def records(self, n: Optional[int] = None) -> List:
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def traces(self, n: Optional[int] = None) -> List[QueryTrace]:
        out = [r for r in self.records() if isinstance(r, QueryTrace)]
        return out if n is None else out[-n:]

    def events(self, n: Optional[int] = None) -> List[MaintEvent]:
        out = [r for r in self.records() if isinstance(r, MaintEvent)]
        return out if n is None else out[-n:]

    def slow(self) -> List[QueryTrace]:
        with self._lock:
            return list(self._slow)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._slow.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
