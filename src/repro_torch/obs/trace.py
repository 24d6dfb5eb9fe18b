"""Per-query trace spans and the maintenance event log (port of
repro.obs.trace; the port's own copy).

`MicroNN.query(vecs, spec, trace=True)` (or `MicroNN.explain(vecs, spec)`)
activates a thread-local QueryTrace for that one query; every layer the
query flows through -- engine planner, executor probe/scan/rerank/merge,
pager fault path -- wraps its work in `stage(name)`, which, when a trace
is active, adds the block's host wall time and work counters to the
named Span:

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

`MicroNN.build()` records its own stages the same way (BUILD_STAGES) and
keeps them in the engine's `stage_s{action="build"}` histograms and one
MaintEvent of kind "build". A write session, and an upsert, record the
same way under a write trace: the session's durable transaction
("commit") and each inline delta flush ("flush") into the engine's
`stage_s{action="write"}` histograms.

A stage never waits for the device. Kernels run asynchronously on the
card, so a span is the host time of its stage: a stage's device work
that no later host step waits for is not in it, and where a stage waits
(a copy to the host), the wait covers the earlier stages' device work
too. Counters that live on the device (the probe union's size) are kept
as tensors and read together in `QueryTrace.finish()`: a traced call
synchronises at most once, at its finish, after its last stage; an
untraced call never does.

While torch.profiler collects, `stage(name)` also opens the range
"micronn.<name>" around the block, traced call or not, so the profiled
calls carry the program's stages on the device trace's clock.

Tracing-off cost: with no trace active and no profiler collecting,
`stage()` is one module-bool test, one thread-local dict lookup and one
`torch.autograd._profiler_enabled()` call, and returns the shared no-op
NO_STAGE; no span objects, dicts or registry entries are allocated.
`set_enabled(False)` is the global kill-switch that makes every hook a
no-op, span and range alike, even under an activated trace; it doubles
as the baseline arm of the overhead measurement.

The engine owns a TraceRing: a bounded ring of the last N QueryTraces plus
the maintenance event log -- structured MaintEvents the scheduler emits
(work item planned, quantum executed, no-op plans, daemon errors) and the
build's -- and a slow-query log of traces above a latency threshold.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

# -- canonical stage names (tests assert against these) ---------------------
STAGE_PLAN = "plan"
STAGE_PROBE = "probe"
STAGE_FAULT = "pager_fault"
STAGE_SCAN = "scan"
STAGE_RERANK = "rerank"
STAGE_MERGE = "merge"
STAGE_QUEUE = "queue_wait"
STAGE_SPLIT = "split"

# MicroNN.build()'s stages, in order ("quantize" and "codes" int8 only)
BUILD_STAGES = ("load", "quantize", "kmeans_fit", "kmeans_assign", "pack",
                "upload", "codes", "partitions", "stats")

# prefix of the profiler ranges the stages open
RANGE_PREFIX = "micronn."

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


class _NoStage:
    """The shared no-op stage (falsy): nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __bool__(self):
        return False


NO_STAGE = _NoStage()


class _Stage:
    """One live stage: the host time of its block into `trace`'s span
    (with the counters `note()` gave) and, while the profiler collects, a
    "micronn.<name>" range around the block. Truthy only with a trace, so
    `if st:` guards the work of computing counters."""

    __slots__ = ("trace", "name", "counters", "_range", "_t0")

    def __init__(self, trace: Optional["QueryTrace"], name: str,
                 profiling: bool):
        self.trace = trace
        self.name = name
        self.counters: Dict[str, object] = {}
        self._range = record_function(RANGE_PREFIX + name) if profiling \
            else None

    def note(self, **counters):
        self.counters.update(counters)

    def __bool__(self):
        return self.trace is not None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self.trace is not None:
            self.trace.record(self.name, dt * 1e3, **self.counters)
        return None


def stage(name: str):
    """`with stage(name) as st:` -- the one way a layer records a span.
    With a trace active on this thread, the block's host wall time (and
    what `st.note(...)` gave, inside `if st:`) is added to the span
    `name`; while the profiler collects, the block is the range
    "micronn.<name>", traced call or not. Otherwise the shared NO_STAGE.
    Never synchronises the device."""
    if _ENABLED:
        tr = _tls.__dict__.get("active")
        profiling = _profiler_enabled()
        if tr is not None or profiling:
            return _Stage(tr, name, profiling)
    return NO_STAGE


def _resolve_tensors(spans) -> None:
    """Read every tensor counter of `spans` to a Python number, all in
    one copy to the host (the trace's one wait for the device)."""
    pending = [(s, k, v) for s in spans for k, v in s.counters.items()
               if isinstance(v, torch.Tensor)]
    if not pending:
        return
    uniq = list({id(v): v for _, _, v in pending}.values())
    dtype = uniq[0].dtype
    for v in uniq[1:]:
        dtype = torch.promote_types(dtype, v.dtype)
    vals = dict(zip((id(v) for v in uniq), torch.stack(
        [v if v.dtype == dtype and v.dim() == 0 else v.reshape(()).to(dtype)
         for v in uniq]).tolist()))
    for s, k, v in pending:
        x = vals[id(v)]
        s.counters[k] = bool(x) if v.dtype == torch.bool else \
            float(x) if v.is_floating_point() else int(x)


@dataclasses.dataclass
class Span:
    """One named stage of a query: accumulated wall time + counters.
    Repeated record() calls with the same name ACCUMULATE (the paged
    fault span sums over every chunk fault): dur_ms and numeric counters
    add, string counters keep the latest value, `calls` counts the
    recordings. A counter may be a device tensor (numeric, it adds on
    the device too) until QueryTrace.finish() reads it."""

    name: str
    dur_ms: float = 0.0
    calls: int = 0
    counters: Dict[str, object] = dataclasses.field(default_factory=dict)

    def add(self, dur_ms: float, counters: Dict[str, object]):
        self.dur_ms += dur_ms
        self.calls += 1
        for k, v in counters.items():
            if isinstance(v, bool) or k not in self.counters or \
                    not isinstance(v, (int, float, torch.Tensor)):
                self.counters[k] = v
            else:
                self.counters[k] = self.counters[k] + v

    def to_dict(self) -> Dict:
        return {"name": self.name, "dur_ms": self.dur_ms,
                "calls": self.calls, "counters": dict(self.counters)}


class QueryTrace:
    """The per-query record: ordered stage spans + identity fields.

    Created by MicroNN.query(trace=True) / explain() / the front door's
    traced submit; layers record into it through stage(). The
    front door additionally builds one per-caller trace per coalesced
    request that ADOPTS the shared fused-call spans and adds its own
    queue_wait/split sub-spans."""

    __slots__ = ("mode", "spec", "n_queries", "spans", "total_ms", "ts",
                 "_result", "shared", "_t0")

    def __init__(self, mode: str = "resident", spec=None,
                 n_queries: int = 0):
        self.mode = mode            # "resident" | "paged" | "build"
        self.spec = spec            # resolved QuerySpec (set by the engine)
        self.n_queries = n_queries
        self.spans: Dict[str, Span] = {}    # insertion-ordered
        self.total_ms = 0.0
        self.ts = time.time()
        self._result = None         # ResultSet, or a weak reference to it
        self.shared = None          # fused-call trace (coalesced requests)
        self._t0 = time.perf_counter()

    @property
    def result(self):
        """The traced query's ResultSet: held by explain()'s trace, only
        referred to (None once the caller has dropped it) by the trace on
        a traced query's result (`refer`)."""
        r = self._result
        return r() if isinstance(r, weakref.ref) else r

    @result.setter
    def result(self, res):
        self._result = res

    def refer(self, res):
        """Point `result` at `res` without keeping it alive. `res.trace`
        holds this trace, so a strong reference back would make a cycle
        that only the garbage collector frees: the ring's traces would
        keep their results' device tensors until it runs."""
        self._result = weakref.ref(res)

    # -- recording ----------------------------------------------------------
    def record(self, name: str, dur_ms: float = 0.0, **counters):
        span = self.spans.get(name)
        if span is None:
            self.spans[name] = Span(name, dur_ms, 1, counters)
        else:
            span.add(dur_ms, counters)

    def finish(self):
        """Close the trace: read its device counters (the one wait for
        the device a traced call makes, after its last stage), then
        total_ms."""
        _resolve_tensors(self.spans.values())
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
    (the daemon swallowed an exception), or "build" (MicroNN.build(),
    with its `stages`: milliseconds by BUILD_STAGES name)."""

    kind: str
    action: str = ""
    pids: Tuple[int, ...] = ()
    rows: int = 0
    bytes_written: int = 0
    dur_ms: float = 0.0
    error: str = ""
    daemon: bool = False
    ts: float = dataclasses.field(default_factory=time.time)
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)

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
