"""Unified metrics registry (port of repro.obs.metrics; pure Python, the
port's own copy): one process-wide source of truth for every component's
operational counters.

Three metric kinds:

    Counter     monotonic (thread-safe add; settable only so a rebuilt
                component can carry its cumulative series over)
    Gauge       point-in-time value, set explicitly or computed by a
                zero-arg callback at read time (e.g. the executor's
                fused-scan call count)
    Histogram   fixed log-spaced buckets, mergeable across instances,
                interpolated quantiles (the front door's latencies)

Metrics are keyed by (name, labels): `registry.counter("hits",
component="pager")` is get-or-create, so a component re-created against
the same labels (a paged rebuild re-attaching its frame pool) keeps its
cumulative series. `scope(**labels)` returns a view that pre-binds labels:
the engine hands each subsystem `engine.metrics.scope(component=...)`, and
every metric the subsystem registers lands in the one default registry
under that engine's labels.

Export: `snapshot()` is the JSON view; `to_prometheus()` is the text
exposition format for scraping (obs/http.py serves it). `MicroNN.stats()`
keys are derived views over this registry.

Hot-path contract: reading a Counter/Gauge is lock-free; incrementing
takes the metric's own lock (a few hundred ns). Nothing here allocates
after registration.
"""
from __future__ import annotations

import itertools
import re
import threading
from bisect import bisect_left, bisect_right
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

# Default histogram buckets: log-spaced upper edges covering 1us..~134s
# at a factor of sqrt(2) per bucket -- fine enough that an interpolated
# p50/p99 lands within ~20% of the exact sample, over the full range a
# query or maintenance quantum can take. Values are in the observed unit
# (the repo observes seconds); an overflow bucket catches the rest.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    1e-6 * (2.0 ** (i / 2.0)) for i in range(55))

_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, double quote and
    newline must be escaped or a scraper's parser rejects the whole
    exposition (a tenant named `a"b` would poison /metrics)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels_prom(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(
        f'{_SANITIZE.sub("_", k)}="{_escape_label_value(v)}"'
        for k, v in labels) + "}"


class Counter:
    """Monotonic counter. `set()` exists only so a rebuilt component can
    carry its cumulative series over (the pager across paged rebuilds);
    normal use is inc()."""

    kind = "counter"
    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1):
        with self._lock:
            self._value += n

    def set(self, value: int):
        with self._lock:
            self._value = int(value)

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Point-in-time value: set explicitly, or lazily computed by a
    zero-arg callback at read time (`fn`), e.g. executor.run_count."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_lock", "_value", "fn")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0
        self.fn = fn

    def set(self, value: float):
        with self._lock:
            self._value = value

    @property
    def value(self) -> float:
        if self.fn is not None:
            return self.fn()
        return self._value

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    `buckets` are ascending upper edges; counts[i] tallies observations
    <= buckets[i], with one extra overflow bucket past the last edge.
    Fixed edges make instances MERGEABLE (elementwise count addition),
    and the exporter can emit cumulative Prometheus `le` series directly.
    `quantile(q)` interpolates linearly inside the winning bucket, so a
    p50/p99 over sqrt(2)-spaced edges lands within ~20% of the exact
    order statistic (plenty for gates bounded 100x above the signal)."""

    kind = "histogram"
    __slots__ = ("name", "labels", "_lock", "buckets", "counts", "_sum",
                 "_count", "_min", "_max")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.buckets = tuple(buckets) if buckets is not None \
            else DEFAULT_BUCKETS
        assert all(a < b for a, b in zip(self.buckets, self.buckets[1:])), \
            "histogram buckets must be strictly ascending"
        self.counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float):
        i = bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def merge(self, other: "Histogram"):
        """Fold another histogram (same bucket edges) into this one."""
        assert self.buckets == other.buckets, \
            "can only merge histograms with identical bucket edges"
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self._sum += other._sum
            self._count += other._count
            self._min = min(self._min, other._min)
            self._max = max(self._max, other._max)

    def fraction_above(self, v: float) -> float:
        """Fraction of observations above `v`, at bucket resolution
        (an observation whose bucket straddles `v` counts as above --
        the conservative direction for an SLO violation estimate).
        0.0 when empty."""
        j = bisect_right(self.buckets, v)
        with self._lock:
            n = self._count
            if n == 0:
                return 0.0
            below = sum(self.counts[:j])
            return (n - below) / n

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (0 <= q <= 1); 0.0 when empty."""
        with self._lock:
            n = self._count
            if n == 0:
                return 0.0
            target = q * n
            cum = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if cum + c >= target:
                    lo = self.buckets[i - 1] if i > 0 else min(
                        self._min, self.buckets[0])
                    hi = self.buckets[i] if i < len(self.buckets) \
                        else self._max
                    lo = max(lo, self._min)
                    hi = min(max(hi, lo), self._max)
                    frac = (target - cum) / c
                    return lo + frac * (hi - lo)
                cum += c
            return self._max

    def snapshot(self):
        with self._lock:
            nonzero = [[(self.buckets[i] if i < len(self.buckets)
                         else float("inf")), c]
                       for i, c in enumerate(self.counts) if c]
            return {"count": self._count, "sum": self._sum,
                    "min": self._min if self._count else 0.0,
                    "max": self._max if self._count else 0.0,
                    "p50": self.quantile_unlocked(0.50),
                    "p99": self.quantile_unlocked(0.99),
                    "buckets": nonzero}

    def quantile_unlocked(self, q: float) -> float:
        # snapshot() already holds the lock; RLock semantics by hand
        n = self._count
        if n == 0:
            return 0.0
        target = q * n
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.buckets[i - 1] if i > 0 else min(
                    self._min, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else self._max
                lo = max(lo, self._min)
                hi = min(max(hi, lo), self._max)
                return lo + (target - cum) / c * (hi - lo)
            cum += c
        return self._max


class MetricsRegistry:
    """Thread-safe get-or-create registry keyed on (name, labels).

    Cardinality guard: fleet mode labels series per TENANT, so
    an unbounded tenant population must not grow the registry without
    bound. Each metric NAME keeps an LRU over its label sets, capped at
    `max_series_per_name`; registering a fresh label set past the cap
    evicts the least-recently-REGISTERED/looked-up series for that name
    and increments the registry's own `obs_series_evicted` counter. An
    evicted series simply restarts from zero if its component comes
    back (get-or-create re-creates it) -- the same contract as a
    process restart. The LRU is touched only inside _get (component
    construction), never on inc()/observe(), so the hot-path
    zero-allocation guarantee is unchanged."""

    def __init__(self, max_series_per_name: int = 512):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            object] = {}
        # name -> OrderedDict(label_key -> None), most recent LAST
        self._by_name: Dict[str, "OrderedDict"] = {}
        self.max_series_per_name = int(max_series_per_name)

    def _evicted_counter(self) -> Counter:
        # the guard's own telemetry, registered directly (self._lock is
        # NOT re-entrant) under its own name: a single-series name, so
        # it can never evict itself
        key = ("obs_series_evicted", ())
        m = self._metrics.get(key)
        if m is None:
            m = Counter(*key)
            self._metrics[key] = m
            self._by_name.setdefault("obs_series_evicted",
                                     OrderedDict())[()] = None
        return m

    def _get(self, cls, name: str, labels: Dict[str, str], **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            lru = self._by_name.setdefault(name, OrderedDict())
            if m is None:
                while len(lru) >= max(self.max_series_per_name, 1):
                    old_labels, _ = lru.popitem(last=False)
                    del self._metrics[(name, old_labels)]
                    self._evicted_counter().inc()
                m = cls(name, key[1], **kwargs)
                self._metrics[key] = m
                lru[key[1]] = None
            else:
                assert isinstance(m, cls), \
                    f"metric {name!r}{labels} already registered as " \
                    f"{m.kind}, not {cls.kind}"
                lru.move_to_end(key[1])
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              **labels) -> Gauge:
        g = self._get(Gauge, name, labels)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        if buckets is not None:
            return self._get(Histogram, name, labels, buckets=buckets)
        return self._get(Histogram, name, labels)

    def scope(self, **labels) -> "Scope":
        return Scope(self, dict(labels))

    def size(self) -> int:
        """Number of registered metric series (the zero-allocation
        contract of the tracing-off hot path holds this stable)."""
        with self._lock:
            return len(self._metrics)

    def _sorted_items(self):
        with self._lock:
            items = list(self._metrics.items())
        return sorted(items, key=lambda kv: (kv[0][0], kv[0][1]))

    def snapshot(self) -> Dict:
        """JSON view: {"counters": {...}, "gauges": {...},
        "histograms": {...}} keyed 'name{k="v",...}'."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for (name, labels), m in self._sorted_items():
            key = name + _fmt_labels(labels)
            out[m.kind + "s"][key] = m.snapshot()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (names sanitized: dots ->
        underscores; histograms emit cumulative `le` bucket series +
        _sum/_count). Label values are escaped per the text-format spec
        and each metric family gets exactly one `# HELP` + `# TYPE`
        header -- duplicated headers or a raw quote/newline in a label
        value make strict scrapers reject the whole page."""
        lines: List[str] = []
        seen_family: set = set()
        for (name, labels), m in self._sorted_items():
            pname = _SANITIZE.sub("_", name)
            if pname not in seen_family:
                seen_family.add(pname)
                # HELP text escapes only backslash + newline (spec);
                # metric names are dotted identifiers so this is belt
                # and braces
                help_txt = name.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {pname} {help_txt} ({m.kind})")
                lines.append(f"# TYPE {pname} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for i, c in enumerate(m.counts):
                    cum += c
                    le = f"{m.buckets[i]:.9g}" if i < len(m.buckets) \
                        else "+Inf"
                    ls = _fmt_labels_prom(labels + (("le", le),))
                    lines.append(f"{pname}_bucket{ls} {cum}")
                ls = _fmt_labels_prom(labels)
                lines.append(f"{pname}_sum{ls} {m.sum:.9g}")
                lines.append(f"{pname}_count{ls} {m.count}")
            else:
                v = m.value
                vs = f"{v:.9g}" if isinstance(v, float) else str(v)
                lines.append(f"{pname}{_fmt_labels_prom(labels)} {vs}")
        return "\n".join(lines) + "\n"


class Scope:
    """A label-binding view over a registry: every metric created through
    the scope carries the scope's labels (nested scopes merge theirs).
    The engine hands one scope per component, so the whole process shares
    ONE registry yet each engine/component reads its own series."""

    __slots__ = ("registry", "labels")

    def __init__(self, registry: MetricsRegistry, labels: Dict[str, str]):
        self.registry = registry
        self.labels = labels

    def _merged(self, labels: Dict) -> Dict:
        merged = dict(self.labels)
        merged.update(labels)
        return merged

    def counter(self, name: str, **labels) -> Counter:
        return self.registry.counter(name, **self._merged(labels))

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              **labels) -> Gauge:
        return self.registry.gauge(name, fn=fn, **self._merged(labels))

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        return self.registry.histogram(name, buckets=buckets,
                                       **self._merged(labels))

    def scope(self, **labels) -> "Scope":
        return Scope(self.registry, self._merged(labels))


_DEFAULT = MetricsRegistry()
_INSTANCES = itertools.count()


def default_registry() -> MetricsRegistry:
    """THE process registry every component registers into."""
    return _DEFAULT


def next_instance() -> str:
    """Monotonic instance label for components constructed outside an
    engine scope (a bare PartitionCache in a test) -- keeps their series
    distinct without the caller inventing label plumbing."""
    return str(next(_INSTANCES))
