"""Fleet manager (port of repro.fleet.manager): many per-tenant MicroNN
engines under ONE memory budget, one live-handle LRU and one maintenance
daemon.

The paper's deployment is one on-device index per user; its server-side
mirror is one process hosting thousands of per-user or per-corpus indexes
(RAG stores, chat-session memory, semantic caches). `Fleet` is that
process's front door:

    fleet = Fleet(root, dim=64, budget_mb=8.0, max_live=64)  # on "cuda"
    eng = fleet.get("alice")          # lazy open + recover()
    with eng.session() as s: s.upsert(ids, vecs)
    eng.build()
    rs = fleet.query("alice", q, Q.knn(k=10))
    fleet.start_maintenance()         # ONE daemon for every tenant

Resource governance, in three shared pieces:

  * **One frame pool.** Every tenant's pager view is registered into one
    `FramePool` (fleet/pool.py) on the fleet's device: fleet-wide resident
    bytes <= `budget_mb` by construction, and the pool's global CLOCK
    lets hot tenants' working sets grow at cold tenants' expense.
  * **One live-handle LRU.** SQLite connections, index metadata and the
    optimizer are per-engine host state; `max_live` bounds how many
    tenants keep theirs open. The LRU victim is spilled: its frames
    invalidated, its store closed, its engine dropped. Everything durable
    lives in SQLite, so the next `get()` re-opens and `recover()`s (paged
    recovery is metadata only; partitions fault back on first probe).
    Per-tenant metrics are labeled by tenant name, so a reopened tenant
    resumes its cumulative series.
  * **One maintenance daemon.** `FleetScheduler` runs deficit round robin
    over the live tenants' `MaintenanceScheduler`s: each round a tenant
    may spend up to `quantum_rows` of maintenance work (debt from an
    oversized step carries into its next round), so a churning tenant
    cannot starve the rest.

There is no jit in the port, so nothing compiles per tenant: N tenants of
one geometry share the kernel libraries loaded once per process
(`kernels/build.py`), and a query is one fused scan call
(`executor.run_count()`) whichever tenant issues it.

Differences from the JAX package: `Fleet(device=)` places the pool and
every engine (None means "cuda"); the pool starts at `config.pad_to` rows
a frame and grows to the largest tenant through `FramePool.register`; a
bad tenant name, budget, `max_live` or `TenantSLO`, and use after
`close()`, raise ValueError where the reference asserts. As in the
reference, a query in flight on a tenant that another thread's `get()`
spills meets a closed store: size `max_live` above the tenants queried
concurrently.
"""
from __future__ import annotations

import dataclasses
import os
import re
import sqlite3
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from ..core.types import IVFConfig, PagedIndex
from ..obs import metrics as obs_metrics
from ..obs import recorder as obs_recorder
from ..storage.engine import MicroNN
from .pool import FramePool

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")

# manifest filename: starts with '_', so it never collides with a tenant db
# (_NAME_RE requires a leading alphanumeric)
_MANIFEST = "_manifest.db"


@dataclasses.dataclass(frozen=True)
class TenantSLO:
    """Per-tenant latency objective: `target` fraction of queries must
    complete within `p99_ms`. Error-budget burn = (observed fraction above
    the objective) / (allowed fraction, 1 - target): burn <= 1.0 is inside
    the budget ("ok"), > 1.0 burns faster than allotted ("degraded")."""

    p99_ms: float = 50.0
    target: float = 0.99

    def __post_init__(self):
        if not self.p99_ms > 0:
            raise ValueError(f"TenantSLO p99_ms must be > 0: {self.p99_ms}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"TenantSLO target must lie in (0, 1): "
                             f"{self.target}")


class FleetScheduler:
    """Deficit-round-robin maintenance across a fleet's live tenants.

    One daemon thread serves every tenant's `MaintenanceScheduler`: each
    round visits the live tenants in order, granting each `quantum_rows` of
    credit; a tenant steps (bounded quanta, under ITS engine lock) until
    its credit runs out or its queue idles. Unused credit is not banked (an
    idle tenant starts the next round at zero), while overdraft from a
    final oversized step carries as debt: over any window every backlogged
    tenant gets within one max-step of its 1/N share."""

    # idle-fleet wait multiplier: with no actionable work anywhere the
    # daemon sleeps interval_s * _IDLE_BACKOFF between polls (woken early
    # by kick())
    _IDLE_BACKOFF = 8

    def __init__(self, fleet: "Fleet", *, quantum_rows: Optional[int] = None,
                 interval_s: float = 0.002, metrics=None):
        self.fleet = fleet
        self.quantum_rows = int(quantum_rows or fleet.max_rows_per_step)
        self.interval_s = float(interval_s)
        self._deficit: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        if metrics is None:
            metrics = fleet.metrics.scope(component="fleet_scheduler")
        self._c_rounds = metrics.counter("rounds")
        self._c_steps = metrics.counter("steps")

    def step_round(self) -> int:
        """One full rotation over the live tenants; returns the number of
        maintenance steps executed. Callable without the daemon."""
        with self.fleet._lock:
            items = list(self.fleet._live.items())
        steps = 0
        for name, eng in items:
            credit = self._deficit.get(name, 0.0) + self.quantum_rows
            while credit > 0:
                # per-step engine lock (never the fleet lock): queries on
                # other tenants, and snapshot reads on this one, proceed
                with eng.lock:
                    if getattr(eng, "_spilled", False):
                        report = None
                    else:
                        report = eng.scheduler.step(daemon=True)
                if report is None:
                    credit = 0.0        # queue idle: no banked credit
                    break
                steps += 1
                credit -= max(int(report.rows), 1)
            self._deficit[name] = min(credit, 0.0)   # carry only debt
        self._c_rounds.inc()
        if steps:
            self._c_steps.inc(steps)
        return steps

    def drain(self, timeout: float = 30.0) -> int:
        """Hand-crank rounds until no tenant has actionable work."""
        deadline = time.monotonic() + timeout
        total = 0
        while True:
            did = self.step_round()
            total += did
            if not did:
                return total
            if time.monotonic() > deadline:
                raise TimeoutError("fleet maintenance did not drain")

    # -- daemon --------------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        if self.alive:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="micronn-fleet-maintenance",
            daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0):
        if self._thread is None:
            return
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout)
        self._thread = None

    def kick(self):
        """Wake the daemon early (a writer just queued work)."""
        self._wake.set()

    def _loop(self):
        while not self._stop.is_set():
            did = self.step_round()
            wait = self.interval_s if did \
                else self.interval_s * self._IDLE_BACKOFF
            self._wake.wait(wait)
            self._wake.clear()


class Fleet:
    """Open/get/close many per-tenant MicroNN engines over one shared
    FramePool, one live-handle LRU and one maintenance daemon. Every
    tenant is a paged engine on `device` ("cuda" unless the caller passes
    "cpu")."""

    def __init__(self, root: str, *, dim: int, n_attr: int = 0,
                 budget_mb: float = 8.0, max_live: int = 64,
                 config: Optional[IVFConfig] = None,
                 quantize: Optional[str] = None,
                 rerank_factor: Optional[int] = None,
                 max_rows_per_step: int = 4096,
                 maintenance_interval_s: float = 0.002,
                 slo: Optional[TenantSLO] = None,
                 device=None):
        if not budget_mb > 0:
            raise ValueError(f"budget_mb must be > 0: {budget_mb}")
        if not max_live >= 1:
            raise ValueError(f"max_live must be >= 1: {max_live}")
        cfg = config or IVFConfig(dim=dim)
        if quantize is not None:
            cfg = dataclasses.replace(cfg, quantize=quantize)
        if rerank_factor is not None:
            cfg = dataclasses.replace(cfg, rerank_factor=rerank_factor)
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.dim = int(dim)
        self.n_attr = int(n_attr)
        self.budget_mb = float(budget_mb)
        self.max_live = int(max_live)
        self.config = cfg
        self.max_rows_per_step = int(max_rows_per_step)
        # ONE pool for the whole fleet, allocated at the global budget
        # (resident bytes <= budget from the first fault on); its geometry
        # starts at the config's pad and grows to the largest tenant
        # through register()'s resize
        self.pool = FramePool(
            dim=self.dim, p_max=cfg.pad_to,
            budget_bytes=int(self.budget_mb * 2 ** 20),
            payload="int8" if cfg.quantize == "int8" else "f32",
            n_attr=self.n_attr, device=device)
        self.device = self.pool.device
        self._lock = threading.RLock()
        self._live: "OrderedDict[str, MicroNN]" = OrderedDict()
        self._closed = False
        # crash-consistent tenant directory: the manifest, not the
        # filesystem listing, says which tenants exist. create and drop
        # are single SQLite transactions; recover() reconciles manifest
        # and disk, and health() reports the drift
        self._manifest = sqlite3.connect(
            os.path.join(self.root, _MANIFEST),
            check_same_thread=False, isolation_level=None)
        self._manifest.execute("PRAGMA journal_mode=WAL")
        self._manifest.execute("PRAGMA synchronous=NORMAL")
        self._manifest.execute(
            "CREATE TABLE IF NOT EXISTS tenants ("
            "name TEXT PRIMARY KEY, created_ts REAL NOT NULL)")
        # per-tenant SLO objectives (the default applies to every tenant
        # without an override)
        self.default_slo = slo or TenantSLO()
        self._slos: Dict[str, TenantSLO] = {}
        self._orphans: List[str] = []
        self._missing: List[str] = []
        self.recover()
        self.metrics = obs_metrics.default_registry().scope(
            component="fleet", inst=str(obs_metrics.next_instance()))
        self._c_opens = self.metrics.counter("tenant_opens")
        self._c_spills = self.metrics.counter("tenant_spills")
        self.metrics.gauge("resident_bytes",
                           fn=lambda: self.pool.resident_bytes)
        self.metrics.gauge("live_tenants", fn=lambda: len(self._live))
        self.scheduler = FleetScheduler(
            self, interval_s=maintenance_interval_s,
            quantum_rows=max_rows_per_step)

    # -- tenant lifecycle ----------------------------------------------------
    def _path(self, name: str) -> str:
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise ValueError(f"tenant name {name!r} must match "
                             f"{_NAME_RE.pattern}")
        return os.path.join(self.root, f"{name}.db")

    def _check_open(self):
        if self._closed:
            raise ValueError("Fleet is closed")

    def get(self, name: str) -> MicroNN:
        """The tenant's live engine: opened and `recover()`ed lazily on
        first touch, then LRU-cached up to `max_live` handles (the LRU
        victim is spilled, see _spill). A first-ever touch registers the
        tenant in the durable manifest (one transaction) before its db file
        exists, so a crash in between leaves a reconcilable manifest row,
        never an unaccounted file."""
        # flight-recorder hook: one global load and branch when off; the
        # tenant touch order lets replay drive the LRU as production did
        rec = obs_recorder._ACTIVE
        if rec is not None:
            rec.record(obs_recorder.SITE_FLEET_GET, name, None)
        with self._lock:
            self._check_open()
            eng = self._live.get(name)
            if eng is not None:
                self._live.move_to_end(name)
                return eng
            path = self._path(name)
            self._manifest.execute(
                "INSERT OR IGNORE INTO tenants VALUES (?, ?)",
                (name, time.time()))
            if name in self._orphans:
                self._orphans.remove(name)   # adopted on access
            eng = MicroNN(
                self.dim, self.n_attr, path=path, config=self.config,
                device=self.device, memory_budget_mb=self.budget_mb,
                max_rows_per_step=self.max_rows_per_step,
                frame_pool=self.pool, tenant=name)
            eng.recover()
            self._live[name] = eng
            self._c_opens.inc()
            while len(self._live) > self.max_live:
                victim = next(iter(self._live))
                if victim == name:
                    break
                self._spill(victim)
            return eng

    open = get

    def _spill(self, name: str):
        """Evict one live handle: invalidate its frames, close its SQLite
        connections and drop the engine. Rows, clustering, codes, the
        pending delta (partition -1) and the maintenance signals all live
        in SQLite, so a later get() re-opens and recover()s an equivalent
        engine."""
        eng = self._live.pop(name)
        with eng.lock:
            # checked under the engine lock by the fleet daemon: a step
            # scheduled against a spilled engine becomes a no-op instead
            # of touching a closed connection
            eng._spilled = True
            if isinstance(eng.index, PagedIndex):
                eng.index.cache.invalidate_all()
            eng.index = None
            eng.optimizer = None
            eng.store.close()
        self.scheduler._deficit.pop(name, None)
        self._c_spills.inc()

    def drop(self, name: str):
        """Destroy a tenant: spill its handle, delete its manifest row (ONE
        transaction, the durable point of no return), then remove its db
        files. A crash after the commit but before the unlink leaves an
        orphan file that recover() reports, never a half-deleted tenant
        the manifest still claims."""
        path = self._path(name)
        with self._lock:
            self._check_open()
            if name in self._live:
                self._spill(name)
            self._manifest.execute(
                "DELETE FROM tenants WHERE name = ?", (name,))
            self._slos.pop(name, None)
            for suffix in ("", "-wal", "-shm"):
                try:
                    os.remove(path + suffix)
                except FileNotFoundError:
                    pass

    def recover(self) -> Dict[str, List[str]]:
        """Reconcile the durable manifest with the filesystem. Returns (and
        keeps for health()) the drift: `orphans` are db files without a
        manifest row (a crash mid-drop, or a foreign file), `missing` are
        manifest rows whose db file vanished. Neither is repaired: get()
        adopts an orphan on access, and the operator decides on missing
        rows."""
        on_disk = {f[:-3] for f in os.listdir(self.root)
                   if f.endswith(".db") and not f.startswith("_")}
        with self._lock:
            self._check_open()
            manifest = {r[0] for r in self._manifest.execute(
                "SELECT name FROM tenants")}
            # a registered-but-never-written tenant has no file yet; it is
            # missing only if it is not live either
            self._orphans = sorted(on_disk - manifest)
            self._missing = sorted(m for m in manifest - on_disk
                                   if m not in self._live)
            return {"orphans": list(self._orphans),
                    "missing": list(self._missing)}

    def close(self, name: Optional[str] = None):
        """Close one tenant (spill it), or, with no name, stop the
        maintenance daemon and spill every live tenant."""
        if name is not None:
            with self._lock:
                if name in self._live:
                    self._spill(name)
            return
        self.scheduler.stop()
        with self._lock:
            if self._closed:
                return
            for n in list(self._live):
                self._spill(n)
            self._manifest.close()
            self._closed = True

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- convenience ---------------------------------------------------------
    def query(self, name: str, vecs, spec=None, **kwargs):
        return self.get(name).query(vecs, spec, **kwargs)

    def tenants(self) -> List[str]:
        """Every tenant of this fleet: the durable manifest union the live
        handles, not the filesystem listing. An unregistered db file in the
        root is an orphan: in `recover()` / `health()`, not here."""
        with self._lock:
            self._check_open()
            rows = {r[0] for r in self._manifest.execute(
                "SELECT name FROM tenants")}
            return sorted(rows | set(self._live))

    def live_tenants(self) -> List[str]:
        with self._lock:
            return list(self._live)

    # -- maintenance ---------------------------------------------------------
    def start_maintenance(self):
        self.scheduler.start()

    def stop_maintenance(self):
        self.scheduler.stop()

    def maintain(self, until_idle: bool = True) -> int:
        """Foreground maintenance: one deficit round, or rounds until every
        tenant idles."""
        if until_idle:
            return self.scheduler.drain()
        return self.scheduler.step_round()

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            live = list(self._live)
        return {"budget_bytes": self.pool.budget_bytes,
                "resident_bytes": self.pool.resident_bytes,
                "capacity_frames": self.pool.capacity,
                "live_tenants": live,
                "tenant_opens": self._c_opens.value,
                "tenant_spills": self._c_spills.value,
                "daemon_alive": self.scheduler.alive,
                "pool": self.pool.stats()}

    # -- SLO layer -----------------------------------------------------------
    def set_slo(self, name: str, *, p99_ms: float,
                target: float = 0.99) -> TenantSLO:
        """Override the latency objective for one tenant."""
        slo = TenantSLO(p99_ms=p99_ms, target=target)
        with self._lock:
            self._slos[name] = slo
        return slo

    def slo_for(self, name: str) -> TenantSLO:
        with self._lock:
            return self._slos.get(name, self.default_slo)

    def _tenant_health(self, name: str) -> dict:
        """One tenant's SLO verdict from its cumulative query-latency
        histogram (the engine scope `component=engine, tenant=<name>`,
        which survives spills: burn is over the tenant's whole history,
        not its current handle)."""
        slo = self.slo_for(name)
        h = obs_metrics.default_registry().histogram(
            "query_s", component="engine", tenant=name)
        n = h.count
        observed = h.fraction_above(slo.p99_ms / 1e3)
        allowed = 1.0 - slo.target
        burn = observed / allowed if allowed > 0 else float("inf")
        return {"verdict": "ok" if (n == 0 or burn <= 1.0)
                else "degraded",
                "queries": n,
                "p99_ms": h.quantile(0.99) * 1e3,
                "objective_ms": slo.p99_ms,
                "target": slo.target,
                "violation_fraction": observed,
                "burn_rate": burn}

    def health(self) -> dict:
        """Structured fleet health (the /healthz document): per-tenant SLO
        verdicts and error-budget burn, pool pressure, the maintenance
        daemon's liveness, the top noisy neighbours from the eviction
        matrix, and the manifest/disk drift from recover(). Takes the fleet
        lock briefly for directory state and never an engine lock, so a
        health probe cannot stall queries or writers."""
        drift = self.recover()
        names = self.tenants()
        tenants = {n: self._tenant_health(n) for n in names}
        degraded = sorted(n for n, t in tenants.items()
                          if t["verdict"] != "ok")
        budget = self.pool.budget_bytes
        resident = self.pool.resident_bytes
        return {"schema": 1,
                "status": "degraded" if degraded else "ok",
                "tenants": tenants,
                "degraded": degraded,
                "pool": {"budget_bytes": budget,
                         "resident_bytes": resident,
                         "pressure": resident / budget if budget else 0.0},
                "daemon_alive": self.scheduler.alive,
                "live_tenants": self.live_tenants(),
                "noisy_neighbors": self.pool.top_evictors(5),
                "manifest": drift}
