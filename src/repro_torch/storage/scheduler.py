"""Budgeted background maintenance scheduler (paper §3.6 made incremental;
port of repro.storage.scheduler): drains the monitor's prioritised work
queue in bounded quanta, so no query or upsert pays for a rebuild.

  * `step()` executes at most one work item touching at most
    `max_rows_per_step` rows. Flushes are divisible (a partial flush moves
    the first `max_rows_per_step` live delta rows and leaves the rest
    searchable in the delta); split / merge / recluster items bound
    themselves at plan time (maintenance.neighborhood admits neighbours
    only while the quantum has room). An item whose seed partition alone
    exceeds the quantum is deferred.
  * The queue is polled afresh before every step, so each step sees the
    state the previous one left.
  * Items that plan to a no-op are remembered and skipped until a step
    makes progress.

Durability per step (both engine modes): the touched rows' codes persist
first, then the row moves and the touched centroids commit as one SQLite
transaction (VectorStore.apply_repair); a crash between the two serves
the pre-repair clustering.

Daemon mode: `start_daemon()` runs one quantum at a time on a background
thread, under the engine's write mutex, whenever the `idle` probe says
the foreground is idle -- and at least every `_BUSY_BACKOFF` polls when it
is not, so maintenance is never starved for good. Between quanta it leaves
the mutex free for one poll interval, so writers are not starved either.

Telemetry: the counters live in the metrics registry (obs.metrics) under
the engine's `component=scheduler` scope, read back by `stats()`; every
planned item, executed quantum, no-op plan and swallowed daemon error is
appended as a MaintEvent to the engine's trace ring (the maintenance event
log).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace


@dataclasses.dataclass
class StepReport:
    """What one scheduler step did (MicroNN.maintain_step's result)."""

    action: str               # "flush" | "split" | "merge" | "recluster"
    #                           | "repack"
    pids: Tuple[int, ...]     # partitions the step touched
    rows: int                 # rows the step processed (<= quantum)
    bytes_written: int        # durable write I/O of the step


class MaintenanceScheduler:
    """Drains `IndexMonitor.work_queue` against a MicroNN engine, one
    bounded quantum at a time. Owned by the engine (`engine.scheduler`);
    `MicroNN.maintain_step()` / `maintain(until_idle=True)` are the public
    entry points."""

    # with nothing to do the daemon sleeps interval_s * _IDLE_BACKOFF
    # between polls (woken early by kick())
    _IDLE_BACKOFF = 8
    # after this many consecutive yields to foreground traffic the daemon
    # takes one quantum anyway
    _BUSY_BACKOFF = 64

    ACTIONS = ("flush", "split", "merge", "repack", "recluster")

    def __init__(self, engine, max_rows_per_step: int = 4096,
                 metrics=None):
        if max_rows_per_step < 1:
            raise ValueError(f"max_rows_per_step must be >= 1: "
                             f"{max_rows_per_step}")
        self.engine = engine
        self.max_rows_per_step = int(max_rows_per_step)
        # the engine passes a sub-scope of its own labels; a standalone
        # scheduler registers under a fresh instance label
        if metrics is None:
            metrics = obs_metrics.default_registry().scope(
                component="scheduler",
                inst=str(obs_metrics.next_instance()))
        self.metrics = metrics
        self._c_wakeups = metrics.counter("wakeups")
        self._c_idle_probes = metrics.counter("idle_probes")
        self._c_busy_backoffs = metrics.counter("busy_backoffs")
        self._c_steps = metrics.counter("steps")
        self._c_noops = metrics.counter("noops")
        self._c_rows_moved = metrics.counter("rows_moved")
        self._c_bytes_written = metrics.counter("bytes_written")
        self._c_actions = {a: metrics.counter("action_steps", action=a)
                           for a in self.ACTIONS}
        # (action, pids, rows) keys that planned to a no-op since the last
        # step that made progress
        self._skip: set = set()
        self._daemon: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._idle_fn: Optional[Callable[[], bool]] = None
        self._interval_s = 0.002
        self.daemon_steps = 0          # quanta the daemon has executed
        self.daemon_errors = 0         # exceptions the loop recorded
        self.last_daemon_error: Optional[BaseException] = None

    def pending(self) -> List:
        """The monitor's current prioritised queue (fresh every call)."""
        if self.engine.index is None:
            return []
        return self.engine.monitor.work_queue(self.engine.index)

    def queue_depth(self) -> int:
        """Number of pending maintenance work items."""
        return len(self.pending())

    def _emit(self, kind: str, *, action: str = "", pids=(), rows: int = 0,
              bytes_written: int = 0, dur_ms: float = 0.0, error: str = "",
              daemon: bool = False):
        """Append a MaintEvent to the engine's trace ring (the maintenance
        event log); a no-op without a ring or with tracing disabled."""
        ring = getattr(self.engine, "traces", None)
        if ring is None or not obs_trace.enabled():
            return
        ring.append(obs_trace.MaintEvent(
            kind=kind, action=action, pids=tuple(int(p) for p in pids),
            rows=int(rows), bytes_written=int(bytes_written),
            dur_ms=dur_ms, error=error, daemon=daemon))

    def step(self, *, daemon: bool = False) -> Optional[StepReport]:
        """Execute the highest-priority actionable work item; None when the
        queue is idle (or nothing actionable fits the quantum)."""
        budget = self.max_rows_per_step
        for item in self.pending():
            key = (item.action, item.pids, item.rows)
            if key in self._skip:
                continue
            if item.action != "flush" and item.rows > budget:
                # an indivisible neighbourhood larger than the quantum
                self._skip.add(key)
                continue
            self._emit("planned", action=item.action, pids=item.pids,
                       rows=item.rows, daemon=daemon)
            t0 = time.perf_counter()
            if daemon:
                # counted before the item commits: an observer that sees
                # the post-step index also sees the step counted
                self.daemon_steps += 1
            try:
                report = self.engine._execute_work_item(item, budget)
            except BaseException:
                if daemon:
                    self.daemon_steps -= 1
                raise
            if report is None:
                if daemon:
                    self.daemon_steps -= 1
                self._skip.add(key)
                self._c_noops.inc()
                self._emit("noop", action=item.action, pids=item.pids,
                           daemon=daemon)
                continue
            self._skip.clear()      # progress: stale no-op keys expire
            self._c_steps.inc()
            counter = self._c_actions.get(report.action)
            if counter is not None:
                counter.inc()
            self._c_rows_moved.inc(report.rows)
            self._c_bytes_written.inc(report.bytes_written)
            self._emit("step", action=report.action, pids=report.pids,
                       rows=report.rows, bytes_written=report.bytes_written,
                       dur_ms=(time.perf_counter() - t0) * 1e3,
                       daemon=daemon)
            return report
        return None

    def stats(self) -> dict:
        """The scheduler's registry-backed counters
        (MicroNN.stats()['scheduler'])."""
        return {"wakeups": self._c_wakeups.value,
                "idle_probes": self._c_idle_probes.value,
                "busy_backoffs": self._c_busy_backoffs.value,
                "steps": self._c_steps.value,
                "noops": self._c_noops.value,
                "rows_moved": self._c_rows_moved.value,
                "bytes_written": self._c_bytes_written.value,
                "daemon_errors": self.daemon_errors,
                "actions": {a: c.value for a, c in self._c_actions.items()}}

    def drain(self, max_steps: Optional[int] = None) -> List[StepReport]:
        """Run steps until the queue is idle (maintain(until_idle=True)).
        `max_steps` is a runaway guard; the default scales with k."""
        out: List[StepReport] = []
        idx = self.engine.index
        limit = max_steps if max_steps is not None \
            else 64 + 8 * (idx.k if idx is not None else 1)
        for _ in range(limit):
            r = self.step()
            if r is None:
                break
            out.append(r)
        return out

    # -- daemon thread --------------------------------------------------------
    @property
    def daemon_alive(self) -> bool:
        return self._daemon is not None and self._daemon.is_alive()

    def start_daemon(self, idle: Optional[Callable[[], bool]] = None,
                     interval_s: float = 0.002):
        """Run the scheduler on a background daemon thread. `idle` is an
        advisory probe (False while foreground requests wait); `interval_s`
        is the poll cadence. Each quantum holds `engine.lock`. Idempotent
        while alive."""
        if self.daemon_alive:
            return
        self._idle_fn = idle
        self._interval_s = float(interval_s)
        self._stop.clear()
        self._wake.clear()
        self._daemon = threading.Thread(
            target=self._daemon_loop, name="micronn-maintenance",
            daemon=True)
        self._daemon.start()

    def stop_daemon(self, timeout: Optional[float] = 10.0):
        """Stop the daemon and join it (no-op when not running); a quantum
        in flight completes, never stopped halfway through its durability
        ordering."""
        if self._daemon is None:
            return
        self._stop.set()
        self._wake.set()
        self._daemon.join(timeout)
        if self._daemon.is_alive():
            raise RuntimeError("maintenance daemon failed to stop within "
                               f"{timeout} s")
        self._daemon = None

    def kick(self):
        """Wake the daemon early (a writer just enqueued likely work)."""
        self._wake.set()

    def _sleep(self, seconds: float):
        self._wake.wait(seconds)
        self._wake.clear()

    def _daemon_loop(self):
        """While alive: when the foreground is idle (or has been busy past
        the starvation bound), take the engine's write mutex and run ONE
        quantum; back off while the queue is empty. An exception is
        recorded and the loop goes on: a failed repair plan must not stop
        maintenance for good."""
        yielded = 0
        while not self._stop.is_set():
            self._c_wakeups.inc()
            if self.engine.index is None:
                self._sleep(self._interval_s * self._IDLE_BACKOFF)
                continue
            busy = self._idle_fn is not None and not self._idle_fn()
            if busy and yielded < self._BUSY_BACKOFF:
                yielded += 1
                self._c_busy_backoffs.inc()
                self._sleep(self._interval_s)
                continue
            yielded = 0
            report = None
            try:
                with self.engine.lock:
                    if not self._stop.is_set():
                        report = self.step(daemon=True)
            except BaseException as e:  # noqa: BLE001 -- the daemon lives on
                self.daemon_errors += 1
                self.last_daemon_error = e
                self._emit("daemon_error", error=repr(e), daemon=True)
            if report is None:
                self._c_idle_probes.inc()
                self._sleep(self._interval_s * self._IDLE_BACKOFF)
            else:
                # one poll interval without the mutex after every quantum:
                # a writer waiting on it gets in (a lock handed straight
                # back would starve it while the queue is long)
                self._stop.wait(self._interval_s)
