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
is not, so maintenance is never starved for good.

Counters are plain attributes (`stats()`); the JAX package's metrics
registry and trace ring (obs/*) are not ported yet, so no maintenance
events are recorded.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Tuple


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

    def __init__(self, engine, max_rows_per_step: int = 4096):
        if max_rows_per_step < 1:
            raise ValueError(f"max_rows_per_step must be >= 1: "
                             f"{max_rows_per_step}")
        self.engine = engine
        self.max_rows_per_step = int(max_rows_per_step)
        # counters (plain attributes until the metrics registry is ported)
        self.wakeups = 0
        self.idle_probes = 0
        self.busy_backoffs = 0
        self.steps = 0
        self.noops = 0
        self.rows_moved = 0
        self.bytes_written = 0
        self.action_steps = {a: 0 for a in self.ACTIONS}
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
                self.noops += 1
                continue
            self._skip.clear()      # progress: stale no-op keys expire
            self.steps += 1
            if report.action in self.action_steps:
                self.action_steps[report.action] += 1
            self.rows_moved += report.rows
            self.bytes_written += report.bytes_written
            return report
        return None

    def stats(self) -> dict:
        """The scheduler's counters (MicroNN.stats()['scheduler'])."""
        return {"wakeups": self.wakeups, "idle_probes": self.idle_probes,
                "busy_backoffs": self.busy_backoffs, "steps": self.steps,
                "noops": self.noops, "rows_moved": self.rows_moved,
                "bytes_written": self.bytes_written,
                "daemon_errors": self.daemon_errors,
                "actions": dict(self.action_steps)}

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
            self.wakeups += 1
            if self.engine.index is None:
                self._sleep(self._interval_s * self._IDLE_BACKOFF)
                continue
            busy = self._idle_fn is not None and not self._idle_fn()
            if busy and yielded < self._BUSY_BACKOFF:
                yielded += 1
                self.busy_backoffs += 1
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
            if report is None:
                self.idle_probes += 1
                self._sleep(self._interval_s * self._IDLE_BACKOFF)
