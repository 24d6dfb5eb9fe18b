"""Workload flight recorder (port of repro.obs.recorder): bounded, sampled,
on-disk capture of the live query stream, and a deterministic replay
harness that turns any captured window into a runnable regression test.

For a sampled subset of live traffic the recorder captures

    (ts_offset, tenant, site, spec, query vectors[, result digest])

into one SQLite file, and `replay()` re-executes any captured window
against an engine and checks bit-identical ResultSets: ids and exact-f32
scores. Everything in the execution path is deterministic for a fixed
store state (the kernels' fixed reduction trees and tie order, paged ==
resident and coalesced == solo bit for bit), so capture digest == replay
digest is an end-to-end invariant. The file format is the JAX package's.

Hot-path contract (as obs.trace): recording off costs one branch per hook
site. Hooks read the module global directly --

    rec = recorder._ACTIVE
    if rec is not None: rec.record(...)

-- no function call, no allocation.

Capture sites (the `site` column tells replay what it is looking at):

    engine.query      MicroNN.query -- vectors + spec + result digest
    frontdoor.submit  FrontDoor.submit -- vectors + spec at admission
                      (no digest: the Future has not resolved; replay
                      self-checks these by double execution)
    fleet.get         Fleet.get -- a tenant handle touch, no vectors
                      (replay through a fleet drives its live-handle LRU:
                      opens and spills, as production did)

Bounded: `max_records` caps the file (capture stops, drops counted);
`sample_every=N` keeps every Nth eligible call (deterministic). Records
are buffered and flushed to SQLite every `flush_every` appends, on
`flush()`, and on `close()`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import pickle
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import metrics as obs_metrics

# sites ---------------------------------------------------------------------
SITE_ENGINE = "engine.query"
SITE_FRONTDOOR = "frontdoor.submit"
SITE_FLEET_GET = "fleet.get"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS flight (
    seq       INTEGER PRIMARY KEY,
    ts_offset REAL NOT NULL,
    tenant    TEXT,
    site      TEXT NOT NULL,
    spec      BLOB,
    vecs      BLOB,
    q         INTEGER NOT NULL DEFAULT 0,
    dim       INTEGER NOT NULL DEFAULT 0,
    digest    TEXT
);
CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v TEXT);
"""

# THE process-global active recorder. Hook sites read this name
# directly (`recorder._ACTIVE`): recording-off is one global load +
# one `is not None` branch -- the same budget as obs.trace's
# kill-switch bool. Installed/removed only via install()/uninstall().
_ACTIVE: Optional["FlightRecorder"] = None
_INSTALL_LOCK = threading.Lock()


def active() -> Optional["FlightRecorder"]:
    return _ACTIVE


def install(rec: "FlightRecorder"):
    """Make `rec` the process recorder (at most one at a time)."""
    global _ACTIVE
    with _INSTALL_LOCK:
        assert _ACTIVE is None or _ACTIVE is rec, \
            "another FlightRecorder is already installed"
        _ACTIVE = rec


def uninstall(rec: Optional["FlightRecorder"] = None):
    global _ACTIVE
    with _INSTALL_LOCK:
        if rec is None or _ACTIVE is rec:
            _ACTIVE = None


def result_digest(res) -> str:
    """Bit-exact fingerprint of a ResultSet: sha256 over the shapes,
    dtypes and raw bytes of ids + scores. Two results digest equal iff
    every id and every float32 score is bit-identical."""
    ids, scores = res.to_numpy()
    h = hashlib.sha256()
    for a in (ids, scores):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class FlightRecorder:
    """Bounded, sampled on-disk workload capture (see module doc).

    Thread-safe: hook sites on any thread append under one lock; SQLite
    writes happen in flush() batches on whichever thread crossed the
    `flush_every` watermark (single connection, serialized by the same
    lock)."""

    def __init__(self, path: str, *, sample_every: int = 1,
                 max_records: int = 100_000, flush_every: int = 64):
        assert sample_every >= 1, sample_every
        assert max_records >= 1, max_records
        self.path = str(path)
        self.sample_every = int(sample_every)
        self.max_records = int(max_records)
        self.flush_every = max(int(flush_every), 1)
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(self.path, check_same_thread=False,
                                     isolation_level=None)
        self._conn.executescript(_SCHEMA)
        self._conn.execute(
            "INSERT OR REPLACE INTO meta VALUES ('version', '1')")
        self._t0 = time.monotonic()
        self._seen = 0          # eligible calls (sampling denominator)
        self._seq = 0           # records actually captured
        self._buf: List[tuple] = []
        self._closed = False
        m = obs_metrics.default_registry().scope(
            component="recorder", inst=obs_metrics.next_instance())
        self._c_recorded = m.counter("records")
        self._c_dropped = m.counter("dropped")
        self._c_sampled_out = m.counter("sampled_out")

    # -- capture -------------------------------------------------------------
    def record(self, site: str, tenant: Optional[str], vecs,
               spec=None, result=None):
        """Capture one call. Called ONLY behind the hook-site branch
        (`recorder._ACTIVE is not None`), so all cost here is
        recording-ON cost. The sampling decision comes FIRST: a
        sampled-out call pays only the counter bump -- never the spec
        pickle or the result digest's device->host copy."""
        with self._lock:
            if self._closed:
                return
            self._seen += 1
            if (self._seen - 1) % self.sample_every:
                self._c_sampled_out.inc()
                return
            if self._seq >= self.max_records:
                self._c_dropped.inc()
                return
            seq = self._seq
            self._seq += 1
        # heavy encode OUTSIDE the lock: the digest forces the
        # device->host transfer, and pickling walks the predicate tree
        ts = time.monotonic() - self._t0
        blob_spec = None
        if spec is not None:
            try:
                blob_spec = pickle.dumps(spec, protocol=4)
            except Exception:
                # opaque predicate callable etc. -- unreplayable; count
                # the drop rather than poison the capture file (the
                # reserved seq stays as a gap)
                self._c_dropped.inc()
                return
        digest = None if result is None else result_digest(result)
        blob_vecs, q, dim = None, 0, 0
        if vecs is not None:
            if hasattr(vecs, "cpu"):        # a device tensor
                vecs = vecs.cpu()
            v = np.atleast_2d(np.asarray(vecs, np.float32))
            blob_vecs = np.ascontiguousarray(v).tobytes()
            q, dim = int(v.shape[0]), int(v.shape[1])
        with self._lock:
            if self._closed:
                return
            self._buf.append((seq, ts, tenant, site, blob_spec,
                              blob_vecs, q, dim, digest))
            self._c_recorded.inc()
            if len(self._buf) >= self.flush_every:
                self._flush_locked()

    def _flush_locked(self):
        if self._buf:
            self._conn.executemany(
                "INSERT INTO flight VALUES (?,?,?,?,?,?,?,?,?)",
                self._buf)
            self._buf.clear()

    def flush(self):
        with self._lock:
            self._flush_locked()

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._closed = True
            self._conn.close()
        uninstall(self)

    def __enter__(self) -> "FlightRecorder":
        install(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- introspection -------------------------------------------------------
    @property
    def recorded(self) -> int:
        return self._seq

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"path": self.path, "recorded": self._seq,
                    "seen": self._seen,
                    "dropped": self._c_dropped.value,
                    "sampled_out": self._c_sampled_out.value,
                    "sample_every": self.sample_every,
                    "max_records": self.max_records,
                    "full": self._seq >= self.max_records,
                    "closed": self._closed}


@contextlib.contextmanager
def recording(path: str, **kwargs):
    """`with recording(path) as rec:` -- create + install a recorder for
    the block, flush + uninstall on exit (the file stays for replay)."""
    rec = FlightRecorder(path, **kwargs)
    install(rec)
    try:
        yield rec
    finally:
        rec.close()


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CapturedRecord:
    """One decoded capture row."""

    seq: int
    ts_offset: float
    tenant: Optional[str]
    site: str
    spec: Optional[Any]                  # QuerySpec (unpickled) or None
    vecs: Optional[np.ndarray]           # [q, dim] float32 or None
    digest: Optional[str]


def load(path: str, *, t0: float = 0.0, t1: float = float("inf"),
         sites: Optional[Sequence[str]] = None) -> List[CapturedRecord]:
    """Decode a capture file (optionally a [t0, t1) ts_offset window
    and/or a site filter) into replay-ready records, seq-ordered."""
    conn = sqlite3.connect(path)
    try:
        rows = conn.execute(
            "SELECT seq, ts_offset, tenant, site, spec, vecs, q, dim,"
            " digest FROM flight WHERE ts_offset >= ? AND ts_offset < ?"
            " ORDER BY seq", (t0, t1)).fetchall()
    finally:
        conn.close()
    out: List[CapturedRecord] = []
    keep = None if sites is None else set(sites)
    for seq, ts, tenant, site, bspec, bvecs, q, dim, digest in rows:
        if keep is not None and site not in keep:
            continue
        spec = None if bspec is None else pickle.loads(bspec)
        vecs = None
        if bvecs is not None:
            vecs = np.frombuffer(bvecs, np.float32).reshape(q, dim).copy()
        out.append(CapturedRecord(seq=seq, ts_offset=ts, tenant=tenant,
                                  site=site, spec=spec, vecs=vecs,
                                  digest=digest))
    return out


@dataclasses.dataclass
class ReplayMismatch:
    seq: int
    site: str
    tenant: Optional[str]
    expected: str
    got: str


@dataclasses.dataclass
class ReplayReport:
    """What replay() did: every vector-carrying record re-executed, every
    digest checked. `ok` is the bit-parity verdict."""

    replayed: int = 0
    matched: int = 0
    self_checked: int = 0       # no capture digest: double-run parity
    events: int = 0             # fleet.get touches re-applied
    skipped: int = 0            # no engine resolvable for the record
    mismatches: List[ReplayMismatch] = dataclasses.field(
        default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def replay(source, *, engine=None, fleet=None, strict: bool = False,
           t0: float = 0.0, t1: float = float("inf"),
           sites: Optional[Sequence[str]] = None) -> ReplayReport:
    """Re-execute a captured window and assert bit-identical results.

    `source` is a capture path or a list of CapturedRecords. Records
    resolve to an engine by tenant through `fleet` when given (any object
    with `get(tenant)`), else they all run on `engine`.

    Records captured with a result digest are checked capture-vs-replay;
    digestless records (front-door admissions) are executed twice and
    the two runs checked against each other -- either way a mismatch is
    a determinism violation. `strict=True` raises AssertionError on any
    mismatch; the default returns the report for the caller to gate on.
    """
    recs = load(source, t0=t0, t1=t1, sites=sites) \
        if isinstance(source, str) else list(source)
    rep = ReplayReport()
    for r in recs:
        eng = None
        if fleet is not None and r.tenant is not None:
            eng = fleet.get(r.tenant)
        elif engine is not None:
            eng = engine
        if r.site == SITE_FLEET_GET or r.vecs is None:
            if eng is None:
                rep.skipped += 1
            else:
                rep.events += 1
            continue
        if eng is None:
            rep.skipped += 1
            continue
        got = result_digest(eng.query(r.vecs, r.spec))
        if r.digest is not None:
            expect = r.digest
        else:
            expect = result_digest(eng.query(r.vecs, r.spec))
            rep.self_checked += 1
        rep.replayed += 1
        if got == expect:
            rep.matched += 1
        else:
            rep.mismatches.append(ReplayMismatch(
                seq=r.seq, site=r.site, tenant=r.tenant,
                expected=expect, got=got))
    if strict and not rep.ok:
        m = rep.mismatches[0]
        raise AssertionError(
            f"replay diverged on {len(rep.mismatches)}/{rep.replayed} "
            f"records; first: seq={m.seq} site={m.site} "
            f"tenant={m.tenant} {m.expected[:12]} != {m.got[:12]}")
    return rep
