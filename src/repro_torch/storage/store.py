"""SQLite-backed durable vector store -- the paper's physical storage tier
(§3.2), verbatim where it matters:

  * WAL journal mode -> ACID upserts/deletes, single writer + concurrent
    snapshot readers (paper §3.6);
  * `vectors` is a WITHOUT ROWID table with PRIMARY KEY
    (partition_id, asset_id) -> a *clustered* index: rows are physically
    ordered by partition id, so a partition scan is sequential I/O;
  * centroids and attributes live in side tables (paper Fig. 2);
  * the delta-store is partition id -1 (the paper's "reserved partition
    identifier");
  * index rebuilds write a new *generation* and swap atomically -- readers
    keep a consistent view during maintenance (paper: "index rebuilds ...
    concurrently with transactionally consistent reads").

A copy of repro.storage.store with the same schema byte for byte, so a
database file written by either package opens in the other. This layer
runs on the host: the durable home of the index, the source of device
uploads, and in paged mode the scan tier itself (batched partition scans
feed the frame pool, per-asset gathers feed the rerank).

The query path's reads -- `scan_partitions` (the pager's faults and
read-ahead) and `vectors_for` (the paged rerank's gather) -- bump the
cumulative `rows_read` and `bytes_read` counters of the store's
`component=store` metrics scope once per call: the rows the call returned
and their payload bytes (vector and code blobs, 4 bytes an attribute).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sqlite3
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics as obs_metrics

# SQLite bound-parameter ceiling (999 before 3.32); chunk IN (...) queries.
_PARAM_CHUNK = 500

# The asset-id index over the clustered vector table. _create makes it and
# set_partitions rebuilds it with this one statement, so sqlite_master holds
# the same text either way, byte for byte repro.storage.store's.
_CREATE_VECTORS_BY_ASSET = ("CREATE UNIQUE INDEX IF NOT EXISTS"
                            " vectors_by_asset ON vectors(asset_id)")


@dataclasses.dataclass
class PartitionBlocks:
    """One batched probe-set fetch, packed as padded partition frames.

    Arrays are aligned to the requested pid order: frame j holds partition
    pids[j]. `vecs` rows are the raw durable vectors (the pager applies
    metric normalisation); `code_ok` marks rows whose int8 code existed in
    the durable side table (False rows are re-encoded by the caller)."""

    vecs: Optional[np.ndarray]          # [m, p_max, d] f32 (None if skipped)
    ids: np.ndarray                     # [m, p_max] int32 (-1 padding)
    valid: np.ndarray                   # [m, p_max] bool
    codes: Optional[np.ndarray] = None  # [m, p_max, d] int8
    code_ok: Optional[np.ndarray] = None  # [m, p_max] bool
    attrs: Optional[np.ndarray] = None  # [m, p_max, n_attr] float32


class VectorStore:
    def __init__(self, path: str = ":memory:", dim: int = 128,
                 n_attr: int = 0, metrics=None):
        """`metrics` is the scope the read counters register under (the
        engine passes its `component=store` scope); a standalone store
        gets a fresh instance label."""
        self.path = path
        self.dim = dim
        self.n_attr = n_attr
        if metrics is None:
            metrics = obs_metrics.default_registry().scope(
                component="store", inst=obs_metrics.next_instance())
        self._c_rows_read = metrics.counter("rows_read")
        self._c_bytes_read = metrics.counter("bytes_read")
        # autocommit connection: transaction boundaries are owned by
        # transaction() below, which NESTS -- a write session wraps many
        # store calls in one outer BEGIN...COMMIT (paper §3.6's batched
        # single-writer commit), while standalone calls still get their
        # own transaction. check_same_thread=False lets the background
        # maintenance scheduler and the pager's locked fault path use the
        # connection from worker threads; callers must serialise access
        # (PartitionCache holds an RLock around every store call, and the
        # engine's write path is single-writer by contract).
        self.db = sqlite3.connect(path, isolation_level=None,
                                  check_same_thread=False)
        self.db.execute("PRAGMA journal_mode=WAL")
        self.db.execute("PRAGMA synchronous=NORMAL")
        self._txn_depth = 0
        self._create()
        # Snapshot read connection (file-backed stores only): attribute,
        # code and centroid reads go through a second connection, so WAL
        # shows them committed states only, never another thread's open
        # write transaction. An in-memory database is private to its
        # connection, so `:memory:` stores keep one connection.
        self._rdb: Optional[sqlite3.Connection] = None
        if path != ":memory:":
            self._rdb = sqlite3.connect(path, isolation_level=None,
                                        check_same_thread=False)

    @property
    def snapshot_reads(self) -> bool:
        """True when reads run on the dedicated WAL snapshot connection
        (a file-backed store): the precondition for serving queries beside
        writers without the engine's write mutex (serving/frontdoor.py)."""
        return self._rdb is not None

    @property
    def read_db(self) -> sqlite3.Connection:
        """Connection for query-path reads: the WAL snapshot connection
        when available, else the write connection."""
        return self._rdb if self._rdb is not None else self.db

    @contextlib.contextmanager
    def transaction(self):
        """Nestable transaction scope: only the outermost level runs
        BEGIN/COMMIT (ROLLBACK on any exception), so engine-level batch
        operations -- MicroNN.session() commits above all -- can compose
        store primitives into one atomic durable write."""
        if self._txn_depth == 0:
            self.db.execute("BEGIN IMMEDIATE")
        self._txn_depth += 1
        try:
            yield
        except BaseException:
            self._txn_depth -= 1
            if self._txn_depth == 0:
                self.db.execute("ROLLBACK")
            raise
        else:
            self._txn_depth -= 1
            if self._txn_depth == 0:
                try:
                    self.db.execute("COMMIT")
                except BaseException:
                    # a failed COMMIT (disk full, ...) leaves the SQLite
                    # transaction open: roll it back so the connection is
                    # not wedged for every later transaction() scope
                    try:
                        self.db.execute("ROLLBACK")
                    except sqlite3.Error:
                        pass
                    raise

    # -- schema -------------------------------------------------------------
    def _create(self):
        attr_cols = ", ".join(f"a{i} REAL DEFAULT 0" for i in range(self.n_attr))
        attr_cols = (", " + attr_cols) if attr_cols else ""
        with self.transaction():
            self.db.execute(
                "CREATE TABLE IF NOT EXISTS vectors ("
                " partition_id INTEGER NOT NULL,"
                " asset_id INTEGER NOT NULL,"
                " vec BLOB NOT NULL,"
                " PRIMARY KEY (partition_id, asset_id)) WITHOUT ROWID")
            self.db.execute(_CREATE_VECTORS_BY_ASSET)
            self.db.execute(
                "CREATE TABLE IF NOT EXISTS centroids ("
                " generation INTEGER NOT NULL,"
                " partition_id INTEGER NOT NULL,"
                " vec BLOB NOT NULL, csize REAL DEFAULT 0,"
                " PRIMARY KEY (generation, partition_id)) WITHOUT ROWID")
            self.db.execute(
                f"CREATE TABLE IF NOT EXISTS attributes ("
                f" asset_id INTEGER PRIMARY KEY{attr_cols})")
            # int8 SQ code tier (paper's low-memory resident scan): codes
            # are durable alongside the float32 vectors so recover() can
            # restore the quantized index without re-encoding; quantizer
            # stats live in `meta` under "qstats".
            self.db.execute(
                "CREATE TABLE IF NOT EXISTS codes ("
                " asset_id INTEGER PRIMARY KEY, code BLOB NOT NULL)")
            self.db.execute(
                "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v TEXT)")
            if self._meta("generation") is None:
                self._set_meta("generation", "0")

    def _meta(self, k: str) -> Optional[str]:
        row = self.db.execute("SELECT v FROM meta WHERE k=?", (k,)).fetchone()
        return row[0] if row else None

    def _set_meta(self, k: str, v: str):
        self.db.execute(
            "INSERT INTO meta(k, v) VALUES (?, ?)"
            " ON CONFLICT(k) DO UPDATE SET v=excluded.v", (k, v))

    @property
    def generation(self) -> int:
        return int(self._meta("generation") or 0)

    # -- writes (single writer; each call is one transaction) ---------------
    def upsert(self, asset_ids: Sequence[int], vecs: np.ndarray,
               attrs: Optional[np.ndarray] = None, partition_id: int = -1):
        """Upsert into the given partition (-1 = delta-store)."""
        vecs = np.ascontiguousarray(vecs, np.float32)
        with self.transaction():
            self.db.executemany(
                "DELETE FROM vectors WHERE asset_id=?",
                [(int(a),) for a in asset_ids])
            self.db.executemany(
                "INSERT INTO vectors(partition_id, asset_id, vec)"
                " VALUES (?, ?, ?)",
                [(partition_id, int(a), v.tobytes())
                 for a, v in zip(asset_ids, vecs)])
            if attrs is not None and self.n_attr:
                cols = ", ".join(f"a{i}" for i in range(self.n_attr))
                ph = ", ".join("?" * (self.n_attr + 1))
                self.db.executemany(
                    f"INSERT OR REPLACE INTO attributes(asset_id, {cols})"
                    f" VALUES ({ph})",
                    [(int(a), *map(float, row))
                     for a, row in zip(asset_ids, attrs)])

    def delete(self, asset_ids: Sequence[int]):
        with self.transaction():
            self.db.executemany("DELETE FROM vectors WHERE asset_id=?",
                                [(int(a),) for a in asset_ids])
            self.db.executemany("DELETE FROM attributes WHERE asset_id=?",
                                [(int(a),) for a in asset_ids])
            self.db.executemany("DELETE FROM codes WHERE asset_id=?",
                                [(int(a),) for a in asset_ids])

    def _gather_by_asset(self, cols: str, table: str,
                         asset_ids: Sequence[int]):
        """Shared scaffolding for every batched asset-id gather: dedup the
        wanted ids, chunk the IN (...) under the bound-parameter limit,
        and yield (row, output_index) -- duplicates in `asset_ids` map to
        every requesting position."""
        pos: dict = {}
        for j, a in enumerate(asset_ids):
            pos.setdefault(int(a), []).append(j)
        want = list(pos)
        for s in range(0, len(want), _PARAM_CHUNK):
            chunk = want[s:s + _PARAM_CHUNK]
            ph = ", ".join("?" * len(chunk))
            for row in self.read_db.execute(
                    f"SELECT asset_id, {cols} FROM {table}"
                    f" WHERE asset_id IN ({ph})", chunk):
                for j in pos[row[0]]:
                    yield row, j

    # -- quantized tier ------------------------------------------------------
    def codes_for(self, asset_ids: Sequence[int]
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """([n, d] int8 codes, [n] found mask) for the given assets; the
        caller decides how to fill rows with no durable code (the engine
        re-encodes them from the float32 tier)."""
        out = np.zeros((len(asset_ids), self.dim), np.int8)
        found = np.zeros((len(asset_ids),), bool)
        for (_, blob), j in self._gather_by_asset("code", "codes",
                                                  asset_ids):
            out[j] = np.frombuffer(blob, np.int8)
            found[j] = True
        return out, found

    def set_code_tier(self, asset_ids: Sequence[int], codes: np.ndarray,
                      lo: np.ndarray, scale: np.ndarray):
        """Atomically persist codes + quantizer stats in one transaction:
        a crash never leaves codes decodable with the wrong stats."""
        self.set_code_tier_streaming(iter([(asset_ids, codes)]), lo, scale)

    def set_code_tier_streaming(self, chunks, lo: np.ndarray,
                                scale: np.ndarray):
        """set_code_tier over a stream of (asset_ids, codes) chunks, all
        inside ONE transaction -- the paged build encodes batch-by-batch
        without losing the codes-consistent-with-stats crash guarantee.
        Each chunk is written in asset-id order, the `codes` B-tree's key
        order: a whole-tier write fills it front to back instead of
        landing every row on a random page. The sort is stable, so a
        repeated id still keeps its last code."""
        with self.transaction():
            for asset_ids, codes in chunks:
                ids = np.asarray(asset_ids, np.int64)
                order = np.argsort(ids, kind="stable")
                codes = np.ascontiguousarray(codes, np.int8)[order]
                self.db.executemany(
                    "INSERT OR REPLACE INTO codes(asset_id, code)"
                    " VALUES (?, ?)",
                    zip(ids[order].tolist(), (c.tobytes() for c in codes)))
            self._set_meta("qstats", json.dumps(
                {"lo": [float(x) for x in lo],
                 "scale": [float(x) for x in scale]}))

    def qstats(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        raw = self._meta("qstats")
        if raw is None:
            return None
        d = json.loads(raw)
        return (np.asarray(d["lo"], np.float32),
                np.asarray(d["scale"], np.float32))

    # -- maintenance state ---------------------------------------------------
    def set_maintenance_state(self, base_mean_size: float,
                              drift: np.ndarray):
        """Persist the monitor's maintenance signals (per-partition
        accumulated centroid drift + the rebuild baseline mean size) so a
        recovered index resumes maintenance where the crashed process left
        off, instead of resetting drift to zero and mis-timing the next
        local repair."""
        with self.transaction():
            self._set_meta("maintenance", json.dumps(
                {"base_mean_size": float(base_mean_size),
                 "drift": [float(x) for x in np.asarray(drift)]}))

    def maintenance_state(self) -> Optional[Tuple[float, np.ndarray]]:
        raw = self._meta("maintenance")
        if raw is None:
            return None
        d = json.loads(raw)
        return (float(d["base_mean_size"]),
                np.asarray(d["drift"], np.float32))

    def set_partitions(self, asset_ids: np.ndarray, partition_ids: np.ndarray,
                       centroids: np.ndarray, csizes: np.ndarray):
        """Atomically install a new clustering generation (paper: the
        partition IDs in the vector table are updated after (re)clustering).
        The clustered PK physically re-orders rows by partition.

        The rows go back in the table's key order (partition_id, asset_id),
        with `vectors_by_asset` dropped before and rebuilt once after, all
        inside the one transaction: both B-trees fill front to back rather
        than taking each row on a random page. An exception anywhere (an
        asset id absent from the store, say) rolls back to the previous
        generation with its rows and its index."""
        gen = self.generation + 1
        asset_ids = np.asarray(asset_ids, np.int64)
        partition_ids = np.asarray(partition_ids, np.int64)
        order = np.lexsort((asset_ids, partition_ids))
        with self.transaction():
            by_id = dict(self.db.execute("SELECT asset_id, vec FROM vectors"))
            self.db.execute("DROP INDEX vectors_by_asset")
            self.db.execute("DELETE FROM vectors")
            self.db.executemany(
                "INSERT INTO vectors(partition_id, asset_id, vec)"
                " VALUES (?, ?, ?)",
                ((p, a, by_id[a]) for p, a in zip(
                    partition_ids[order].tolist(),
                    asset_ids[order].tolist())))
            self.db.execute(_CREATE_VECTORS_BY_ASSET)
            self.db.executemany(
                "INSERT INTO centroids(generation, partition_id, vec, csize)"
                " VALUES (?, ?, ?, ?)",
                [(gen, i, np.ascontiguousarray(c, np.float32).tobytes(),
                  float(s))
                 for i, (c, s) in enumerate(zip(centroids, csizes))])
            self.db.execute("DELETE FROM centroids WHERE generation < ?",
                            (gen,))
            self._set_meta("generation", str(gen))

    def reassign_partitions(self, asset_ids: Sequence[int],
                            partition_ids: Sequence[int],
                            centroids: np.ndarray, csizes: np.ndarray):
        """Install a new clustering generation without materialising the
        vector blobs (the paged build's swap): partition ids move by keyed
        UPDATEs against the clustered primary key (SQLite re-inserts each
        row at its new key), centroids swap generations atomically. Same
        contract as set_partitions, O(1) vector bytes in host memory."""
        gen = self.generation + 1
        with self.transaction():
            self.db.executemany(
                "UPDATE vectors SET partition_id=? WHERE asset_id=?",
                [(int(p), int(a))
                 for a, p in zip(asset_ids, partition_ids)])
            self.db.executemany(
                "INSERT INTO centroids(generation, partition_id, vec, csize)"
                " VALUES (?, ?, ?, ?)",
                [(gen, i, np.ascontiguousarray(c, np.float32).tobytes(),
                  float(s))
                 for i, (c, s) in enumerate(zip(centroids, csizes))])
            self.db.execute("DELETE FROM centroids WHERE generation < ?",
                            (gen,))
            self._set_meta("generation", str(gen))

    def iter_asset_ids(self) -> np.ndarray:
        """All asset ids in the clustered scan order (the order
        iter_batches streams the vectors in)."""
        return np.array([r[0] for r in self.db.execute(
            "SELECT asset_id FROM vectors"
            " ORDER BY partition_id, asset_id")], np.int64)

    def apply_repair(self, moved_ids: Sequence[int],
                     moved_pids: Sequence[int],
                     touched_pids: Sequence[int],
                     centroids: np.ndarray, csizes: np.ndarray):
        """Persist one local repair (the paged flush's row moves) in ONE
        transaction at the current generation: the moved rows' keyed
        partition UPDATEs and the touched partitions' centroid rows.
        `centroids`/`csizes` are aligned to `touched_pids`."""
        gen = self.generation
        with self.transaction():
            self.db.executemany(
                "UPDATE vectors SET partition_id=? WHERE asset_id=?",
                [(int(p), int(a))
                 for a, p in zip(moved_ids, moved_pids)])
            self.db.executemany(
                "INSERT OR REPLACE INTO centroids"
                " (generation, partition_id, vec, csize) VALUES (?, ?, ?, ?)",
                [(gen, int(p),
                  np.ascontiguousarray(c, np.float32).tobytes(), float(s))
                 for p, c, s in zip(touched_pids, centroids, csizes)])

    def update_centroids(self, centroids: np.ndarray, csizes: np.ndarray):
        gen = self.generation
        with self.transaction():
            self.db.executemany(
                "INSERT OR REPLACE INTO centroids"
                " (generation, partition_id, vec, csize) VALUES (?, ?, ?, ?)",
                [(gen, i, np.ascontiguousarray(c, np.float32).tobytes(),
                  float(s))
                 for i, (c, s) in enumerate(zip(centroids, csizes))])

    # -- reads (snapshot-consistent within one connection txn) --------------
    def count(self) -> int:
        return self.read_db.execute(
            "SELECT COUNT(*) FROM vectors").fetchone()[0]

    def scan_partition(self, pid: int) -> Tuple[np.ndarray, np.ndarray]:
        """(asset ids [m] int64, raw vectors [m, d]) of one partition in
        asset-id order (-1: the pending delta rows)."""
        rows = self.read_db.execute(
            "SELECT asset_id, vec FROM vectors WHERE partition_id=?"
            " ORDER BY asset_id", (pid,)).fetchall()
        if not rows:
            return (np.zeros((0,), np.int64),
                    np.zeros((0, self.dim), np.float32))
        ids = np.fromiter((r[0] for r in rows), np.int64, count=len(rows))
        vecs = np.frombuffer(b"".join(r[1] for r in rows), np.float32) \
            .reshape(len(rows), self.dim).copy()
        return ids, vecs

    def scan_partitions(self, pids: Sequence[int], p_max: int,
                        with_codes: bool = False,
                        with_attrs: bool = False,
                        with_vecs: bool = True) -> PartitionBlocks:
        """Batched probe-set fetch (the pager's fault path): every listed
        partition in one SQL round-trip (chunked only by the bound-parameter
        limit), packed into padded [m, p_max, *] frame blocks. The clustered
        (partition_id, asset_id) key makes each partition a sequential range
        scan; codes and attributes ride along by LEFT JOIN. `with_vecs=False`
        skips the float32 blobs (an int8 fault then reads 4x fewer bytes;
        the rare code-less row is backfilled by the caller via vectors_for).
        Packing is vectorised: one blob join and one scatter per column."""
        m = len(pids)
        want = [int(p) for p in pids]
        if len(set(want)) != m:
            raise ValueError("duplicate partition ids in one fetch")
        vecs = np.zeros((m, p_max, self.dim), np.float32) if with_vecs \
            else None
        ids = np.full((m, p_max), -1, np.int32)
        valid = np.zeros((m, p_max), bool)
        codes = np.zeros((m, p_max, self.dim), np.int8) if with_codes \
            else None
        code_ok = np.zeros((m, p_max), bool) if with_codes else None
        n_attr = self.n_attr if with_attrs else 0
        attrs = np.zeros((m, p_max, n_attr), np.float32) if with_attrs \
            else None
        cols = "v.partition_id, v.asset_id"
        if with_vecs:
            cols += ", v.vec"
        joins = ""
        if with_codes:
            cols += ", c.code"
            joins += " LEFT JOIN codes c ON c.asset_id = v.asset_id"
        if with_attrs and self.n_attr:
            cols += ", " + ", ".join(f"a.a{i}" for i in range(self.n_attr))
            joins += " LEFT JOIN attributes a ON a.asset_id = v.asset_id"
        n_read = n_bytes = 0
        for s in range(0, m, _PARAM_CHUNK):
            chunk = want[s:s + _PARAM_CHUNK]
            ph = ", ".join("?" * len(chunk))
            rows = self.read_db.execute(
                f"SELECT {cols} FROM vectors v{joins}"
                f" WHERE v.partition_id IN ({ph})"
                f" ORDER BY v.partition_id, v.asset_id", chunk).fetchall()
            if not rows:
                continue
            nr = len(rows)
            n_read += nr
            pid_col = np.fromiter((r[0] for r in rows), np.int64, nr)
            # pid -> block row: slot of chunk[t] is s + t, recovered by a
            # searchsorted over the sorted chunk
            sidx = np.argsort(np.asarray(chunk, np.int64), kind="stable")
            j_col = (s + sidx)[np.searchsorted(
                np.asarray(chunk, np.int64)[sidx], pid_col)]
            # slot within the partition: rows arrive grouped by pid (the
            # ORDER BY), so it is the offset from each group's start
            starts = np.flatnonzero(
                np.r_[True, pid_col[1:] != pid_col[:-1]])
            counts = np.diff(np.r_[starts, nr])
            if counts.max() > p_max:
                big = pid_col[starts[np.argmax(counts)]]
                raise ValueError(
                    f"partition {big} overflows frame p_max={p_max}")
            i_col = np.arange(nr) - np.repeat(starts, counts)
            ids[j_col, i_col] = np.fromiter(
                (r[1] for r in rows), np.int64, nr)
            valid[j_col, i_col] = True
            c = 2
            if with_vecs:
                vecs[j_col, i_col] = np.frombuffer(
                    b"".join(r[c] for r in rows),
                    np.float32).reshape(nr, self.dim)
                n_bytes += nr * 4 * self.dim
                c += 1
            if with_codes:
                blobs = [r[c] for r in rows]
                ok = np.fromiter((b is not None for b in blobs), bool, nr)
                sel = np.flatnonzero(ok)
                if len(sel):
                    codes[j_col[sel], i_col[sel]] = np.frombuffer(
                        b"".join(blobs[t] for t in sel),
                        np.int8).reshape(len(sel), self.dim)
                    code_ok[j_col[sel], i_col[sel]] = True
                n_bytes += len(sel) * self.dim
                c += 1
            if with_attrs and self.n_attr:
                arows = [r[c:c + self.n_attr] for r in rows]
                sel = np.flatnonzero(np.fromiter(
                    (a[0] is not None for a in arows), bool, nr))
                if len(sel):
                    attrs[j_col[sel], i_col[sel]] = np.asarray(
                        [arows[t] for t in sel], np.float32)
                n_bytes += len(sel) * 4 * self.n_attr
        self._count_read(n_read, n_bytes)
        return PartitionBlocks(vecs=vecs, ids=ids, valid=valid, codes=codes,
                               code_ok=code_ok, attrs=attrs)

    def vectors_for(self, asset_ids: Sequence[int]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """([n, d] f32 raw vectors, [n] found mask) for the given assets in
        one batched IN (...) query -- the paged rerank's disk gather."""
        out = np.zeros((len(asset_ids), self.dim), np.float32)
        found = np.zeros((len(asset_ids),), bool)
        n_read, last = 0, None
        for row, j in self._gather_by_asset("vec", "vectors", asset_ids):
            out[j] = np.frombuffer(row[1], np.float32)
            found[j] = True
            # a repeated id is yielded again with the same row, read once
            if row is not last:
                n_read, last = n_read + 1, row
        self._count_read(n_read, n_read * 4 * self.dim)
        return out, found

    def _count_read(self, rows: int, nbytes: int):
        """One bump of the read counters for a whole call."""
        self._c_rows_read.inc(rows)
        self._c_bytes_read.inc(nbytes)

    def partitions_for(self, asset_ids: Sequence[int]) -> np.ndarray:
        """asset id -> current partition id (-2 where the asset is absent;
        -1 is the delta partition)."""
        out = np.full((len(asset_ids),), -2, np.int64)
        for (_, p), j in self._gather_by_asset("partition_id", "vectors",
                                               asset_ids):
            out[j] = p
        return out

    def partition_counts(self, k: int) -> np.ndarray:
        """[k] live main-tier rows per partition (one GROUP BY scan)."""
        out = np.zeros((k,), np.int64)
        for p, c in self.read_db.execute(
                "SELECT partition_id, COUNT(*) FROM vectors"
                " WHERE partition_id >= 0 GROUP BY partition_id"):
            if 0 <= p < k:
                out[p] = c
        return out

    def iter_batches(self, batch_size: int) -> Iterator[np.ndarray]:
        """Stream all vectors partition-ordered (clustered scan)."""
        cur = self.db.execute(
            "SELECT vec FROM vectors ORDER BY partition_id, asset_id")
        while True:
            rows = cur.fetchmany(batch_size)
            if not rows:
                return
            yield np.frombuffer(b"".join(r[0] for r in rows),
                                np.float32).reshape(len(rows),
                                                    self.dim).copy()

    def sample(self, size: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform random row sample with replacement, in the clustered
        scan's row numbering (the mini-batch k-means feed): the same draws
        as the JAX package's for the same generator state."""
        n = self.count()
        if n == 0:
            return np.zeros((0, self.dim), np.float32)
        idx = sorted(int(i) for i in rng.integers(0, n, size=size))
        out = []
        cur = self.db.execute(
            "SELECT vec FROM vectors ORDER BY partition_id, asset_id")
        want = iter(idx)
        nxt = next(want, None)
        for i, row in enumerate(cur):
            while nxt is not None and nxt == i:
                out.append(np.frombuffer(row[0], np.float32))
                nxt = next(want, None)
            if nxt is None:
                break
        return np.stack(out) if out else np.zeros((0, self.dim), np.float32)

    def centroids(self) -> Tuple[np.ndarray, np.ndarray]:
        rows = self.read_db.execute(
            "SELECT vec, csize FROM centroids WHERE generation=?"
            " ORDER BY partition_id", (self.generation,)).fetchall()
        if not rows:
            return np.zeros((0, self.dim), np.float32), np.zeros((0,))
        return (np.stack([np.frombuffer(r[0], np.float32) for r in rows]),
                np.array([r[1] for r in rows], np.float32))

    def all_rows(self):
        rows = self.db.execute(
            "SELECT asset_id, partition_id, vec FROM vectors"
            " ORDER BY partition_id, asset_id").fetchall()
        ids = np.array([r[0] for r in rows], np.int64)
        parts = np.array([r[1] for r in rows], np.int64)
        vecs = np.stack([np.frombuffer(r[2], np.float32) for r in rows]) \
            if rows else np.zeros((0, self.dim), np.float32)
        return ids, parts, vecs

    def attributes_for(self, asset_ids: np.ndarray) -> np.ndarray:
        """Batched attribute gather: one IN (...) query per parameter
        chunk instead of a fetchone round-trip per asset id."""
        if not self.n_attr:
            return np.zeros((len(asset_ids), 0), np.float32)
        cols = ", ".join(f"a{i}" for i in range(self.n_attr))
        out = np.zeros((len(asset_ids), self.n_attr), np.float32)
        for row, j in self._gather_by_asset(cols, "attributes", asset_ids):
            out[j] = row[1:]
        return out

    def close(self):
        if self._rdb is not None:
            self._rdb.close()
        self.db.close()
