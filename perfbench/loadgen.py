"""The one traffic generator: it reads a mix's parameters (a JSON file under
traffic/) and draws the calls and writes of a run from the seed.

A mix:

    {"loop": "closed", "callers": 1,
     "calls": [{"weight": 1, "batch": 512,
                "spec": {"kind": "ann", "k": 100, "n_probe": 8},
                "predicate": null}],
     "writes": null,
     "warmup_calls": 16, "profile_seconds": 2.0}

- `calls`: the classes of query call, chosen per call by weight. Each draws
  `batch` query vectors from the configuration's held-out pool (distinct
  within a call) and carries the spec's fields (`kind`, `k`, `n_probe`,
  `hybrid`). A `predicate` {"col": c, "op": "lt", "value": v} filters on an
  attribute column; v is a number, {"uniform": [a, b]} or {"int": [a, b]}
  (both ends included), drawn per call.
- `writes`: null, or an open-loop schedule {"period_ms": 100,
  "upsert_new": 16, "upsert_overwrite": 16, "delete": 8}: every period one
  write batch upserts new ids and overwrites and deletes live ids drawn
  from the seed. The one caller applies each batch once it is due, between
  its calls, so every answer is due at a known version of the table.
- `warmup_calls`: calls made in set-up (their own stream), untimed.
- `profile_seconds`: the part of a traced window that the device profiler
  records.

Only "closed" loops with one caller exist so far; anything else is refused
by name.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# independent streams drawn from one seed
_CALLS, _WARMUP, _WRITES = 0, 1, 2


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


@dataclasses.dataclass
class Call:
    cls: int                           # index into the mix's `calls`
    qidx: np.ndarray                   # [batch] int64 rows of the pool
    kind: str                          # "ann" | "exact"
    k: int
    n_probe: int
    hybrid: str
    predicate: Optional[Tuple[int, str, float]]   # (col, op, float32 value)


@dataclasses.dataclass
class Write:
    version: int                       # the table's version after it
    due_s: float                       # seconds after the window's start
    upsert_ids: np.ndarray             # [u] int64 asset ids
    upsert_rows: np.ndarray            # [u] int64 rows of the written rows
    delete_ids: np.ndarray             # [m] int64 asset ids


def _value(v, rng: np.random.Generator) -> float:
    if isinstance(v, dict):
        if "uniform" in v:
            a, b = v["uniform"]
            return float(np.float32(rng.uniform(a, b)))
        if "int" in v:
            a, b = v["int"]
            return float(rng.integers(int(a), int(b) + 1))
        raise ValueError(f"unknown predicate value {v!r}")
    return float(np.float32(v))


class Traffic:
    """The calls and writes of one run of a mix, from the seed."""

    def __init__(self, mix: Dict, seed: int, pool_size: int, n_rows: int):
        if mix.get("loop", "closed") != "closed" or \
                int(mix.get("callers", 1)) != 1:
            raise ValueError("only a closed loop with one caller is "
                             "implemented")
        self.mix = mix
        self.classes: List[Dict] = list(mix["calls"])
        w = np.array([float(c.get("weight", 1.0)) for c in self.classes])
        self._p = w / w.sum()
        self.pool_size = int(pool_size)
        self.seed = int(seed)
        self._call_rng = _rng(seed, _CALLS)
        self._warm_rng = _rng(seed, _WARMUP)
        self.writes = mix.get("writes")
        self._write_rng = _rng(seed, _WRITES)
        self._version = 0
        self._next_row = 0
        self._next_id = int(n_rows)
        self._live = np.ones(int(n_rows), bool)   # grows with new ids

    @property
    def max_batch(self) -> int:
        return max(int(c["batch"]) for c in self.classes)

    def _draw(self, rng: np.random.Generator) -> Call:
        ci = int(rng.choice(len(self.classes), p=self._p)) \
            if len(self.classes) > 1 else 0
        c = self.classes[ci]
        spec = c.get("spec", {})
        batch = int(c["batch"])
        if batch > self.pool_size:
            raise ValueError(f"batch {batch} exceeds the pool of "
                             f"{self.pool_size}")
        qidx = rng.choice(self.pool_size, size=batch, replace=False)
        pred = c.get("predicate")
        if pred is not None:
            pred = (int(pred["col"]), str(pred["op"]),
                    _value(pred["value"], rng))
        return Call(cls=ci, qidx=qidx.astype(np.int64),
                    kind=str(spec.get("kind", "ann")),
                    k=int(spec.get("k", 10)),
                    n_probe=int(spec.get("n_probe", 8)),
                    hybrid=str(spec.get("hybrid", "auto")), predicate=pred)

    def next_call(self) -> Call:
        return self._draw(self._call_rng)

    def warmup_calls(self) -> List[Call]:
        """The set-up's calls: at least one of every class, on their own
        stream (the window's calls do not depend on them)."""
        n = max(int(self.mix.get("warmup_calls", 8)), len(self.classes))
        calls = [self._draw(self._warm_rng) for _ in range(n)]
        seen = {c.cls for c in calls}
        for ci in range(len(self.classes)):
            if ci not in seen:
                while True:
                    c = self._draw(self._warm_rng)
                    if c.cls == ci:
                        calls.append(c)
                        break
        return calls

    # -- writes -----------------------------------------------------------
    def max_written_rows(self, seconds: float) -> int:
        """Rows the writes of a window of `seconds` can consume at most (a
        slow last call may let one more batch fall due)."""
        if not self.writes:
            return 0
        w = self.writes
        per = int(w.get("upsert_new", 0)) + int(w.get("upsert_overwrite", 0))
        batches = int(seconds * 1000.0 / float(w["period_ms"])) + 2
        return per * batches

    def writes_until(self, seconds: float) -> List[Write]:
        """The write batches of the schedule that fall due within `seconds`
        of the window's start, in order (none for a mix that does not
        write)."""
        out = []
        while True:
            w = self.next_write()
            if w is None or w.due_s > seconds:
                return out
            out.append(w)

    def next_write(self) -> Optional[Write]:
        """The next write batch of the schedule (None for a mix that does
        not write)."""
        if not self.writes:
            return None
        w, rng = self.writes, self._write_rng
        live_ids = np.flatnonzero(self._live)
        n_over = min(int(w.get("upsert_overwrite", 0)), len(live_ids))
        over = rng.choice(live_ids, size=n_over, replace=False)
        n_new = int(w.get("upsert_new", 0))
        new = np.arange(self._next_id, self._next_id + n_new)
        self._next_id += n_new
        self._live = np.concatenate([self._live, np.ones(n_new, bool)])
        rest = np.setdiff1d(live_ids, over, assume_unique=True)
        n_del = min(int(w.get("delete", 0)), len(rest))
        dele = rng.choice(rest, size=n_del, replace=False)
        self._live[dele] = False
        ups = np.concatenate([over, new]).astype(np.int64)
        rows = np.arange(self._next_row, self._next_row + len(ups))
        self._next_row += len(ups)
        self._version += 1
        return Write(version=self._version,
                     due_s=self._version * float(w["period_ms"]) / 1000.0,
                     upsert_ids=ups, upsert_rows=rows.astype(np.int64),
                     delete_ids=np.sort(dele).astype(np.int64))
