"""The comparison that decides `correct`: every answer the program gave is
judged against the plain reference (references/<name>.py), over the rows
live at the version of the table the answer was due at.

The table is the configuration's ingested rows (asset id = row) followed
by every row a mix wrote; the write log the harness handed the program is
replayed here to work out, per version, which row holds each live id. A
query vector is a row of the held-out pool, or, for the read-back of
writes, a row of the table (index pool_size + row).

Per answer (one query row of one call):
- bad: ids that are not a prefix of valid entries, an id not live at its
  version or failing the call's predicate, a repeated id, or scores not
  ascending (a short answer is a loss of recall, since a post-filter may
  leave fewer than k hits in the probed partitions);
- recall: the share of min(k, qualifying rows) whose reference distance
  lies within the reference's k-th distance plus 1e-5 x (||q||^2 +
  ||v_k||^2) (swaps between tied scores count as hits);
- score gap: |returned score - the float64 score of the returned id| /
  (||q||^2 + ||v||^2), the worst over all answers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

TIE_TOL = 1e-5


@dataclasses.dataclass
class Answer:
    qidx: np.ndarray          # [B] int64 query rows (pool, then table)
    version: int              # table version the call was due at
    kind: str                 # "ann" | "exact"
    k: int
    predicate: Optional[tuple]
    ids: np.ndarray           # [B, k] int32 (-1: no hit)
    scores: np.ndarray        # [B, k] float32


@dataclasses.dataclass
class Verdict:
    answers: int = 0
    recall_sum: float = 0.0
    score_gap: float = 0.0
    bad_answers: int = 0
    exact_misses: int = 0
    failed_calls: int = 0

    @property
    def recall(self) -> float:
        return self.recall_sum / self.answers if self.answers else 0.0

    def checks(self, limits: Dict) -> Dict[str, Dict]:
        """Each number compared, beside its limit. Exact comparisons have
        the limit 0; recall's limit is the configuration's own."""
        return {
            "failed_calls": {"value": self.failed_calls, "at_most": 0},
            "bad_answers": {"value": self.bad_answers, "at_most": 0},
            "exact_misses": {"value": self.exact_misses, "at_most": 0},
            "recall": {"value": self.recall,
                       "at_least": float(limits["recall_at_least"])},
            "score_gap": {"value": self.score_gap,
                          "at_most": float(limits["score_gap_at_most"])},
        }


def passes(checks: Dict[str, Dict]) -> bool:
    for c in checks.values():
        if "at_most" in c and not c["value"] <= c["at_most"]:
            return False
        if "at_least" in c and not c["value"] >= c["at_least"]:
            return False
    return True


class Table:
    """The rows a run's answers are judged over, and the replay of its
    write log. `rows` [N, d] and `attrs` [N, a] on the judging device;
    `writes` are loadgen.Write batches in version order."""

    def __init__(self, base: torch.Tensor, base_attrs: torch.Tensor,
                 written: Optional[torch.Tensor] = None,
                 written_attrs: Optional[torch.Tensor] = None,
                 writes: Sequence = ()):
        self.n_base = base.shape[0]
        if written is not None and written.shape[0]:
            self.rows = torch.cat([base, written])
            self.attrs = torch.cat([base_attrs, written_attrs])
        else:
            self.rows, self.attrs = base, base_attrs
        self.writes = list(writes)
        max_id = self.n_base - 1
        for w in self.writes:
            if len(w.upsert_ids):
                max_id = max(max_id, int(w.upsert_ids.max()))
        self._row_of_id = np.full(max_id + 1, -1, np.int64)
        self._row_of_id[:self.n_base] = np.arange(self.n_base)
        self._applied = 0
        self.version = 0

    def advance(self, version: int) -> None:
        """Replay the write log up to `version` (versions only grow)."""
        if version < self.version:
            raise ValueError("versions are judged in increasing order")
        while self._applied < len(self.writes) and \
                self.writes[self._applied].version <= version:
            w = self.writes[self._applied]
            self._row_of_id[w.upsert_ids] = self.n_base + w.upsert_rows
            self._row_of_id[w.delete_ids] = -1
            self._applied += 1
        self.version = version

    def live_rows(self) -> torch.Tensor:
        live = torch.zeros(self.rows.shape[0], dtype=torch.bool,
                           device=self.rows.device)
        r = self._row_of_id[self._row_of_id >= 0]
        live[torch.as_tensor(r, device=self.rows.device)] = True
        return live

    def rows_of(self, ids: torch.Tensor) -> torch.Tensor:
        """Asset ids -> the rows holding them now (-1: not live)."""
        lut = torch.as_tensor(self._row_of_id, device=ids.device)
        inside = (ids >= 0) & (ids < lut.shape[0])
        return torch.where(inside, lut[ids.clamp(0, lut.shape[0] - 1)],
                           torch.full_like(ids, -1))


def judge(ref, table: Table, pool: torch.Tensor, answers: List[Answer],
          metric: str, failed_calls: int = 0,
          block_rows: int = 8192) -> Verdict:
    """Judge every answer. `ref` is the reference module."""
    verdict = Verdict(failed_calls=failed_calls)
    groups: Dict[tuple, List[Answer]] = {}
    for a in answers:
        groups.setdefault((a.version, a.predicate), []).append(a)
    for key in sorted(groups, key=lambda g: g[0]):
        version, pred = key
        table.advance(version)
        ok = table.live_rows() & ref.pred_mask(table.attrs, pred)
        _judge_group(ref, table, pool, groups[key], ok, metric, verdict,
                     block_rows)
    return verdict


def _qvec(pool: torch.Tensor, table: Table, qidx: torch.Tensor):
    P = pool.shape[0]
    from_pool = qidx < P
    out = torch.empty((qidx.shape[0], pool.shape[1]), dtype=torch.float32,
                      device=pool.device)
    out[from_pool] = pool[qidx[from_pool]]
    out[~from_pool] = table.rows[qidx[~from_pool] - P]
    return out


def _judge_group(ref, table, pool, group, ok, metric, verdict, block_rows):
    dev = table.rows.device
    n_ok = int(ok.sum())
    K = max(a.k for a in group)
    uq = np.unique(np.concatenate([a.qidx for a in group]))
    loc = np.full(int(uq.max()) + 1, -1, np.int64)
    loc[uq] = np.arange(len(uq))
    # the reference's k-th distance of every query, for every k asked
    uq_t = torch.as_tensor(uq, device=dev)
    kth = torch.empty((len(uq), K), dtype=torch.float64, device=dev)
    tol = torch.empty((len(uq), K), dtype=torch.float64, device=dev)
    for a in range(0, len(uq), 1024):
        qv = _qvec(pool, table, uq_t[a:a + 1024])
        _, rows = ref.exact_topk(table.rows, ok, qv, K, metric)
        got = rows >= 0
        d, scale = ref.true_dist(qv, table.rows[rows.clamp(min=0)], metric)
        d = torch.where(got, d, torch.full_like(d, float("inf")))
        d, order = torch.sort(d, dim=1)
        scale = torch.gather(scale, 1, order)
        kth[a:a + qv.shape[0]] = d
        tol[a:a + qv.shape[0]] = TIE_TOL * scale
    batch: List[Answer] = []
    rows_in = 0
    for i, a in enumerate(group):
        batch.append(a)
        rows_in += len(a.qidx)
        if rows_in >= block_rows or i == len(group) - 1:
            by_k: Dict[tuple, List[Answer]] = {}
            for b in batch:
                by_k.setdefault((b.k, b.kind), []).append(b)
            for (k, kind), bs in by_k.items():
                _judge_block(ref, table, pool, bs, k, kind, ok, n_ok, loc,
                             kth, tol, metric, verdict)
            batch, rows_in = [], 0


def _judge_block(ref, table, pool, bs, k, kind, ok, n_ok, loc, kth, tol,
                 metric, verdict):
    dev = table.rows.device
    qidx = np.concatenate([b.qidx for b in bs])
    ids = torch.as_tensor(np.concatenate([b.ids for b in bs]),
                          device=dev).to(torch.int64)
    s = torch.as_tensor(np.concatenate([b.scores for b in bs]), device=dev)
    if ids.shape[1] != k:
        raise ValueError(f"an answer has {ids.shape[1]} columns for k={k}")
    valid = ids >= 0
    rows = table.rows_of(ids)
    live = valid & (rows >= 0)
    live = live & ok[rows.clamp(min=0)]
    expected = min(k, n_ok)
    bad = (valid[:, 1:] & ~valid[:, :-1]).any(1)
    bad |= (valid & ~live).any(1)
    sid = torch.sort(torch.where(valid, ids, torch.full_like(ids, -1)),
                     dim=1).values
    bad |= ((sid[:, 1:] == sid[:, :-1]) & (sid[:, 1:] >= 0)).any(1)
    pair = valid[:, 1:] & valid[:, :-1]
    bad |= (pair & (s[:, 1:] < s[:, :-1])).any(1)
    qv = _qvec(pool, table, torch.as_tensor(qidx, device=dev))
    d, scale = ref.true_dist(qv, table.rows[rows.clamp(min=0)], metric)
    scale = scale.clamp(min=torch.finfo(torch.float64).tiny)
    gap = torch.where(live, (s.to(torch.float64) - d).abs() / scale,
                      torch.zeros_like(d))
    gap = torch.nan_to_num(gap, nan=float("inf"))
    li = torch.as_tensor(loc[qidx], device=dev)
    limit = (kth[li, k - 1] + tol[li, k - 1])[:, None]
    # a repeated id is a bad answer already; count each id once here
    first = torch.ones_like(valid)
    o = torch.argsort(torch.where(valid, ids, torch.full_like(ids, -1)),
                      dim=1, stable=True)
    so = torch.gather(ids, 1, o)
    dup_sorted = torch.zeros_like(valid)
    dup_sorted[:, 1:] = so[:, 1:] == so[:, :-1]
    first.scatter_(1, o, ~dup_sorted)
    hits = (live & first & (d <= limit)).sum(1).to(torch.float64)
    recall = hits / expected if expected else torch.ones_like(hits)
    verdict.answers += int(ids.shape[0])
    verdict.recall_sum += float(recall.sum())
    verdict.score_gap = max(verdict.score_gap, float(gap.max()))
    verdict.bad_answers += int(bad.sum())
    if kind == "exact":
        verdict.exact_misses += int((recall < 1.0).sum())
