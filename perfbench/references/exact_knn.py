"""The plain reference of a k-nearest-neighbour store: exact top-k over the
rows live at a version of the table, under an attribute predicate, with
scores in the store's convention (l2: the squared distance; cosine: minus
the cosine similarity; smaller is better).

Plain PyTorch: it imports nothing of the program. Float32 products run with
TF32 off; the distances an answer is judged by are worked out in float64.
`rank_scores(..., tf32=True)` is the same computation one precision lower
(TF32 products), the control that must come out not correct: on the card
by the TF32 tensor-core path, on the CPU by rounding the products' inputs
to TF32's 10-bit mantissa.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_OPS = {"lt": torch.lt, "<": torch.lt, "le": torch.le, "<=": torch.le,
        "gt": torch.gt, ">": torch.gt, "ge": torch.ge, ">=": torch.ge,
        "eq": torch.eq, "==": torch.eq, "ne": torch.ne, "!=": torch.ne}

# scores of rows that do not qualify
_MASKED = float("inf")


def no_tf32() -> None:
    """Float32 products in float32 (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def pred_mask(attrs: torch.Tensor, pred) -> torch.Tensor:
    """[N] bool: rows whose attribute column satisfies (col, op, value),
    compared in float32 as the attributes are stored."""
    if pred is None:
        return torch.ones(attrs.shape[0], dtype=torch.bool,
                          device=attrs.device)
    col, op, value = pred
    v = torch.tensor(value, dtype=torch.float32, device=attrs.device)
    return _OPS[op](attrs[:, int(col)], v)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits, nearest, ties to even)."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    lsb = (b >> 13) & 1
    b = ((b + 0xFFF + lsb) >> 13) << 13
    return b.to(torch.int32).view(torch.float32)


def _dots(q: torch.Tensor, x: torch.Tensor, tf32: bool) -> torch.Tensor:
    if not tf32:
        return q @ x.T
    if q.device.type != "cuda":
        return _tf32_round(q) @ _tf32_round(x).T
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return q @ x.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def rank_scores(q: torch.Tensor, x: torch.Tensor, metric: str,
                tf32: bool = False) -> torch.Tensor:
    """[Q, d] x [N, d] -> [Q, N] float32 scores in the store's convention.
    Cosine inputs must be normalised already."""
    dots = _dots(q, x, tf32)
    if metric == "cosine":
        return -dots
    if metric != "l2":
        raise ValueError(f"unknown metric {metric!r}")
    return (q * q).sum(-1, keepdim=True) + (x * x).sum(-1)[None, :] \
        - 2.0 * dots


def exact_topk(table: torch.Tensor, ok: torch.Tensor, queries: torch.Tensor,
               k: int, metric: str, tf32: bool = False,
               row_chunk: int = 1 << 18,
               query_block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k rows of `table` [N, d] among rows with `ok` [N] for each
    query [Q, d]: (scores [Q, k] float32, rows [Q, k] int64), ascending,
    (inf, -1) where fewer than k rows qualify. A running top-k over row
    chunks, in query blocks, so that it fits beside nothing else."""
    if metric == "cosine":
        table, queries = normalize(table), normalize(queries)
    out_s, out_i = [], []
    for a in range(0, queries.shape[0], query_block):
        q = queries[a:a + query_block]
        best_s = torch.full((q.shape[0], 0), _MASKED, device=q.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                             device=q.device)
        for c in range(0, table.shape[0], row_chunk):
            s = rank_scores(q, table[c:c + row_chunk], metric, tf32)
            s = torch.where(ok[c:c + row_chunk][None, :], s,
                            torch.full_like(s, _MASKED))
            kk = min(k, s.shape[1])
            ts, ti = torch.topk(s, kk, dim=1, largest=False, sorted=True)
            best_s = torch.cat([best_s, ts], 1)
            best_i = torch.cat([best_i, ti + c], 1)
            if best_s.shape[1] > k:
                best_s, o = torch.topk(best_s, k, dim=1, largest=False,
                                       sorted=True)
                best_i = torch.gather(best_i, 1, o)
        best_i = torch.where(torch.isinf(best_s),
                             torch.full_like(best_i, -1), best_i)
        out_s.append(best_s)
        out_i.append(best_i)
    return torch.cat(out_s), torch.cat(out_i)


def true_dist(q: torch.Tensor, v: torch.Tensor,
              metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float64 scores of rows v [B, k, d] for queries q [B, d] in the
    store's convention, and the scale a score's rounding is measured
    against (||q||^2 + ||v||^2 of the vectors compared; 2 on cosine)."""
    q64, v64 = q.to(torch.float64), v.to(torch.float64)
    if metric == "cosine":
        qn = q64 / torch.clamp(torch.linalg.vector_norm(q64, dim=-1,
                                                        keepdim=True), 1e-12)
        vn = v64 / torch.clamp(torch.linalg.vector_norm(v64, dim=-1,
                                                        keepdim=True), 1e-12)
        return -(vn * qn[:, None, :]).sum(-1), torch.full(v.shape[:2], 2.0,
                                                         dtype=torch.float64,
                                                         device=v.device)
    diff = v64 - q64[:, None, :]
    scale = (q64 * q64).sum(-1)[:, None] + (v64 * v64).sum(-1)
    return (diff * diff).sum(-1), scale


def control_answers(table: torch.Tensor, ok: torch.Tensor,
                    queries: torch.Tensor, k: int, metric: str,
                    row_ids: Optional[torch.Tensor] = None):
    """The reference put in the program's place one precision lower: the
    exact top-k by TF32 products, with its TF32 scores, as asset ids
    (`row_ids` maps table rows to ids; rows are ids without it).
    -> (ids [Q, k] int32, scores [Q, k] float32)."""
    s, r = exact_topk(table, ok, queries, k, metric, tf32=True)
    ids = r if row_ids is None else torch.where(
        r >= 0, row_ids[r.clamp(min=0)], r)
    return ids.to(torch.int32), s
