"""Top-k maintenance & merging (port of repro.core.topk).

Scores are "smaller is better" everywhere. The tie order is pinned to the
one `jax.lax.top_k` gives: equal scores come out in index order. `torch.topk`
promises no order among ties on either device, so every selection here is a
stable ascending sort followed by a slice.
"""
from __future__ import annotations

import torch

from .types import INVALID_ID, MASKED_SCORE


def topk_smallest(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k smallest scores along the last axis, ties in index order.
    Returns (scores, ids); entries carrying MASKED_SCORE get INVALID_ID."""
    s, order = torch.sort(scores, dim=-1, stable=True)
    s = s[..., :k]
    i = torch.gather(ids, -1, order[..., :k])
    i = torch.where(s >= MASKED_SCORE, torch.full_like(i, INVALID_ID), i)
    return s, i


def running_topk_init(batch_shape, k: int, device=None):
    """An empty running top-k buffer: (MASKED_SCORE, INVALID_ID) entries of
    shape batch_shape + (k,)."""
    shape = tuple(batch_shape) + (k,)
    return (torch.full(shape, MASKED_SCORE, dtype=torch.float32,
                       device=device),
            torch.full(shape, INVALID_ID, dtype=torch.int32, device=device))


def merge_topk(s_a, i_a, s_b, i_b, k: int):
    """Associative merge of two (scores, ids) top-k buffers -> top-k of union."""
    return topk_smallest(torch.cat([s_a, s_b], dim=-1),
                         torch.cat([i_a, i_b], dim=-1), k)


def mask_scores(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Push masked rows past any real score so they never enter a top-k."""
    return torch.where(valid, scores,
                       torch.full_like(scores, MASKED_SCORE))


def dedup_by_id(scores: torch.Tensor, ids: torch.Tensor):
    """Mask duplicate ids, keeping the best-scoring (first) occurrence."""
    s, order = torch.sort(scores, dim=-1, stable=True)
    i = torch.gather(ids, -1, order)
    eq = i[..., :, None] == i[..., None, :]                  # [.., K, K]
    kk = eq.shape[-1]
    earlier = torch.tril(torch.ones((kk, kk), dtype=torch.bool,
                                    device=ids.device), diagonal=-1)
    dup = torch.any(eq & earlier, dim=-1) & (i != INVALID_ID)
    s = torch.where(dup, torch.full_like(s, MASKED_SCORE), s)
    i = torch.where(dup, torch.full_like(i, INVALID_ID), i)
    return topk_smallest(s, i, kk)
