"""Top-k maintenance & merging (port of repro.core.topk).

Scores are "smaller is better" everywhere. The tie order is pinned to the
one `jax.lax.top_k` gives: equal scores come out in index order. `torch.topk`
promises no order among ties on either device, so every selection here is a
stable ascending sort followed by a slice.

The cross-rank reductions (`tournament_merge`, `allgather_merge`) run on a
`torch.distributed` process group where the reference names a mesh axis.
NCCL exchanges device tensors in place. Gloo moves host tensors only (it
cannot send, receive or all-gather CUDA tensors, and NCCL refuses two ranks
on one GPU), so on a gloo group a CUDA buffer crosses through host memory in
`_through_host`, which logs its first use and counts every call
(`host_staging()`); it is never taken silently.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, List

import torch
import torch.distributed as dist

from .types import INVALID_ID, MASKED_SCORE

_LOG = logging.getLogger(__name__)


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


# -- cross-rank merges --------------------------------------------------------

# collectives whose CUDA buffers crossed through host memory on a gloo group:
# calls, bytes sent, and seconds spent (copies and the collective together);
# the first staging of the process is logged
_STAGING = {"calls": 0, "bytes": 0, "seconds": 0.0}
_LOGGED = False


def host_staging() -> dict:
    """A copy of the host-staging counters of this process."""
    return dict(_STAGING)


def reset_host_staging() -> None:
    _STAGING.update(calls=0, bytes=0, seconds=0.0)


def _through_host(collective: Callable[[List[torch.Tensor]],
                                       List[torch.Tensor]],
                  tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Run `collective` on host copies of `tensors` and return its outputs
    on their device: the one route by which a CUDA buffer crosses a gloo
    group. Logged at its first use and counted every call."""
    global _LOGGED
    if not _LOGGED:
        _LOGGED = True
        _LOG.warning("gloo group: %s collective buffers cross through host "
                     "memory", tensors[0].device)
    dev = tensors[0].device
    t0 = time.perf_counter()
    host = [t.cpu() for t in tensors]
    out = [o.to(dev) for o in collective(host)]
    _STAGING["calls"] += 1
    _STAGING["bytes"] += sum(t.numel() * t.element_size() for t in host)
    _STAGING["seconds"] += time.perf_counter() - t0
    return out


def _exchange(collective, tensors: List[torch.Tensor], group):
    """`collective` on `tensors` where the group's backend can take them:
    in place, or through host memory for CUDA tensors on gloo."""
    if tensors[0].device.type != "cpu" and \
            dist.get_backend(group) == dist.Backend.GLOO:
        return _through_host(collective, tensors)
    return collective([t.contiguous() for t in tensors])


def _group_of(group):
    return dist.group.WORLD if group is None else group


def topk_smallest_by_key(scores: torch.Tensor, ids: torch.Tensor,
                         keys: torch.Tensor, k: int):
    """Top-k smallest scores along the last axis with ties broken by
    ascending `keys` (not by position). Returns (scores, ids, keys);
    entries carrying MASKED_SCORE get INVALID_ID."""
    o = torch.sort(keys, dim=-1, stable=True).indices
    s, o2 = torch.sort(torch.gather(scores, -1, o), dim=-1, stable=True)
    o = torch.gather(o, -1, o2[..., :k])
    s = s[..., :k]
    i = torch.gather(ids, -1, o)
    i = torch.where(s >= MASKED_SCORE, torch.full_like(i, INVALID_ID), i)
    return s, i, torch.gather(keys, -1, o)


def _select(bufs: List[torch.Tensor], k: int, keyed: bool):
    """Top-k of (scores, ids[, keys]) concatenated along the last axis."""
    if keyed:
        return topk_smallest_by_key(*bufs, k)
    return topk_smallest(*bufs, k)


def tournament_merge(scores: torch.Tensor, ids: torch.Tensor, k: int,
                     group=None, keys=None):
    """Log-depth cross-rank top-k reduction over a process group: every
    rank holds a local [.., k] buffer; after log2(m) hypercube rounds
    (`batch_isend_irecv` with peer rank ^ step) every rank holds the global
    top-k. Each round merges (own, peer) in that order, as the reference's
    ppermute does, so ties resolve as in JAX: rank r's result is the top-k
    of the buffers concatenated in the order r ^ 0, r ^ 1, ..., r ^ (m-1)
    (rank order on rank 0). With `keys` (int64, beside the ids) equal
    scores order by ascending key instead, the same on every rank, and
    the keys come back too: (scores, ids, keys). A group whose size is not
    a power of two raises ValueError."""
    group = _group_of(group)
    m = dist.get_world_size(group)
    if m & (m - 1):
        raise ValueError(f"tournament_merge needs a power-of-two group; "
                         f"this one has {m} ranks")
    me = dist.get_rank(group)
    bufs = [scores, ids] + ([] if keys is None else [keys])
    step = 1
    while step < m:
        peer = dist.get_global_rank(group, me ^ step)

        def sendrecv(ts, peer=peer):
            recv = [torch.empty_like(t) for t in ts]
            ops = [dist.P2POp(dist.isend, t, peer, group) for t in ts] + \
                [dist.P2POp(dist.irecv, t, peer, group) for t in recv]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return recv

        theirs = _exchange(sendrecv, bufs, group)
        bufs = list(_select([torch.cat([a, b], dim=-1)
                             for a, b in zip(bufs, theirs)], k,
                            keys is not None))
        step <<= 1
    return tuple(bufs)


def allgather_merge(scores: torch.Tensor, ids: torch.Tensor, k: int,
                    group=None, keys=None):
    """Flat all-gather, concatenated in rank order along the last axis,
    then a local top-k (the baseline collective schedule). `keys` as in
    tournament_merge."""
    group = _group_of(group)
    m = dist.get_world_size(group)

    def gather(ts):
        out = []
        for t in ts:
            parts = [torch.empty_like(t) for _ in range(m)]
            dist.all_gather(parts, t, group=group)
            out.append(torch.cat(parts, dim=-1))
        return out

    bufs = [scores, ids] + ([] if keys is None else [keys])
    return _select(_exchange(gather, bufs, group), k, keys is not None)
