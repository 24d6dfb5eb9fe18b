"""Plain PyTorch versions of the three kernels (port of repro.kernels.ref).

Each kernel module's wrapper runs these for tensors on the CPU; on the
card they are the versions each CUDA kernel is held against. Scores follow
the ranking convention of core/: smaller is better, and the l2 path drops
the per-query ||q||^2 constant (rank-invariant):
    score(q, v) = ||v||^2 - 2 q.v          (l2)
    score(q, v) = -q.v                     (ip / cosine on normalised data)
Selections keep lax.top_k's tie order (ascending score, then position).
"""
from __future__ import annotations

import operator
from typing import Optional

import numpy as np
import torch

from ..core.topk import mask_scores, topk_smallest
from ..core.types import f32_matmul


def scores_ref(q: torch.Tensor, v: torch.Tensor, metric: str) -> torch.Tensor:
    """q: [Q, d], v: [N, d] -> [Q, N]."""
    dots = f32_matmul(q.to(torch.float32), v.to(torch.float32).T)
    if metric in ("ip", "cosine"):
        return -dots
    v2 = torch.sum(v.to(torch.float32) ** 2, dim=-1)
    return v2[None, :] - 2.0 * dots


def flat_row_ids(part_ids: torch.Tensor, p_max: int) -> torch.Tensor:
    """[n] partitions -> [n, p_max] flat row ids p * p_max + slot."""
    slots = torch.arange(p_max, dtype=torch.int32, device=part_ids.device)
    return part_ids.to(torch.int32)[:, None] * p_max + slots[None, :]


# opcodes 0-5 of core/hybrid.PROGRAM_OPS
_COMPARE = (operator.lt, operator.le, operator.gt, operator.ge, operator.eq,
            operator.ne)


def eval_program(program, attrs: torch.Tensor) -> torch.Tensor:
    """Plain version of the in-scan predicate evaluator
    (csrc/pred_program.cuh): a core/hybrid.Program over attrs
    [..., n_attr] -> keep [...], walked as the device walks it."""
    stack = []
    for c, w in zip(program.code, program.word):
        op, arg = c & 0xFF, c >> 8
        if op >= 7:                          # AND / OR over `arg` results
            top = stack[-arg:]
            del stack[-arg:]
            out = top[0]
            for m in top[1:]:
                out = (out & m) if op == 7 else (out | m)
            stack.append(out)
            continue
        col = attrs[..., arg]
        if op == 6:                          # match: all tag bits present
            stack.append((col.to(torch.int64) & w) == w)
            continue
        v = float(np.uint32(w).view(np.float32))   # exactly the float32
        stack.append(_COMPARE[op](col, v))
    return stack[-1]


def _row_mask(valid, part_ids, keep, attrs, program):
    """[n, p_max] rows a scan may return: valid, and kept by the mask or
    by the predicate program over the probed rows' attributes."""
    pok = valid[part_ids].to(torch.bool)
    if keep is not None:
        pok = pok & keep[part_ids].to(torch.bool)
    if program is not None:
        pok = pok & eval_program(program, attrs[part_ids])
    return pok


def _select(s, pok, pid, qsel, k_out: int):
    """Mask by the row mask [n, p_max] and the per-query selection
    [Q, n], then the ascending top-k_out over the flattened list."""
    n, p_max = pok.shape
    ok = pok.reshape(1, n * p_max).expand_as(s)
    if qsel is not None:
        ok = ok & qsel.to(torch.bool).repeat_interleave(p_max, dim=1)
    s = mask_scores(s, ok)
    return topk_smallest(s, pid.reshape(1, -1).expand_as(s), k_out)


def ivf_scan_ref(queries, vectors, valid, ids, part_ids, k_out: int,
                 metric: str = "l2", qsel=None, keep=None, attrs=None,
                 program=None):
    """Plain version of the fused partition scan + top-k kernel.

    queries [Q, d]; vectors [k, p_max, d]; valid [k, p_max] bool;
    ids [k, p_max] int32 (None: flat row ids); part_ids [n] int32;
    qsel [Q, n] bool or None; keep [k, p_max] bool post-filter or None;
    attrs [k, p_max, n_attr] with a predicate `program` or None.
    -> (scores [Q, k_out], ids [Q, k_out]) ascending."""
    part_ids = part_ids.long()
    pv = vectors[part_ids]                        # [n, p_max, d]
    n, p_max, d = pv.shape
    pok = _row_mask(valid, part_ids, keep, attrs, program)
    pid = ids[part_ids] if ids is not None else flat_row_ids(part_ids, p_max)
    s = scores_ref(queries, pv.reshape(n * p_max, d), metric)
    return _select(s, pok, pid, qsel, k_out)


def int_domain_dots(q_i8, alpha, beta, flat_c):
    """Two-term affine epilogue over [2Q, d] x [m, d] int8 operands:
    (alpha * (q_i8 . c))[:Q] + (alpha * (q_i8 . c))[Q:] + beta. For
    d <= 1024 a float32 product of the cast integers is exact (every
    product and partial sum is an integer below 2^24), so the accumulators
    equal int32 accumulation bit for bit; wider vectors use float64."""
    d = q_i8.shape[-1]
    if d <= 1024:
        acc = f32_matmul(q_i8.to(torch.float32), flat_c.to(torch.float32).T)
    else:
        acc = (q_i8.to(torch.float64) @ flat_c.to(torch.float64).T
               ).to(torch.float32)
    terms = alpha[:, None] * acc
    q_n = beta.shape[0]
    return terms[:q_n] + terms[q_n:] + beta[:, None]


def sq_scan_ref(q_i8, alpha, beta, lo, scale, codes, valid, ids, part_ids,
                k_out: int, metric: str = "l2", qsel=None, keep=None,
                norms: Optional[torch.Tensor] = None, attrs=None,
                program=None):
    """Plain version of the int8-domain SQ scan + top-k kernel, on the
    folded queries (q_i8 [2Q, d], alpha [2Q], beta [Q]). `ids` None emits
    flat row ids; `norms` None decodes and reduces the codes in-scan."""
    part_ids = part_ids.long()
    pc = codes[part_ids]                          # [n, p_max, d] int8
    n, p_max, d = pc.shape
    pok = _row_mask(valid, part_ids, keep, attrs, program)
    dots = int_domain_dots(q_i8, alpha, beta, pc.reshape(n * p_max, d))
    if metric in ("ip", "cosine"):
        s = -dots
    else:
        if norms is not None:
            v2 = norms[part_ids].reshape(n * p_max)
        else:
            v = (pc.to(torch.float32) + 128.0) * scale + lo
            v2 = torch.sum(v * v, dim=-1).reshape(n * p_max)
        s = v2[None, :] - 2.0 * dots
    pid = ids[part_ids] if ids is not None else flat_row_ids(part_ids, p_max)
    return _select(s, pok, pid, qsel, k_out)


def kmeans_assign_ref(batch, centroids, penalty):
    """Plain version of the penalised nearest-centroid kernel.

    batch [s, d]; centroids [k, d]; penalty [k] f32 (counts * lambda *
    scale / target, folded by the wrapper). The cost is evaluated in the
    kernel's order, ((||x||^2 + ||c||^2) - 2 x.c) + penalty; arg-min ties
    go to the first index. -> (assign [s] int32, cost [s] f32)."""
    dots = f32_matmul(batch, centroids.T)
    x2 = torch.sum(batch * batch, dim=-1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=-1)
    pen = ((x2 + c2[None, :]) - 2.0 * dots) + penalty[None, :]
    cost, a = torch.min(pen, dim=-1)
    return a.to(torch.int32), cost
