"""Fused IVF partition scan + running top-k: the wrapper of the CUDA kernel
in csrc/ivf_scan.cu, which replaces the Pallas TPU kernel
repro/kernels/ivf_scan.py::ivf_scan_topk.

`ivf_scan_topk` runs the plain PyTorch version (`ivf_scan_plain`, from
kernels/ref.py) when its tensors lie on the CPU (or on "meta", where it
computes shapes only, for the dry-run's trace), and launches the kernel
when they lie on a CUDA device -- there is no fallback from one to the
other. `LAUNCHES` counts kernel launches, and only those; a batch of more
than common.MAX_QUERIES_PER_LAUNCH queries runs as one launch per slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.types import MASKED_SCORE
from . import build, common
from .ref import ivf_scan_ref as ivf_scan_plain

LAUNCHES = 0
# Most queries a block scores each row against on the exact route (no
# qsel): rows are read once per group of queries, not once per query.
MAX_GROUP = 8


def ivf_scan_topk(
    queries: torch.Tensor,          # [Q, d] f32
    vectors: torch.Tensor,          # [k, p_max, d] f32
    valid: torch.Tensor,            # [k, p_max] bool
    ids: Optional[torch.Tensor],    # [k, p_max] int32 (None: flat row ids)
    part_ids: torch.Tensor,         # [n] int32 -- partitions to scan
    k_out: int,
    metric: str = "l2",
    qsel: Optional[torch.Tensor] = None,  # [Q, n] bool (per-query probes)
    keep: Optional[torch.Tensor] = None,  # [k, p_max] bool post-filter
    attrs: Optional[torch.Tensor] = None,  # [k, p_max, n_attr] f32
    program=None,                   # core/hybrid.Program over attrs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores [Q, k_out] f32, ids [Q, k_out] int32), ascending by
    (score, probe position * p_max + slot); (MASKED, -1) where fewer rows
    qualify. A row qualifies when valid, kept by `keep` (the mask of an
    opaque filter callable) and by `program`, the predicate evaluated on
    its attrs inside the scan. `part_ids` must lie in [0, k): shapes are
    checked, values are not (that would cost a host sync per scan)."""
    if queries.device.type in ("cpu", "meta"):
        return ivf_scan_plain(queries, vectors, valid, ids, part_ids, k_out,
                              metric=metric, qsel=qsel, keep=keep,
                              attrs=attrs, program=program)
    n_q = queries.shape[0]
    parts = [_launch(queries[a:b], vectors, valid, ids, part_ids, k_out,
                     metric, None if qsel is None else qsel[a:b], keep,
                     attrs, program)
             for a, b in common.query_slices(n_q)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def query_group(n_q: int, qsel) -> int:
    """Queries per block: 1 with a selection (each query reads only its
    own pairs), else the power of two covering n_q, at most MAX_GROUP."""
    if qsel is not None:
        return 1
    g = 1
    while g < min(n_q, MAX_GROUP):
        g *= 2
    return g


def _launch(queries, vectors, valid, ids, part_ids, k_out, metric, qsel,
            keep, attrs, program):
    global LAUNCHES
    dev = queries.device
    common.require_cuda("ivf_scan", dev, vectors, valid, ids, part_ids,
                        qsel, keep, attrs)
    n_q, d = queries.shape
    kp, p_max, dv = vectors.shape
    if dv != d:
        raise ValueError(f"ivf_scan: query width {d} != vector width {dv}")
    n = part_ids.shape[0]
    common.require_shape("ivf_scan", (kp, p_max), valid=valid, ids=ids,
                         keep=keep)
    common.require_shape("ivf_scan", (n_q, n), qsel=qsel)
    attrs, prog, n_attr = common.program_args("ivf_scan", kp, p_max, attrs,
                                              program)
    if n_q == 0 or n == 0 or k_out == 0:
        return (torch.full((n_q, k_out), MASKED_SCORE, dtype=torch.float32,
                           device=dev),
                torch.full((n_q, k_out), -1, dtype=torch.int32, device=dev))
    group = query_group(n_q, qsel)
    n_chunks = common.scan_plan(n_q, n, p_max, common.sm_count(dev), group)
    # pass 2 writes every output entry, the (MASKED, -1) tail included
    out_s = torch.empty((n_q, k_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k_out), dtype=torch.int32, device=dev)
    ins = [common.as_dtype(queries, torch.float32),
           common.as_dtype(vectors, torch.float32),
           common.as_dtype(valid, torch.int8),
           common.as_dtype(keep, torch.int8),
           attrs]
    ins2 = [common.as_dtype(ids, torch.int32),
            common.as_dtype(part_ids, torch.int32),
            common.as_dtype(qsel, torch.int8)]
    # scratch in two allocations (host work per call is what small batches
    # feel): int32 part_cnt [n_q, n_chunks], then with qsel the pair lists
    # [n_q, n] and their counts [n_q]; int64 part_keys [n_q, n_chunks,
    # k_out], then with more than one chunk each query's published k-th
    n_pairs = n_q * (n + 1) if qsel is not None else 0
    i32 = torch.empty((n_q * n_chunks + n_pairs,), dtype=torch.int32,
                      device=dev)
    n_limits = n_q if n_chunks > 1 else 0
    i64 = torch.empty((n_q * n_chunks * k_out + n_limits,),
                      dtype=torch.int64, device=dev)
    part_cnt = i32.data_ptr()
    pairs = part_cnt + 4 * n_q * n_chunks if qsel is not None else None
    pair_cnt = pairs + 4 * n_q * n if qsel is not None else None
    part_keys = i64.data_ptr()
    limits = part_keys + 8 * n_q * n_chunks * k_out
    rc = build.load("ivf_scan").ivf_scan_launch(
        *[common.ptr(t) for t in ins], prog, *[common.ptr(t) for t in ins2],
        n_q, d, p_max, n, n_chunks, k_out, int(metric == "l2"), group,
        n_attr, pairs, pair_cnt, limits, part_keys, part_cnt,
        common.ptr(out_s), common.ptr(out_i), common.stream_ptr(dev))
    build.check_launch("ivf_scan", rc)
    LAUNCHES += 1
    return out_s, out_i
