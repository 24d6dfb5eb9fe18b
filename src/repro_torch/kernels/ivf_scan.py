"""Fused IVF partition scan + running top-k: the wrapper of the CUDA kernel
in csrc/ivf_scan.cu, which replaces the Pallas TPU kernel
repro/kernels/ivf_scan.py::ivf_scan_topk.

`ivf_scan_topk` runs the plain PyTorch version (`ivf_scan_plain`, from
kernels/ref.py) when its tensors lie on the CPU, and launches the kernel
when they lie on a CUDA device -- there is no fallback from one to the
other. `LAUNCHES` counts kernel launches, and only those.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.types import MASKED_SCORE
from . import build, common
from .ref import ivf_scan_ref as ivf_scan_plain

LAUNCHES = 0


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores [Q, k_out] f32, ids [Q, k_out] int32), ascending by
    (score, probe position * p_max + slot); (MASKED, -1) where fewer rows
    qualify. `part_ids` must lie in [0, k): shapes are checked, values are
    not (that would cost a host sync per scan)."""
    if queries.device.type == "cpu":
        return ivf_scan_plain(queries, vectors, valid, ids, part_ids, k_out,
                              metric=metric, qsel=qsel, keep=keep)
    return _launch(queries, vectors, valid, ids, part_ids, k_out, metric,
                   qsel, keep)


def _launch(queries, vectors, valid, ids, part_ids, k_out, metric, qsel,
            keep):
    global LAUNCHES
    dev = queries.device
    common.require_cuda("ivf_scan", dev, vectors, valid, ids, part_ids,
                        qsel, keep)
    n_q, d = queries.shape
    kp, p_max, dv = vectors.shape
    if dv != d:
        raise ValueError(f"ivf_scan: query width {d} != vector width {dv}")
    n = part_ids.shape[0]
    common.require_shape("ivf_scan", (kp, p_max), valid=valid, ids=ids,
                         keep=keep)
    common.require_shape("ivf_scan", (n_q, n), qsel=qsel)
    out_s = torch.full((n_q, k_out), MASKED_SCORE, dtype=torch.float32,
                       device=dev)
    out_i = torch.full((n_q, k_out), -1, dtype=torch.int32, device=dev)
    if n_q == 0 or n == 0 or k_out == 0:
        return out_s, out_i
    n_chunks, chunk, tile = common.scan_plan(n_q, n, p_max, k_out, d, dev)
    q = common.as_dtype(queries, torch.float32)
    vec = common.as_dtype(vectors, torch.float32)
    val = common.as_dtype(valid, torch.int8)
    kp_ = common.as_dtype(keep, torch.int8)
    idv = common.as_dtype(ids, torch.int32)
    pid = common.as_dtype(part_ids, torch.int32)
    qs = common.as_dtype(qsel, torch.int8)
    part_keys = torch.empty((n_q, n_chunks, k_out), dtype=torch.int64,
                            device=dev)
    part_cnt = torch.empty((n_q, n_chunks), dtype=torch.int32, device=dev)
    lib = build.load("ivf_scan")
    rc = lib.ivf_scan_launch(
        common.ptr(q), common.ptr(vec), common.ptr(val), common.ptr(kp_),
        common.ptr(idv), common.ptr(pid), common.ptr(qs),
        n_q, d, p_max, n, chunk, n_chunks, k_out, int(metric == "l2"),
        tile, common.THREADS, common.ptr(part_keys), common.ptr(part_cnt),
        common.ptr(out_s), common.ptr(out_i), common.stream_ptr(dev))
    build.check_launch("ivf_scan", rc)
    LAUNCHES += 1
    return out_s, out_i
