"""Fused int8 scalar-quantized scan + running top-k: the wrapper of the CUDA
kernel in csrc/sq_scan.cu, which replaces the Pallas TPU kernel
repro/kernels/sq_scan.py::sq_scan_topk.

The wrapper folds the float32 queries into the stacked two-term int8 form
(core/quantize.fold_queries) once per scan, in PyTorch, exactly as the
Pallas wrapper does; the kernel and its plain version (`sq_scan_plain`)
both take the folded inputs. CPU tensors run the plain version, CUDA
tensors launch the kernel -- no fallback either way. `LAUNCHES` counts
kernel launches, and only those; a batch of more than
common.MAX_QUERIES_PER_LAUNCH queries runs as one launch per slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import quantize
from ..core.types import MASKED_SCORE, QuantStats
from . import build, common
from .ref import sq_scan_ref as sq_scan_plain

LAUNCHES = 0


def sq_scan_topk(
    queries: torch.Tensor,          # [Q, d] f32 (normalised)
    codes: torch.Tensor,            # [k, p_max, d] int8
    lo: torch.Tensor,               # [d] f32 quantizer minima
    scale: torch.Tensor,            # [d] f32 quantizer scales
    valid: torch.Tensor,            # [k, p_max] bool
    ids: Optional[torch.Tensor],    # [k, p_max] int32 (None: flat row ids)
    part_ids: torch.Tensor,         # [n] int32 -- partitions to scan
    k_out: int,
    metric: str = "l2",
    qsel: Optional[torch.Tensor] = None,   # [Q, n] bool
    keep: Optional[torch.Tensor] = None,   # [k, p_max] bool post-filter
    norms: Optional[torch.Tensor] = None,  # [k, p_max] f32 ||decode(c)||^2
    attrs: Optional[torch.Tensor] = None,  # [k, p_max, n_attr] f32
    program=None,                   # core/hybrid.Program over attrs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (approximate scores [Q, k_out] f32, ids [Q, k_out] int32), in
    ivf_scan_topk's order and conventions (`part_ids` in [0, k); `keep`
    and `program` filter rows as there)."""
    q_i8, alpha, beta = quantize.fold_queries(QuantStats(lo=lo, scale=scale),
                                              queries)
    norms = norms if metric == "l2" else None
    return sq_scan_folded(q_i8, alpha, beta, lo, scale, codes, valid, ids,
                          part_ids, k_out, metric=metric, qsel=qsel,
                          keep=keep, norms=norms, attrs=attrs,
                          program=program)


def sq_scan_folded(q_i8, alpha, beta, lo, scale, codes, valid, ids, part_ids,
                   k_out: int, metric: str = "l2", qsel=None, keep=None,
                   norms=None, attrs=None, program=None):
    """The scan on already-folded queries (the kernel's own inputs)."""
    if q_i8.device.type == "cpu":
        return sq_scan_plain(q_i8, alpha, beta, lo, scale, codes, valid, ids,
                             part_ids, k_out, metric=metric, qsel=qsel,
                             keep=keep, norms=norms, attrs=attrs,
                             program=program)
    n_q = beta.shape[0]
    slices = common.query_slices(n_q)
    if len(slices) == 1:
        return _launch(q_i8, alpha, beta, lo, scale, codes, valid, ids,
                       part_ids, k_out, metric, qsel, keep, norms, attrs,
                       program)
    # the folded queries stack both terms: rows [0, n_q) and [n_q, 2 n_q)
    q2 = q_i8.reshape(2, n_q, q_i8.shape[1])
    a2 = alpha.reshape(2, n_q)
    parts = [_launch(q2[:, a:b].reshape(2 * (b - a), -1),
                     a2[:, a:b].reshape(-1), beta[a:b], lo, scale, codes,
                     valid, ids, part_ids, k_out, metric,
                     None if qsel is None else qsel[a:b], keep, norms,
                     attrs, program)
             for a, b in slices]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _launch(q_i8, alpha, beta, lo, scale, codes, valid, ids, part_ids,
            k_out, metric, qsel, keep, norms, attrs, program):
    global LAUNCHES
    dev = q_i8.device
    common.require_cuda("sq_scan", dev, alpha, beta, lo, scale, codes, valid,
                        ids, part_ids, qsel, keep, norms, attrs)
    n_q = beta.shape[0]
    d = q_i8.shape[1]
    kp, p_max, dc = codes.shape
    if dc != d or q_i8.shape[0] != 2 * n_q:
        raise ValueError("sq_scan: folded queries do not match the codes")
    n = part_ids.shape[0]
    common.require_shape("sq_scan", (kp, p_max), valid=valid, ids=ids,
                         keep=keep, norms=norms)
    common.require_shape("sq_scan", (n_q, n), qsel=qsel)
    common.require_shape("sq_scan", (d,), lo=lo, scale=scale)
    common.require_shape("sq_scan", (2 * n_q,), alpha=alpha)
    attrs, prog, n_attr = common.program_args("sq_scan", kp, p_max, attrs,
                                              program)
    if n_q == 0 or n == 0 or k_out == 0:
        return (torch.full((n_q, k_out), MASKED_SCORE, dtype=torch.float32,
                           device=dev),
                torch.full((n_q, k_out), -1, dtype=torch.int32, device=dev))
    n_chunks = common.scan_plan(n_q, n, p_max, common.sm_count(dev))
    # pass 2 writes every output entry, the (MASKED, -1) tail included
    out_s = torch.empty((n_q, k_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_q, k_out), dtype=torch.int32, device=dev)
    ins = [common.as_dtype(q_i8, torch.int8),
           common.as_dtype(alpha, torch.float32),
           common.as_dtype(beta, torch.float32),
           common.as_dtype(lo, torch.float32),
           common.as_dtype(scale, torch.float32),
           common.as_dtype(codes, torch.int8),
           common.as_dtype(norms if metric == "l2" else None, torch.float32),
           common.as_dtype(valid, torch.int8),
           common.as_dtype(keep, torch.int8),
           attrs]
    ins2 = [common.as_dtype(ids, torch.int32),
            common.as_dtype(part_ids, torch.int32),
            common.as_dtype(qsel, torch.int8)]
    # selected pair lists [n_q, n] + their counts [n_q], with qsel only
    pairs = torch.empty((n_q * (n + 1),) if qsel is not None else (0,),
                        dtype=torch.int32, device=dev)
    part_keys = torch.empty((n_q, n_chunks, k_out), dtype=torch.int64,
                            device=dev)
    part_cnt = torch.empty((n_q, n_chunks), dtype=torch.int32, device=dev)
    pair_cnt = pairs[n_q * n:] if qsel is not None else None
    rc = build.load("sq_scan").sq_scan_launch(
        *[common.ptr(a) for a in ins], prog, *[common.ptr(a) for a in ins2],
        n_q, d, p_max, n, n_chunks, k_out, int(metric == "l2"), n_attr,
        common.ptr(pairs), common.ptr(pair_cnt),
        common.ptr(part_keys), common.ptr(part_cnt), common.ptr(out_s),
        common.ptr(out_i), common.stream_ptr(dev))
    build.check_launch("sq_scan", rc)
    LAUNCHES += 1
    return out_s, out_i
