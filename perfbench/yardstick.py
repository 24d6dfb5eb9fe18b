"""The benchmark's frozen arithmetic: percentiles and rates, the table of
published peaks, and the operations and bytes a scan kernel's call needs.

Nothing here imports the program. The work counts follow one rule: each
input the call's plan needs is read once and each output written once,
whatever the kernel reads again, so a later kernel behind the same wrapper
is read on the same work.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

# Published peaks of one card (NVIDIA's data sheet, SXM part, dense rates
# without sparsity), keyed by a substring of torch.cuda.get_device_name().
PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {
        "hbm_bytes_per_s": 3.35e12,
        "int8_ops_per_s": 1979e12,
        "f32_flops_per_s": 67e12,
        "tf32_flops_per_s": 495e12,
        "bf16_flops_per_s": 989e12,
    },
}


def peaks_for(device_kind: str) -> Optional[Dict[str, float]]:
    """The peak table of the named card, or None for a card not listed (a
    roofline is then not reported)."""
    for key, table in PEAKS.items():
        if key in device_kind:
            return table
    return None


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _scan_rows(valid, part_ids, qsel):
    """(probed partitions some query selects, their valid rows, valid rows
    summed over the selected (query, partition) pairs, probe-list length)."""
    rows_per = valid[part_ids.long()].sum(1).to(torch.float64)     # [n]
    n = int(part_ids.shape[0])
    if qsel is None:
        total = float(rows_per.sum())
        return n, total, None, n
    sel = qsel.any(0)
    pair_rows = float((qsel.to(torch.float64) @ rows_per).sum())
    return int(sel.sum()), float(rows_per[sel].sum()), pair_rows, n


def ivf_scan_work(queries, valid, part_ids, k_out: int, metric: str,
                  qsel=None) -> Dict[str, float]:
    """Float32 tier (ops.scan_topk_mqo): the selected partitions' valid rows
    (float32) and valid bytes, the probe list, the queries and the
    selection read once, the k_out ids gathered and scores and ids written
    once; 2d operations per valid row of each selected pair, plus 2d per
    valid row for the norms on the l2 metric."""
    n_q, d = int(queries.shape[0]), int(queries.shape[1])
    p_max = int(valid.shape[1])
    parts, rows, pair_rows, n = _scan_rows(valid, part_ids, qsel)
    if pair_rows is None:
        pair_rows = n_q * rows
    nbytes = (rows * 4 * d + parts * p_max + n * 4 + n_q * 4 * d
              + (n_q * n if qsel is not None else 0) + n_q * k_out * 12)
    ops = 2.0 * d * pair_rows + (2.0 * d * rows if metric == "l2" else 0.0)
    return {"bytes": float(nbytes), "ops": ops, "ops_peak": "f32_flops_per_s"}


def sq_scan_work(queries, valid, part_ids, k_out: int, metric: str,
                 qsel=None) -> Dict[str, float]:
    """Int8 tier (ops.sq_scan_topk): the selected partitions' valid rows'
    codes (d bytes) and, on l2, their norms (4 bytes), valid bytes, the
    probe list, the queries (float32), the quantizer's lo and scale and the
    selection read once, scores and ids written once; 2 * 2d int8
    operations per valid row of each selected pair (the two folded query
    terms)."""
    n_q, d = int(queries.shape[0]), int(queries.shape[1])
    p_max = int(valid.shape[1])
    parts, rows, pair_rows, n = _scan_rows(valid, part_ids, qsel)
    if pair_rows is None:
        pair_rows = n_q * rows
    norm_b = 4 if metric == "l2" else 0
    nbytes = (rows * (d + norm_b) + parts * p_max + n * 4 + n_q * 4 * d
              + 2 * d * 4 + (n_q * n if qsel is not None else 0)
              + n_q * k_out * 8)
    ops = 2.0 * (2 * d) * pair_rows
    return {"bytes": float(nbytes), "ops": ops, "ops_peak": "int8_ops_per_s"}


def bound_seconds(work: Dict[str, float], peaks: Dict[str, float]) -> float:
    """The least time the card could take: the larger of bytes over the
    memory bandwidth and operations over the named peak."""
    return max(work["bytes"] / peaks["hbm_bytes_per_s"],
               work["ops"] / peaks[work["ops_peak"]])
