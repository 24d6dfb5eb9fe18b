"""Tolerance-aware comparison of two top-k results, shared by the parity
tests and chip_smoke.py.

Two implementations of the same scan sum in different orders, so their
float32 scores differ by a few ulps of the magnitudes involved. The
tolerance therefore scales with magnitude: |s_a - s_b| <= rtol * (||q||^2 +
||v||^2), with rtol = 1e-5 (~80 float32 ulps, well above summation-order
noise for d <= 1024 and far below real distance gaps). A fixed absolute
tolerance fails on scores that cancel near zero (self-matches under the
||q||^2 + ||v||^2 - 2 q.v expansion).

Ids must agree position by position, except inside a run of reference
scores lying within the tolerance of each other: there the ids are
compared as sets, and a run cut off by the k boundary may hold different
members as long as their scores agree.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

RTOL = 1e-5
MASKED = float(np.finfo(np.float32).max)


def score_tol(q: np.ndarray, v2_max: float) -> np.ndarray:
    """[Q, 1] tolerance 1e-5 * (||q||^2 + max ||v||^2)."""
    q = np.asarray(q, np.float64)
    return RTOL * (np.sum(q * q, axis=-1, keepdims=True) + float(v2_max))


def compare_topk(ref_s, ref_i, got_s, got_i, tol) -> Tuple[float, bool, int]:
    """-> (largest |score difference| over real entries, ids agree under
    the tie rule, rows that disagree)."""
    rs, ri = np.asarray(ref_s, np.float64), np.asarray(ref_i)
    gs, gi = np.asarray(got_s, np.float64), np.asarray(got_i)
    assert rs.shape == gs.shape and ri.shape == gi.shape, (rs.shape, gs.shape)
    tol = np.broadcast_to(np.asarray(tol, np.float64).reshape(-1, 1),
                          (rs.shape[0], 1))
    real_r = ri >= 0
    real_g = gi >= 0
    both = real_r & real_g
    err = float(np.abs(rs - gs)[both].max()) if both.any() else 0.0
    bad_rows = 0
    for qi in range(rs.shape[0]):
        if not _row_ok(rs[qi], ri[qi], gs[qi], gi[qi], real_r[qi],
                       real_g[qi], float(tol[qi, 0])):
            bad_rows += 1
    return err, bad_rows == 0, bad_rows


def _row_ok(rs, ri, gs, gi, real_r, real_g, tol) -> bool:
    if real_r.sum() != real_g.sum():
        return False
    m = int(real_r.sum())
    if not (real_r[:m].all() and real_g[:m].all()):
        return False
    if m and np.abs(rs[:m] - gs[:m]).max() > tol:
        return False
    start = 0
    k = len(ri)
    while start < m:
        end = start + 1
        while end < m and rs[end] - rs[end - 1] <= tol:
            end += 1
        cut = end == m == k      # the last run may continue past k
        if not cut and set(ri[start:end].tolist()) != \
                set(gi[start:end].tolist()):
            return False
        start = end
    return True
