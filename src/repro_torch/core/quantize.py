"""Per-dimension int8 scalar quantization (port of repro.core.quantize).

Training is a per-dimension min/max, encoding the asymmetric affine code
c = round((x - lo) / scale) - 128 in int8. `torch.round` rounds half to
even like `jnp.round`, so the codes match the JAX package bit for bit on
the CPU. The scan over the code tier (kernels/sq_scan.py) accumulates in
the integer domain over the two-term query fold below; reported scores
always come from the exact float32 rerank.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .types import (QuantStats, normalize_if_cosine, pairwise_sum,
                    resolve_device)

# Number of representable levels: codes span [-128, 127] <-> [0, 255].
LEVELS = 255
# Guard against zero-width dimensions (constant columns).
MIN_SCALE = 1e-12
# Rows decoded at a time by row_norms (bounds its float32 scratch).
_NORM_CHUNK_ROWS = 1 << 18


def train(X: torch.Tensor) -> QuantStats:
    """Fit per-dimension min/max stats from a [n, d] sample (already
    metric-normalised by the caller)."""
    X = X.to(torch.float32)
    if X.shape[0] == 0:
        return QuantStats(
            lo=torch.zeros((X.shape[1],), dtype=torch.float32,
                           device=X.device),
            scale=torch.ones((X.shape[1],), dtype=torch.float32,
                             device=X.device))
    lo = X.amin(dim=0)
    hi = X.amax(dim=0)
    scale = torch.clamp((hi - lo) / LEVELS, min=MIN_SCALE)
    return QuantStats(lo=lo, scale=scale)


def train_from_store(store, metric: str = "l2", batch_size: int = 4096,
                     device=None) -> QuantStats:
    """Streaming min/max over the durable tier (storage.VectorStore): one
    pass of `iter_batches`, never the full dataset in host memory. Rows are
    metric-normalised on the host, as recover() normalises them."""
    lo: Optional[np.ndarray] = None
    hi: Optional[np.ndarray] = None
    for batch in store.iter_batches(batch_size):
        b = normalize_if_cosine(
            torch.from_numpy(np.ascontiguousarray(batch, np.float32)),
            metric).numpy()
        blo, bhi = b.min(axis=0), b.max(axis=0)
        lo = blo if lo is None else np.minimum(lo, blo)
        hi = bhi if hi is None else np.maximum(hi, bhi)
    if lo is None:
        lo = np.zeros((store.dim,), np.float32)
        hi = lo
    scale = np.maximum((hi - lo) / LEVELS, MIN_SCALE)
    return stats_from_arrays(lo, scale, device=device)


def encode(stats: QuantStats, x: torch.Tensor) -> torch.Tensor:
    """[..., d] float32 -> [..., d] int8 codes (round half to even)."""
    q = torch.round((x.to(torch.float32) - stats.lo) / stats.scale)
    return (torch.clamp(q, 0, LEVELS) - 128).to(torch.int8)


def decode(stats: QuantStats, codes: torch.Tensor) -> torch.Tensor:
    """[..., d] int8 codes -> [..., d] float32 reconstruction."""
    return (codes.to(torch.float32) + 128.0) * stats.scale + stats.lo


def encode_np(stats: QuantStats, x: np.ndarray) -> np.ndarray:
    """Host-side encode (pack/flush paths)."""
    cpu = QuantStats(lo=stats.lo.cpu(), scale=stats.scale.cpu())
    return encode(cpu, torch.from_numpy(np.asarray(x, np.float32))).numpy()


def fold_queries(stats: QuantStats, q: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold f32 queries into the int8 distance domain, once per scan.

    With w = q * scale, q . decode(c) = w . c + 128 sum(w) + q . lo, and w
    is encoded in two int8 terms (primary + rounding residual):

        q1 = round(w * 127 / A1),  A1 = max|w|
        q2 = round(r * 127 / A2),  r = w - (A1/127) q1, A2 = max|r|

    so q . v ~= alpha1 (q1 . c) + alpha2 (q2 . c) + beta. Returns the
    stacked form the scan consumes: (q_i8 [2Q, d] int8 = [q1; q2],
    alpha [2Q] f32 = [alpha1; alpha2], beta [Q] f32)."""
    q = q.to(torch.float32)
    w = q * stats.scale[None, :]
    a1 = torch.clamp(torch.amax(torch.abs(w), dim=-1), min=MIN_SCALE)
    q1 = torch.round(w * (127.0 / a1[:, None])).to(torch.int8)
    alpha1 = a1 / 127.0
    r = w - alpha1[:, None] * q1.to(torch.float32)
    a2 = torch.clamp(torch.amax(torch.abs(r), dim=-1), min=MIN_SCALE)
    q2 = torch.round(r * (127.0 / a2[:, None])).to(torch.int8)
    alpha2 = a2 / 127.0
    q_i8 = torch.cat([q1, q2], dim=0)
    alpha = torch.cat([alpha1, alpha2], dim=0)
    # integer sums below 2^24 are exact in any order; q . lo is summed by
    # pairwise_sum, so a query's beta has the same bits in any batch
    beta = 128.0 * (alpha1 * torch.sum(q1.to(torch.float32), dim=-1)
                    + alpha2 * torch.sum(q2.to(torch.float32), dim=-1)) \
        + pairwise_sum(q * stats.lo[None, :])
    return q_i8, alpha, beta


def row_norms(stats: QuantStats, codes: torch.Tensor,
              chunk_rows: int = _NORM_CHUNK_ROWS) -> torch.Tensor:
    """[..., p, d] int8 codes -> [..., p] f32 ||decode(c)||^2, the l2 scan's
    per-row constant (IVFIndex.code_norms, and the paged int8 pool's norms
    frames). Rows are decoded `chunk_rows` at a time, which bounds the
    float32 scratch (the decode, its squares, the sum's first half: 10 *
    d bytes a row).

    The squares are summed by types.pairwise_sum, so a row's norm has the
    same bits whatever batch it is computed in and on either device: the
    pager computes it per faulted frame, the resident engine over the
    whole index, and the two scans must rank alike."""
    d = codes.shape[-1]
    lead = codes.shape[:-1]
    flat = codes.reshape(-1, d)
    out = torch.empty((flat.shape[0],), dtype=torch.float32,
                      device=codes.device)
    for s in range(0, flat.shape[0], chunk_rows):
        v = decode(stats, flat[s:s + chunk_rows])
        out[s:s + chunk_rows] = pairwise_sum(v * v)
    return out.reshape(lead)


def stats_to_arrays(stats: QuantStats):
    return (stats.lo.cpu().numpy().astype(np.float32),
            stats.scale.cpu().numpy().astype(np.float32))


def stats_from_arrays(lo: np.ndarray, scale: np.ndarray,
                      device=None) -> QuantStats:
    """Host arrays -> QuantStats on `device` (None: the card)."""
    device = resolve_device(device)
    return QuantStats(
        lo=torch.as_tensor(np.asarray(lo, np.float32), device=device),
        scale=torch.as_tensor(np.asarray(scale, np.float32), device=device))
