"""Synthetic vector workloads mirroring the paper's Table 2.

Public sets (SIFT/GIST/GLOVE/...) are not downloaded; they are
re-synthesised at matching dimensionality/metric as clustered Gaussian
mixtures; `scale` shrinks row counts while keeping the geometry. A copy of
repro.data.synthetic (same generator, same draws from the same seed);
exact ground truth is a chunked running top-k.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.types import resolve_device

# name -> (dim, n_vectors, n_queries, metric)   [paper Table 2]
TABLE2 = {
    "mnist": (784, 60_000, 10_000, "l2"),
    "nytimes": (256, 290_000, 10_000, "cosine"),
    "sift": (128, 1_000_000, 10_000, "l2"),
    "glove": (200, 1_183_514, 10_000, "l2"),
    "gist": (960, 1_000_000, 1_000, "l2"),
    "deepimage": (96, 10_000_000, 10_000, "cosine"),
    "internala": (512, 150_000, 1_000, "cosine"),
}


@dataclasses.dataclass
class Dataset:
    name: str
    metric: str
    X: np.ndarray          # [n, d]
    Q: np.ndarray          # [q, d]
    gt: Optional[np.ndarray] = None   # [q, k_gt] exact neighbour row idx

    @property
    def dim(self) -> int:
        return self.X.shape[1]


def make(name: str, scale: float = 0.01, k_gt: int = 100,
         seed: int = 0, with_gt: bool = True,
         n_clusters: Optional[int] = None) -> Dataset:
    dim, n, q, metric = TABLE2[name]
    n = max(1000, int(n * scale))
    q = max(32, min(int(q * scale), 512))
    rng = np.random.default_rng(seed)
    n_clusters = n_clusters or max(16, n // 500)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 4.0
    asg = rng.integers(0, n_clusters, n)
    X = centers[asg] + rng.normal(size=(n, dim)).astype(np.float32)
    qi = rng.integers(0, n, q)
    Q = X[qi] + 0.1 * rng.normal(size=(q, dim)).astype(np.float32)
    gt = exact_gt(X, Q, k_gt, metric) if with_gt else None
    return Dataset(name=name, metric=metric, X=X, Q=Q, gt=gt)


def mixture(n: int, dim: int, n_clusters: int, seed: int = 0,
            device=None) -> torch.Tensor:
    """`make`'s clustered Gaussian mixture at any size, drawn on `device`
    by a torch.Generator (a million-row table at a model's width is
    seconds of numpy draws, milliseconds on the card): centres N(0, 16 I),
    a uniform component per row, unit noise. Other numbers than `make`'s
    from the same seed; `device` None means the card. -> [n, dim]
    float32."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((n_clusters, dim), generator=g,
                          device=device) * 4.0
    asg = torch.randint(0, n_clusters, (n,), generator=g, device=device)
    return centers[asg] + torch.randn((n, dim), generator=g, device=device)


def exact_gt(X: np.ndarray, Q: np.ndarray, k: int, metric: str,
             chunk: int = 65536) -> np.ndarray:
    """Chunked brute-force ground truth (row indices into X, best first).

    A running top-k over row chunks: memory stays O(Q * (k + chunk)) where
    a full [Q, n] argsort would not fit at a million rows."""
    if metric == "cosine":
        X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
        Q = Q / np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-12)
    k = min(k, len(X))
    best_s = np.full((len(Q), 0), np.inf, np.float32)
    best_i = np.zeros((len(Q), 0), np.int64)
    for i in range(0, len(X), chunk):
        xc = X[i:i + chunk]
        if metric == "cosine":
            s = -(Q @ xc.T)
        else:
            s = np.sum(xc * xc, axis=1)[None, :] - 2.0 * (Q @ xc.T)
        s = np.concatenate([best_s, s.astype(np.float32)], axis=1)
        idx = np.concatenate(
            [best_i, np.broadcast_to(np.arange(i, i + len(xc)),
                                     (len(Q), len(xc)))], axis=1)
        keep = np.argsort(s, axis=1, kind="stable")[:, :k]
        best_s = np.take_along_axis(s, keep, axis=1)
        best_i = np.take_along_axis(idx, keep, axis=1)
    return best_i


def recall(ids: np.ndarray, gt_rows: np.ndarray, row_ids: np.ndarray,
           k: int) -> float:
    """recall@k of result asset ids vs ground-truth rows (mapped to ids)."""
    gt_ids = row_ids[gt_rows[:, :k]]
    hits = 0
    for a, b in zip(ids[:, :k], gt_ids):
        hits += len(set(int(x) for x in a if x >= 0) & set(map(int, b)))
    return hits / (len(gt_ids) * k)
