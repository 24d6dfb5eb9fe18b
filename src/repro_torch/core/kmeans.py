"""Mini-batch k-means with flexible balance constraints (paper Alg. 1;
port of repro.core.kmeans).

  * k = |X| / target_cluster_size, centroids seeded from random rows;
  * per iteration a uniform random mini-batch, assigned by NEAREST under a
    balance penalty so large clusters repel new members;
  * the grouped running-mean update c' = (v*c + sum x) / (v + m);
  * a final pass assigns every row to its plain nearest centre.

The in-batch balanced assignment is order-dependent (counts move within a
batch), so it stays a sequential arg-min over the batch rows -- one float
flip there changes every later assignment. The unbalanced final pass is
the kmeans_assign kernel (penalty 0). Sampling uses numpy's generator with
the configured seed, so the port draws the same mini-batches as the JAX
package.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..kernels import ops
from ..obs import trace as obs_trace
from .types import (IVFConfig, f32_matmul, normalize_if_cosine,
                    pairwise_scores, resolve_device)


def assign_minibatch(centroids: torch.Tensor, counts: torch.Tensor,
                     batch: torch.Tensor, *, balance_weight: float,
                     target_size: int):
    """Lines 6-13 of Alg. 1 for one mini-batch.
    Returns (new_centroids, new_counts, assignments [s] int32)."""
    s = batch.shape[0]
    k = centroids.shape[0]
    dist = pairwise_scores(batch, centroids, "l2")        # [s, k]
    # penalty scale: mean nearest-centroid distance in this batch
    scale = torch.mean(torch.amin(dist, dim=-1)) + 1e-12
    bs = balance_weight * scale
    v = counts.clone()
    assign = torch.empty((s,), dtype=torch.int64, device=batch.device)
    one = torch.ones((1,), dtype=v.dtype, device=v.device)
    # sequential NEAREST: counts advance within the batch (no host sync)
    for i in range(s):
        c = torch.argmin(dist[i] + bs * v / target_size)
        assign[i] = c
        v.index_add_(0, c.view(1), one)
    onehot = torch.nn.functional.one_hot(assign, k).to(batch.dtype)
    batch_counts = onehot.sum(dim=0)
    batch_sums = f32_matmul(onehot.T, batch)              # [k, d]
    new_counts = counts + batch_counts
    denom = torch.clamp(new_counts, min=1.0)[:, None]
    new_centroids = (counts[:, None] * centroids + batch_sums) / denom
    # centres with no prior mass and no batch members stay put
    new_centroids = torch.where(new_counts[:, None] > 0, new_centroids,
                                centroids)
    return new_centroids, new_counts, assign.to(torch.int32)


def final_assign(centroids: torch.Tensor, counts: torch.Tensor,
                 batch: torch.Tensor, *, balance_weight: float,
                 target_size: int, balanced: bool):
    """Lines 15-16: plain nearest centre by default, through the
    kmeans_assign kernel at penalty 0 (the same arg-min, first index on
    ties). `balanced=True` reuses the penalised sequential assignment."""
    if not balanced:
        assign, _ = ops.assign_nearest(batch, centroids, counts,
                                       balance_weight=0.0,
                                       target_size=target_size)
        return counts, assign
    _, new_v, assign = assign_minibatch(
        centroids, counts, batch, balance_weight=balance_weight,
        target_size=target_size)
    return new_v, assign


class MiniBatchKMeans:
    """Host-side loop streaming mini-batches; the device does the math.

    `fit` draws from any sampler callable and `assign` streams any batch
    iterator, so the full dataset need not sit on the device at once."""

    def __init__(self, cfg: IVFConfig, k: Optional[int] = None,
                 device=None):
        self.cfg = cfg
        self.k = k
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.counts: Optional[np.ndarray] = None

    def _rows(self, x: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return normalize_if_cosine(t, self.cfg.metric)

    def fit(self, sample_batch: Callable[[int, np.random.Generator],
                                         np.ndarray],
            n_total: int, rng: Optional[np.random.Generator] = None
            ) -> np.ndarray:
        """sample_batch(size, rng) -> [size, d] float32 uniform random rows."""
        cfg = self.cfg
        rng = rng or np.random.default_rng(cfg.seed)
        k = self.k or max(1, n_total // cfg.target_partition_size)
        self.k = k
        centroids = self._rows(sample_batch(k, rng))
        counts = torch.zeros((k,), dtype=torch.float32, device=self.device)
        for _ in range(cfg.kmeans_iters):
            batch = self._rows(sample_batch(cfg.minibatch_size, rng))
            centroids, counts, _ = assign_minibatch(
                centroids, counts, batch, balance_weight=cfg.balance_weight,
                target_size=cfg.target_partition_size)
        self.centroids = centroids.cpu().numpy()
        self.counts = counts.cpu().numpy()
        return self.centroids

    def assign(self, batch_iter: Iterator[np.ndarray]) -> np.ndarray:
        """Final full-data assignment pass, streamed in batches."""
        cfg = self.cfg
        if self.centroids is None:
            raise RuntimeError("fit() first")
        centroids = torch.as_tensor(self.centroids, device=self.device)
        counts = torch.as_tensor(self.counts, device=self.device)
        out = []
        for batch in batch_iter:
            counts, assign = final_assign(
                centroids, counts, self._rows(batch),
                balance_weight=cfg.balance_weight,
                target_size=cfg.target_partition_size,
                balanced=cfg.balanced_final_assign)
            out.append(assign)
        self.counts = counts.cpu().numpy()
        if not out:
            return np.zeros((0,), np.int32)
        return torch.cat(out).cpu().numpy()


def fit_in_memory(X: np.ndarray, cfg: IVFConfig, k: Optional[int] = None,
                  device=None):
    """Fit + assign over an in-memory array -> (centroids, counts, assign),
    as the stages kmeans_fit and kmeans_assign of the thread's active
    trace."""
    km = MiniBatchKMeans(cfg, k=k, device=device)

    def sample(size: int, rng: np.random.Generator) -> np.ndarray:
        idx = rng.integers(0, X.shape[0], size=size)
        return X[idx]

    with obs_trace.stage("kmeans_fit"):
        km.fit(sample, X.shape[0])
    bs = max(cfg.minibatch_size, 4096)
    with obs_trace.stage("kmeans_assign"):
        assign = km.assign(X[i:i + bs] for i in range(0, X.shape[0], bs))
    return km.centroids, km.counts, assign
