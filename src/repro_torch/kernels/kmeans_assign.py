"""Penalised nearest-centroid assignment: the wrapper of the CUDA kernel in
csrc/kmeans_assign.cu, which replaces the Pallas TPU kernel
repro/kernels/kmeans_assign.py::kmeans_assign.

The balance penalty (lambda * scale * count / target, Alg. 1 NEAREST) is
folded into a per-centroid vector here, as the Pallas wrapper does, so the
kernel streams the batch and the centroids only. With balance_weight 0 it
is the build's unbalanced final assignment pass (core/kmeans.final_assign).
CPU tensors run the plain version (`kmeans_assign_plain`), CUDA tensors
launch the kernel -- no fallback either way. `LAUNCHES` counts launches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import build, common
from .ref import kmeans_assign_ref as kmeans_assign_plain

LAUNCHES = 0
TILE = 128      # rows per block and centroids per tile of the kernel


def balance_penalty(counts: torch.Tensor, balance_weight: float,
                    target_size: int, scale) -> torch.Tensor:
    """[k] float32 penalty counts * (lambda * scale / target), in the
    Pallas wrapper's float32 operation order. The scalar weight is formed
    on the host: building it on the device would cost a blocking copy per
    call, as much as the kernel itself at the build's shapes."""
    w = np.float32(np.float32(balance_weight) * np.float32(scale)) \
        / np.float32(target_size)
    return counts.to(torch.float32) * float(w)


def kmeans_assign(
    batch: torch.Tensor,        # [s, d] f32
    centroids: torch.Tensor,    # [k, d] f32
    counts: torch.Tensor,       # [k] f32
    *,
    balance_weight: float = 0.0,
    target_size: int = 100,
    scale=1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (assign [s] int32, best penalised cost [s] f32)."""
    penalty = balance_penalty(counts, balance_weight, target_size, scale)
    if batch.device.type == "cpu":
        return kmeans_assign_plain(batch.to(torch.float32),
                                   centroids.to(torch.float32), penalty)
    return _launch(batch, centroids, penalty)


def _group_plan(s: int, k: int, device: torch.device):
    """(n_groups, per_group): split the centroids into ranges (multiples
    of the 128-wide tile) so that (row blocks x groups) fills the card's
    SMs once: the tile kernel runs one 256-thread block per SM, and a
    second wave would run almost empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_blocks = -(-s // TILE)
    tiles = -(-k // TILE)
    n_groups = max(1, min(tiles, sms // row_blocks))
    per_group = -(-tiles // n_groups) * TILE
    return -(-k // per_group), per_group


def _launch(batch, centroids, penalty):
    global LAUNCHES
    dev = batch.device
    common.require_cuda("kmeans_assign", dev, centroids, penalty)
    s, d = batch.shape
    k, dc = centroids.shape
    if dc != d:
        raise ValueError(f"kmeans_assign: batch width {d} != centroid "
                         f"width {dc}")
    if k == 0:
        raise ValueError("kmeans_assign: no centroids")
    common.require_shape("kmeans_assign", (k,), penalty=penalty)
    out_i = torch.empty((s,), dtype=torch.int32, device=dev)
    out_d = torch.empty((s,), dtype=torch.float32, device=dev)
    if s == 0:
        return out_i, out_d
    n_groups, per_group = _group_plan(s, k, dev)
    part_d = torch.empty((n_groups, s), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_groups, s), dtype=torch.int32, device=dev)
    sqn = torch.empty((s + k,), dtype=torch.float32, device=dev)
    ins = [common.as_dtype(t, torch.float32)
           for t in (batch, centroids, penalty)]
    rc = build.load("kmeans_assign").kmeans_assign_launch(
        *[common.ptr(t) for t in ins], s, k, d, n_groups, per_group,
        common.ptr(sqn), common.ptr(part_d), common.ptr(part_i),
        common.ptr(out_i), common.ptr(out_d), common.stream_ptr(dev))
    build.check_launch("kmeans_assign", rc)
    LAUNCHES += 1
    return out_i, out_d
