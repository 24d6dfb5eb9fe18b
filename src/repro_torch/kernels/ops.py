"""Thin public entry points over the three kernels (port of
repro.kernels.ops) and their launch counters.

The executor and the build call these. Each kernel module keeps a plain
integer `LAUNCHES` that its wrapper bumps right after a successful CUDA
launch; `launch_counts()` reads them and `reset_launch_counts()` zeroes
them, so a run can show that its main path went through every kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import ivf_scan as _ivf
from . import kmeans_assign as _km
from . import sq_scan as _sq

_MODULES = {"ivf_scan_topk": _ivf, "sq_scan_topk": _sq,
            "kmeans_assign": _km}


def scan_topk(queries, vectors, valid, ids, part_ids, k_out: int,
              metric: str = "l2", keep=None, attrs=None, program=None):
    """Fused partition-scan + top-k over a shared probe list."""
    return _ivf.ivf_scan_topk(queries, vectors, valid, ids, part_ids, k_out,
                              metric=metric, keep=keep, attrs=attrs,
                              program=program)


def scan_topk_mqo(queries, vectors, valid, ids, part_ids, qsel, k_out: int,
                  metric: str = "l2", keep=None, attrs=None, program=None):
    """MQO variant: qsel [Q, n] masks which query wants which partition."""
    return _ivf.ivf_scan_topk(queries, vectors, valid, ids, part_ids, k_out,
                              metric=metric, qsel=qsel, keep=keep,
                              attrs=attrs, program=program)


def sq_scan_topk(queries, codes, lo, scale, valid, ids, part_ids, k_out: int,
                 metric: str = "l2", qsel=None, keep=None, norms=None,
                 attrs=None, program=None):
    """Fused int8-domain scan + top-k over the code tier."""
    return _sq.sq_scan_topk(queries, codes, lo, scale, valid, ids, part_ids,
                            k_out, metric=metric, qsel=qsel, keep=keep,
                            norms=norms, attrs=attrs, program=program)


def assign_nearest(batch, centroids, counts, *, balance_weight: float = 0.0,
                   target_size: int = 100, scale=1.0):
    """Penalised nearest-centroid assignment (Alg. 1 NEAREST, batch form)."""
    return _km.kmeans_assign(batch, centroids, counts,
                             balance_weight=balance_weight,
                             target_size=target_size, scale=scale)


def index_scan_topk(index, queries, k_out: int, n_probe: int):
    """Kernel-backed Alg. 2 over an IVFIndex, no delta and no filters (the
    executor integrates those): every query's n_probe nearest partitions,
    flattened in query order -- duplicates included, as in the reference --
    form one shared probe list that K1 scans for every query."""
    from ..core.executor import find_nearest_centroids
    parts = find_nearest_centroids(index, queries, n_probe)
    return scan_topk(queries, index.vectors, index.valid, index.ids,
                     parts.reshape(-1).to(torch.int32), k_out,
                     metric=index.config.metric)


def launch_counts() -> Dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.LAUNCHES = 0
