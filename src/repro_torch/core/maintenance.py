"""The forced delta flush of index maintenance (paper §3.6; port of the
flush half of repro.core.maintenance).

Each live delta vector goes to the partition with the nearest centroid;
centroids update by the running-mean rule c' = (v*c + sum x) / (v + m).
The flush is a host-side repack of the touched partitions (it changes row
placement); the nearest-centroid assignment runs on the index's device.
Split / merge / recluster planning, the monitor and the scheduler are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import quantize
from .types import (DeltaStore, INVALID_ID, IVFIndex, pairwise_scores)


@dataclasses.dataclass
class MaintenanceStats:
    kind: str                 # "incremental"
    rows_moved: int
    partitions_touched: int
    bytes_written: int        # host-tier write I/O (flash-wear metric)
    p_max_before: int
    p_max_after: int


def assign_nearest_centroid(dx: np.ndarray, centroids: torch.Tensor
                            ) -> np.ndarray:
    """Nearest-centroid assignment for a flush batch, l2 over the
    (metric-normalised) rows -- for cosine data rows and centroids are
    unit-norm, so l2 order == cosine order."""
    x = torch.as_tensor(np.asarray(dx, np.float32), device=centroids.device)
    return torch.argmin(pairwise_scores(x, centroids, "l2"),
                        dim=-1).cpu().numpy()


def running_mean_update(cent: np.ndarray, csizes: np.ndarray,
                        dx: np.ndarray, assign: np.ndarray,
                        touched: np.ndarray,
                        drift: Optional[np.ndarray] = None):
    """c' = (v*c + sum x)/(v+m) per touched partition, in place, as one
    np.add.at scatter (rows accumulate in row order, like a loop). When
    `drift` is given, each touched centroid's displacement accumulates."""
    sums = np.zeros_like(cent)
    np.add.at(sums, assign, dx)
    m = np.bincount(assign, minlength=cent.shape[0]).astype(csizes.dtype)
    t = np.asarray(touched)
    old = cent[t].copy() if drift is not None else None
    v = csizes[t]
    cent[t] = (v[:, None] * cent[t] + sums[t]) \
        / np.maximum(v + m[t], 1.0)[:, None]
    csizes[t] = v + m[t]
    if drift is not None:
        drift[t] += np.linalg.norm(cent[t] - old, axis=-1)


def _row_bytes(index: IVFIndex) -> int:
    codes = index.dim if index.codes is not None else 0
    return 4 * index.dim + 4 + 4 * index.n_attr + 1 + codes


def compact_delta(d: DeltaStore, keep: np.ndarray, n_attr: int,
                  quantized: bool, qstats=None) -> DeltaStore:
    """The delta rows listed in `keep`, compacted into a fresh DeltaStore
    (the tail of a partial flush)."""
    cap, dim = d.capacity, d.vectors.shape[1]
    dev = d.vectors.device
    out = DeltaStore.empty(cap, dim, n_attr, quantized=quantized, device=dev)
    if keep.size == 0:
        return out
    r = keep.size
    kt = torch.as_tensor(keep, device=dev)
    out.vectors[:r] = d.vectors[kt]
    out.ids[:r] = d.ids[kt]
    out.attrs[:r] = d.attrs[kt]
    out.valid[:r] = True
    out.count = r
    if quantized:
        out.codes[:r] = d.codes[kt] if d.codes is not None \
            else quantize.encode(qstats, out.vectors[:r])
    return out


def flush_delta(index: IVFIndex, max_rows: Optional[int] = None,
                assign: Optional[np.ndarray] = None
                ) -> Tuple[IVFIndex, MaintenanceStats]:
    """Fold live delta rows into the IVF partitions. `max_rows` bounds the
    work (the first `max_rows` live rows in slot order; the rest stay in
    the delta, compacted); `assign` skips the assignment when the caller
    already computed it."""
    cfg = index.config
    k, p_max, d = index.vectors.shape
    dev = index.device
    quantized = index.codes is not None
    live = np.nonzero(index.delta.valid.cpu().numpy())[0]
    deferred = np.zeros((0,), np.int64)
    if max_rows is not None and live.size > max_rows:
        live, deferred = live[:max_rows], live[max_rows:]
    if live.size == 0:
        new = dataclasses.replace(
            index, delta=compact_delta(index.delta, deferred, index.n_attr,
                                       quantized, index.qstats))
        return new, MaintenanceStats("incremental", 0, 0, 0, p_max, p_max)

    dx = index.delta.vectors.cpu().numpy()[live]
    dids = index.delta.ids.cpu().numpy()[live]
    dattrs = index.delta.attrs.cpu().numpy()[live]
    if quantized:
        dcod = (index.delta.codes.cpu().numpy()[live]
                if index.delta.codes is not None
                else quantize.encode_np(index.qstats, dx))
    if assign is None:
        assign = assign_nearest_centroid(dx, index.centroids)
    if len(assign) != live.size:
        raise ValueError("flush assignment does not match the live rows")

    vec = index.vectors.cpu().numpy().copy()
    vid = index.ids.cpu().numpy().copy()
    vat = index.attrs.cpu().numpy().copy()
    val = index.valid.cpu().numpy().copy()
    counts = index.counts.cpu().numpy().copy()
    csizes = index.csizes.cpu().numpy().copy()
    cent = index.centroids.cpu().numpy().copy()
    cod = index.codes.cpu().numpy().copy() if quantized else None

    # grow p_max if some partition would overflow (tombstoned slots are
    # reused first)
    add = np.bincount(assign, minlength=k)
    need = val.sum(-1) + add
    pad = cfg.pad_to
    new_p_max = max(p_max, -(-int(need.max()) // pad) * pad)
    if new_p_max > p_max:
        grow = new_p_max - p_max
        vec = np.pad(vec, [(0, 0), (0, grow), (0, 0)])
        vid = np.pad(vid, [(0, 0), (0, grow)], constant_values=INVALID_ID)
        vat = np.pad(vat, [(0, 0), (0, grow), (0, 0)])
        val = np.pad(val, [(0, 0), (0, grow)])
        if quantized:
            cod = np.pad(cod, [(0, 0), (0, grow), (0, 0)])

    touched = np.unique(assign)
    for p in touched:
        keep = np.nonzero(val[p])[0]
        sel = assign == p
        newv = np.concatenate([vec[p][keep], dx[sel]])
        newi = np.concatenate([vid[p][keep], dids[sel]])
        newa = np.concatenate([vat[p][keep], dattrs[sel]])
        m = len(newv)
        vec[p, :m] = newv
        vec[p, m:] = 0.0
        vid[p, :m] = newi
        vid[p, m:] = INVALID_ID
        vat[p, :m] = newa
        vat[p, m:] = 0.0
        val[p, :m] = True
        val[p, m:] = False
        if quantized:
            newc = np.concatenate([cod[p][keep], dcod[sel]])
            cod[p, :m] = newc
            cod[p, m:] = 0
        counts[p] = m
    drift = index.drift.cpu().numpy().astype(np.float32).copy() \
        if index.drift is not None else np.zeros((k,), np.float32)
    running_mean_update(cent, csizes, dx, assign, touched, drift=drift)

    stats = MaintenanceStats(
        kind="incremental", rows_moved=int(live.size),
        partitions_touched=int(len(touched)),
        # a clustered B-tree append touches only the inserted rows' pages:
        # moved rows + the touched partitions' centroid rewrites
        bytes_written=int(live.size * _row_bytes(index)
                          + len(touched) * d * 4),
        p_max_before=p_max, p_max_after=new_p_max)

    codes = torch.from_numpy(cod).to(dev) if quantized else None
    new_index = IVFIndex(
        centroids=torch.from_numpy(cent).to(dev),
        csizes=torch.from_numpy(csizes).to(dev),
        vectors=torch.from_numpy(vec).to(dev),
        ids=torch.from_numpy(vid).to(dev),
        attrs=torch.from_numpy(vat).to(dev),
        valid=torch.from_numpy(val).to(dev),
        counts=torch.from_numpy(counts).to(dev),
        delta=compact_delta(index.delta, deferred, index.n_attr, quantized,
                            index.qstats),
        base_mean_size=index.base_mean_size,
        codes=codes,
        qstats=index.qstats,
        code_norms=quantize.row_norms(index.qstats, codes)
        if quantized else None,
        drift=torch.from_numpy(drift).to(dev),
        config=cfg)
    return new_index, stats
