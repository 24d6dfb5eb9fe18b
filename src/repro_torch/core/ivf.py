"""IVF index construction and the padded partition-major device layout
(port of repro.core.ivf).

Build path (paper §3.1-3.2): cluster with mini-batch balanced k-means,
then lay vectors out partition-major as the [k, p_max, d] tensor described
in core/types.py; `p_max` is the largest partition rounded up to
`cfg.pad_to` (no TPU int8 tile bump in the port).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..obs import trace as obs_trace
from . import kmeans, quantize
from .types import (DeltaStore, INVALID_ID, IVFConfig, IVFIndex, QuantStats,
                    normalize_if_cosine, resolve_device)


def pack_partitions(
    X: np.ndarray,                # [n, d] float32
    ids: np.ndarray,              # [n] int32
    attrs: Optional[np.ndarray],  # [n, n_attr] float32 or None
    assign: np.ndarray,           # [n] partition per row
    k: int,
    pad_to: int = 8,
    p_max: Optional[int] = None,
    codes: Optional[np.ndarray] = None,  # [n, d] int8 SQ codes or None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           Optional[np.ndarray]]:
    """Repack rows into the padded partition-major layout (host side).

    Vectorised: rows are stable-sorted by partition and each row's slot is
    its offset from its partition's first sorted row -- the same slot order
    as the reference's per-row loop, without a Python loop over n."""
    n, d = X.shape
    n_attr = 0 if attrs is None else attrs.shape[1]
    attrs = np.zeros((n, 0), np.float32) if attrs is None else attrs
    assign = np.asarray(assign, np.int64)
    counts = np.bincount(assign, minlength=k).astype(np.int32)
    if p_max is None:
        p_max = int(counts.max()) if n else pad_to
        p_max = max(pad_to, -(-p_max // pad_to) * pad_to)

    vec = np.zeros((k, p_max, d), np.float32)
    vid = np.full((k, p_max), INVALID_ID, np.int32)
    vat = np.zeros((k, p_max, n_attr), np.float32)
    val = np.zeros((k, p_max), bool)
    cod = None if codes is None else np.zeros((k, p_max, d), np.int8)

    order = np.argsort(assign, kind="stable")
    part = assign[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    slot = np.arange(n, dtype=np.int64) - starts[part]
    if n and slot.max() >= p_max:
        p = int(part[np.argmax(slot)])
        raise ValueError(f"partition {p} overflows p_max={p_max}")
    vec[part, slot] = X[order]
    vid[part, slot] = ids[order]
    vat[part, slot] = attrs[order]
    val[part, slot] = True
    if cod is not None:
        cod[part, slot] = codes[order]
    return vec, vid, vat, val, counts, cod


def index_from_packed(packed, centroids: np.ndarray, csizes: np.ndarray,
                      cfg: IVFConfig, qstats: Optional[QuantStats],
                      device, base_mean_size: float) -> IVFIndex:
    """Upload a pack_partitions result (plus clustering state) as an
    IVFIndex on `device`, with code norms computed there."""
    vec, vid, vat, val, counts, cod = packed
    dev = torch.device(device)
    k, _, d = vec.shape
    codes = None if cod is None else torch.from_numpy(cod).to(dev)
    if qstats is not None:
        qstats = QuantStats(lo=qstats.lo.to(dev), scale=qstats.scale.to(dev))
    return IVFIndex(
        centroids=torch.as_tensor(np.asarray(centroids, np.float32),
                                  device=dev),
        csizes=torch.as_tensor(np.asarray(csizes, np.float32), device=dev),
        vectors=torch.from_numpy(vec).to(dev),
        ids=torch.from_numpy(vid).to(dev),
        attrs=torch.from_numpy(vat).to(dev),
        valid=torch.from_numpy(val).to(dev),
        counts=torch.from_numpy(counts.astype(np.int32)).to(dev),
        delta=DeltaStore.empty(cfg.delta_capacity, d, vat.shape[-1],
                               quantized=codes is not None, device=dev),
        base_mean_size=base_mean_size,
        codes=codes,
        qstats=qstats if codes is not None else None,
        code_norms=None if codes is None
        else quantize.row_norms(qstats, codes),
        drift=torch.zeros((k,), dtype=torch.float32, device=dev),
        config=cfg)


def build_index(X: np.ndarray, ids: Optional[np.ndarray] = None,
                attrs: Optional[np.ndarray] = None,
                cfg: Optional[IVFConfig] = None, k: Optional[int] = None,
                qstats: Optional[QuantStats] = None,
                device=None) -> IVFIndex:
    """Full index build: Alg. 1 clustering + partition-major packing.

    With cfg.quantize == "int8" the build also trains the scalar quantizer
    (unless stats are passed) and encodes every row into the code tier.
    `device` None means the card (types.resolve_device). Its stages
    (quantize, kmeans_fit, kmeans_assign, pack, upload) record into the
    thread's active trace (MicroNN.build() activates one)."""
    cfg = cfg or IVFConfig(dim=X.shape[1])
    dev = resolve_device(device)
    Xd = normalize_if_cosine(
        torch.as_tensor(np.asarray(X, np.float32), device=dev), cfg.metric)
    n = Xd.shape[0]
    ids = np.arange(n, dtype=np.int32) if ids is None \
        else np.asarray(ids).astype(np.int32)
    codes = None
    if cfg.quantize == "int8":
        with obs_trace.stage("quantize"):
            if qstats is None:
                qstats = quantize.train(Xd)
            qstats = QuantStats(lo=qstats.lo.to(dev),
                                scale=qstats.scale.to(dev))
            codes = quantize.encode(qstats, Xd).cpu().numpy()
    else:
        qstats = None
    Xn = Xd.cpu().numpy()
    del Xd
    centroids, csizes, assign = kmeans.fit_in_memory(Xn, cfg, k=k,
                                                     device=dev)
    k = centroids.shape[0]
    with obs_trace.stage("pack"):
        packed = pack_partitions(Xn, ids, attrs, assign, k,
                                 pad_to=cfg.pad_to, codes=codes)
    counts = packed[4]
    base = float(np.float32(counts.mean())) if n else 0.0
    with obs_trace.stage("upload"):
        return index_from_packed(packed, centroids, csizes, cfg, qstats,
                                 dev, base)


def grow_layout(index: IVFIndex, new_p_max: int) -> IVFIndex:
    """Grow p_max (host-side maintenance; shapes stay static between
    maintenance points)."""
    k, p_max, d = index.vectors.shape
    if new_p_max < p_max:
        raise ValueError("grow_layout cannot shrink p_max")
    pad = new_p_max - p_max

    def pad2(a, fill):
        widths = [0, 0] * (a.dim() - 2) + [0, pad, 0, 0]
        return torch.nn.functional.pad(a, widths, value=fill)

    codes = None if index.codes is None else pad2(index.codes, 0)
    return dataclasses.replace(
        index,
        vectors=pad2(index.vectors, 0.0),
        ids=pad2(index.ids, INVALID_ID),
        attrs=pad2(index.attrs, 0.0),
        valid=pad2(index.valid, False),
        codes=codes,
        # recompute (not pad) so padded slots carry decode-of-zero norms
        code_norms=None if codes is None
        else quantize.row_norms(index.qstats, codes))
