"""Carry a JAX-built index into the port.

`index_from_arrays` turns the leaves of a `repro.core.types.IVFIndex`,
handed over as numpy arrays (`np.asarray` of each leaf, on the JAX side),
into this package's `IVFIndex` on `device`. The port never imports the
JAX package; the caller does the export:

    arrays = {"centroids": np.asarray(idx.centroids), ...,
              "delta.vectors": np.asarray(idx.delta.vectors), ...,
              "qstats.lo": np.asarray(idx.qstats.lo), ...}
    config = dataclasses.asdict(idx.config)
    tidx = index_from_arrays(arrays, config, "cuda")

Keys: centroids, csizes, vectors, ids, attrs, valid, counts,
delta.{vectors, ids, attrs, valid, count, codes}, codes, qstats.lo,
qstats.scale, code_norms, drift, base_mean_size. Quantizer and delta-code
keys may be absent (float32-only index).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.types import DeltaStore, IVFConfig, IVFIndex, QuantStats


def index_from_arrays(arrays: Dict[str, np.ndarray], config: dict,
                      device) -> IVFIndex:
    dev = torch.device(device)

    def t(key, dtype=None):
        a = arrays.get(key)
        if a is None:
            return None
        a = np.asarray(a)
        if dtype is not None:
            a = a.astype(dtype)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fields = set(IVFConfig.__dataclass_fields__)
    cfg = IVFConfig(**{k: v for k, v in config.items() if k in fields})
    delta = DeltaStore(
        vectors=t("delta.vectors", np.float32),
        ids=t("delta.ids", np.int32),
        attrs=t("delta.attrs", np.float32),
        valid=t("delta.valid", np.bool_),
        count=int(np.asarray(arrays["delta.count"])),
        codes=t("delta.codes", np.int8))
    qstats = None
    if arrays.get("qstats.lo") is not None:
        qstats = QuantStats(lo=t("qstats.lo", np.float32),
                            scale=t("qstats.scale", np.float32))
    return IVFIndex(
        centroids=t("centroids", np.float32),
        csizes=t("csizes", np.float32),
        vectors=t("vectors", np.float32),
        ids=t("ids", np.int32),
        attrs=t("attrs", np.float32),
        valid=t("valid", np.bool_),
        counts=t("counts", np.int32),
        delta=delta,
        base_mean_size=float(np.asarray(arrays["base_mean_size"])),
        codes=t("codes", np.int8),
        qstats=qstats,
        code_norms=t("code_norms", np.float32),
        drift=t("drift", np.float32),
        config=cfg)
