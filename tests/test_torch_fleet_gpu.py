"""The fleet on the card: every tenant's answers through the shared frame
pool equal a solo paged engine's on a copy of its durable state, ids and
scores bit for bit, f32 (K1) and int8 (K2), while the tenants interleave
on a pool tighter than one tenant's partitions.

Marked `gpu`: skipped where no CUDA device is present. On a machine with a
card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_fleet_gpu.py
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core.query import Q
from repro_torch.core.types import IVFConfig
from repro_torch.fleet import Fleet
from repro_torch.kernels import ops
from repro_torch.storage.engine import MicroNN

pytestmark = pytest.mark.gpu

DIM = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("tier,budget_mb", [("none", 0.3), ("int8", 0.1)])
def test_fleet_equals_solo_on_cuda(cuda, tmp_path, tier, budget_mb):
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=8,
                    quantize=tier)
    root = tmp_path / "fleet"
    fleet = Fleet(str(root), dim=DIM, budget_mb=budget_mb, config=cfg)
    assert fleet.device.type == "cuda"
    data = {}
    for t in range(3):
        rng = np.random.default_rng(t)
        centers = rng.normal(size=(20, DIM)).astype(np.float32) * 5
        X = (centers[rng.integers(0, 20, 3000)]
             + rng.normal(size=(3000, DIM))).astype(np.float32)
        eng = fleet.get(f"t{t}")
        eng.upsert(np.arange(len(X)), X)
        eng.build()
        eng.store.db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        data[f"t{t}"] = X
    assert fleet.pool.capacity < fleet.get("t0").index.k
    spec = Q.knn(k=10, n_probe=8)
    solo = {}
    for name, X in data.items():
        dst = str(tmp_path / f"{name}.db")
        shutil.copy(os.path.join(root, f"{name}.db"), dst)
        eng = MicroNN(dim=DIM, path=dst, config=cfg,
                      memory_budget_mb=budget_mb)
        eng.recover()
        solo[name] = [eng.query(X[i:i + n] + 0.01, spec).to_numpy()
                      for i, n in ((0, 1), (1, 4), (5, 16))]
        eng.close()
    kernel = "sq_scan_topk" if tier == "int8" else "ivf_scan_topk"
    before = ops.launch_counts()[kernel]
    for _ in range(2):              # interleave so the frames compete
        for name, X in data.items():
            got = [fleet.query(name, X[i:i + n] + 0.01, spec).to_numpy()
                   for i, n in ((0, 1), (1, 4), (5, 16))]
            for (gi, gs), (si, ss) in zip(got, solo[name]):
                np.testing.assert_array_equal(gi, si)
                np.testing.assert_array_equal(gs, ss)
            assert fleet.pool.resident_bytes <= fleet.pool.budget_bytes
    assert ops.launch_counts()[kernel] > before
    assert fleet.stats()["pool"]["eviction_matrix"]
    fleet.close()
