"""The serving front door on the card: coalesced callers get their solo
answers bit for bit, f32 (K1) and int8 (K2), resident and paged, with the
fused call above and below the CPU's gather-plan size (on the card every
batch takes the union plan, so the equality holds at every Q).

Marked `gpu`: skipped where no CUDA device is present. On a machine with a
card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_serving_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.query import Q
from repro_torch.core.types import IVFConfig
from repro_torch.kernels import ops
from repro_torch.serving import FrontDoor
from repro_torch.storage.engine import MicroNN

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n_callers", [7, 12])
@pytest.mark.parametrize("tier", ["none", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_frontdoor_coalesced_equals_solo_on_cuda(cuda, tmp_path, paged, tier,
                                                 n_callers):
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(20, 32)).astype(np.float32) * 5
    X = (centers[rng.integers(0, 20, 3000)]
         + rng.normal(size=(3000, 32))).astype(np.float32)
    eng = MicroNN(dim=32, path=str(tmp_path / "s.db"),
                  config=IVFConfig(dim=32, target_partition_size=50,
                                   kmeans_iters=8, quantize=tier),
                  memory_budget_mb=0.2 if paged else None)
    eng.upsert(np.arange(len(X)), X)
    eng.build()
    spec = Q.knn(k=10, n_probe=6)
    queries = X[:n_callers] + 0.01
    solo = [eng.query(queries[i], spec).to_numpy() for i in range(n_callers)]
    name = "sq_scan_topk" if tier == "int8" else "ivf_scan_topk"
    before = ops.launch_counts()[name]
    with FrontDoor(eng, window_s=30.0, max_batch_rows=n_callers) as fd:
        futs = [fd.submit(queries[i], spec) for i in range(n_callers)]
        outs = [f.result(120).to_numpy() for f in futs]
        st = fd.stats()
    assert st["batches"] == 1 and st["coalesced"] == n_callers
    assert ops.launch_counts()[name] > before
    for a, b in zip(outs, solo):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    eng.close()
