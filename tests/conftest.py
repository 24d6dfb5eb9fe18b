"""Shared fixtures. NOTE: no XLA device-count flags here -- smoke tests
and benches must see 1 device; multi-device tests spawn subprocesses."""
import numpy as np
import pytest

from repro.core import ivf
from repro.core.types import IVFConfig


def clustered_data(n=2000, dim=32, n_clusters=20, seed=0, scale=5.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * scale
    asg = rng.integers(0, n_clusters, n)
    X = centers[asg] + rng.normal(size=(n, dim)).astype(np.float32)
    return X


@pytest.fixture(scope="session")
def small_index():
    X = clustered_data()
    cfg = IVFConfig(dim=32, target_partition_size=50, minibatch_size=128,
                    kmeans_iters=40, delta_capacity=256)
    return ivf.build_index(X, cfg=cfg), X


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skipped where none is present)")
