"""The hybrid planner's and the paged engine's device paths on the card.

Marked `gpu`: every test takes the `cuda` fixture, which skips when no
CUDA device is present (decided at run time, never at import). On a
machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest \
        tests/test_torch_paged_gpu.py

Paged == resident must hold bit for bit on the card (ids and scores): both
engines recover the same file, the paged union is the resident one, K1's
per-row scores do not depend on the chunking or the route, and the int8
pool carries the resident tier's norms, so K2 reads the same bits. The
pre-filter plan's K1 scan is held to its plain version with the usual
tolerance, 1e-5 * (||q||^2 + max ||v||^2).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import executor, ivf
from repro_torch.core.hybrid import Pred, compile_filter
from repro_torch.core.query import Q
from repro_torch.core.types import IVFConfig
from repro_torch.kernels import ivf_scan, kmeans_assign, ops
from repro_torch.storage.engine import MicroNN
from repro_torch.testing import compare_topk, score_tol

pytestmark = pytest.mark.gpu

DIM = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(30, DIM)).astype(np.float32) * 5.0
    X = (centers[rng.integers(0, 30, n)]
         + rng.normal(size=(n, DIM))).astype(np.float32)
    attrs = np.stack([rng.integers(0, 10, n), rng.random(n)],
                     axis=1).astype(np.float32)
    q = (X[rng.integers(0, n, 16)]
         + 0.3 * rng.normal(size=(16, DIM))).astype(np.float32)
    return X, attrs, q


def _engines(tmp_path, tier):
    """A file built by the port's resident engine on the card (with pending
    delta rows), recovered by a resident and by a paged engine whose budget
    seats a fraction of the partitions."""
    X, attrs, q = _data()
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=10,
                    delta_capacity=64, quantize=tier)
    path = str(tmp_path / f"{tier}.db")
    eng = MicroNN(dim=DIM, n_attr=2, path=path, config=cfg)
    eng.upsert(np.arange(len(X)), X, attrs)
    eng.build()
    eng.upsert(np.arange(9000, 9010), q[:10] + 0.05, attrs[:10])
    eng.close()
    res = MicroNN(dim=DIM, n_attr=2, path=path, config=cfg)
    res.recover()
    pag = MicroNN(dim=DIM, n_attr=2, path=path, config=cfg,
                  memory_budget_mb=0.1)
    pag.recover()
    assert pag.index.cache.capacity < pag.index.k
    return res, pag, X, attrs, q


def _bitwise(a, b):
    torch.cuda.synchronize()
    np.testing.assert_array_equal(a.to_numpy()[0], b.to_numpy()[0])
    np.testing.assert_array_equal(a.to_numpy()[1], b.to_numpy()[1])


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_paged_matches_resident_bitwise_on_cuda(cuda, tmp_path, tier):
    res, pag, X, attrs, q = _engines(tmp_path, tier)
    scan = "sq_scan_topk" if tier == "int8" else "ivf_scan_topk"
    for n_q in (1, 16):
        for spec in (Q.knn(k=10, n_probe=8), Q.knn(k=40, n_probe=3),
                     Q.knn(k=10, n_probe=8).where(Pred(0, "==", 2))
                     .postfilter()):
            before = ops.launch_counts()[scan]
            got = pag.query(q[:n_q], spec)
            assert ops.launch_counts()[scan] > before
            _bitwise(res.query(q[:n_q], spec), got)
    assert pag.stats()["resident_bytes"] <= int(0.1 * 2 ** 20)
    assert pag.stats()["evictions"] > 0
    res.close()
    pag.close()


def test_paged_exact_f32_matches_resident_bitwise_on_cuda(cuda, tmp_path):
    res, pag, X, attrs, q = _engines(tmp_path, "none")
    for n_q in (1, 8):
        _bitwise(res.query(q[:n_q], Q.exact(k=20)),
                 pag.query(q[:n_q], Q.exact(k=20)))
    res.close()
    pag.close()


def test_paged_engine_on_cuda_matches_cpu(cuda, tmp_path):
    """The same file paged on the card and on the CPU: ids equal under
    the tie rule, scores within the tolerance."""
    res, pag, X, attrs, q = _engines(tmp_path, "int8")
    cpu = MicroNN(dim=DIM, n_attr=2, path=pag.store.path, config=pag.config,
                  memory_budget_mb=0.1, device="cpu")
    cpu.recover()
    v2 = float(np.sum(X * X, -1).max())
    for spec in (Q.knn(k=10, n_probe=8), Q.exact(k=10)):
        a, b = cpu.query(q, spec), pag.query(q, spec)
        torch.cuda.synchronize()
        err, ok, bad = compare_topk(a.to_numpy()[1], a.to_numpy()[0],
                                    b.to_numpy()[1], b.to_numpy()[0],
                                    score_tol(q, v2))
        assert ok, f"{bad} rows differ (max err {err:.3e})"
    for e in (res, pag, cpu):
        e.close()


def _moved(idx, device):
    """A float32 IVFIndex with every tensor moved to `device`."""
    def mv(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})
    return dataclasses.replace(mv(idx), delta=mv(idx.delta))


@pytest.mark.parametrize("cap", [256, 2048])
def test_prefilter_plan_kernel_matches_plain(cuda, cap):
    """The pre-filter plan's scan through K1 (exact route over virtual
    partitions) against the same plan on the CPU's plain version."""
    X, attrs, q = _data()
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=10)
    idx = ivf.build_index(X, attrs=attrs, cfg=cfg)
    # the same index on both sides: the card's, copied to the host
    idx_cpu = _moved(idx, "cpu")
    spec = Q.knn(k=20).where(Pred(1, "<", 0.1)).prefilter(cap)
    before = ivf_scan.LAUNCHES
    got = executor.run(idx, q, spec)
    assert ivf_scan.LAUNCHES == before + 1
    ref = executor.run(idx_cpu, q, spec)
    v2 = float(np.sum(X * X, -1).max())
    err, ok, bad = compare_topk(ref.to_numpy()[1], ref.to_numpy()[0],
                                got.to_numpy()[1], got.to_numpy()[0],
                                score_tol(q, v2))
    assert ok, f"{bad} rows differ (max err {err:.3e})"
    ids = got.to_numpy()[0]
    assert (attrs[ids[ids >= 0], 1] < 0.1).all()
    # the compaction on the card is the CPU's, row for row
    f = compile_filter(Pred(1, "<", 0.1))
    assert torch.equal(
        executor.plan_prefilter(idx, torch.from_numpy(q), 20, f,
                                cap).rows.cpu(),
        executor.plan_prefilter(idx_cpu, torch.from_numpy(q), 20, f,
                                cap).rows)


def test_engine_hybrid_and_paged_build_launch_kernels(cuda, tmp_path):
    """The optimizer's pre-filter plan launches K1, and the paged build's
    final assignment launches K3."""
    X, attrs, q = _data()
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=10,
                    quantize="int8")
    eng = MicroNN(dim=DIM, n_attr=2, path=str(tmp_path / "r.db"),
                  config=cfg)
    eng.upsert(np.arange(len(X)), X, attrs)
    eng.build()
    pred = Pred(1, "<", 0.005)
    assert eng.optimizer.choose(eng.index, pred, 8).plan == "pre"
    before = ivf_scan.LAUNCHES
    got = eng.query(q, Q.knn(k=10, n_probe=8).where(pred)).to_numpy()[0]
    assert ivf_scan.LAUNCHES > before
    assert (attrs[got[got >= 0], 1] < 0.005).all()
    eng.close()
    pag = MicroNN(dim=DIM, n_attr=2, path=str(tmp_path / "p.db"),
                  config=cfg, memory_budget_mb=0.1)
    pag.upsert(np.arange(len(X)), X, attrs)
    before = kmeans_assign.LAUNCHES
    pag.build()
    assert kmeans_assign.LAUNCHES > before
    got = pag.query(X[:4], Q.knn(k=1, n_probe=8)).to_numpy()[0]
    assert list(got[:, 0]) == [0, 1, 2, 3]
    pag.close()


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_maintenance_on_cuda_matches_cpu(cuda, tmp_path, tier):
    """The same splits and merges run on the card (resident and paged) and
    on the CPU leave the same durable state (partition of every asset,
    centroids, csizes, drift), and paged == resident bit for bit on the
    card afterwards."""
    import shutil
    X, attrs, q = _data()
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=10,
                    delta_capacity=128, quantize=tier, rerank_factor=4)
    path = str(tmp_path / f"m{tier}.db")
    eng = MicroNN(dim=DIM, n_attr=2, path=path, config=cfg, device="cpu")
    eng.upsert(np.arange(len(X)), X, attrs)
    eng.build()
    eng.close()
    engines = []
    for suffix, dev, budget in ((".cpu", "cpu", None), (".res", None, None),
                                (".pag", None, 0.1)):
        shutil.copy(path, path + suffix)
        e = MicroNN(dim=DIM, n_attr=2, path=path + suffix, config=cfg,
                    device=dev, memory_budget_mb=budget)
        e.recover()
        engines.append(e)
    rng = np.random.default_rng(5)
    c0 = X[:50].mean(0)
    for wave in range(2):
        nv = (c0 + rng.normal(size=(100, DIM)) * 0.3).astype(np.float32)
        ids = np.arange(9000 + wave * 100, 9100 + wave * 100)
        for e in engines:
            e.upsert(ids, nv, attrs[:100])
            e.delete(np.arange(wave * 200, wave * 200 + 150))
        steps = [[(r.action, r.pids, r.rows) for r in e.maintain(
            until_idle=True) if r.action != "repack"] for e in engines]
        assert steps[0] == steps[1] == steps[2]
    assert any(s.kind in ("split", "merge")
               for s in engines[1].maintenance_log)

    def durable(e):
        ids, parts, _ = e.store.all_rows()
        cents, csz = e.store.centroids()
        return ids, parts, cents, csz, e.store.maintenance_state()[1]
    want = durable(engines[0])
    for e in engines[1:]:
        for a, b in zip(durable(e), want):
            np.testing.assert_array_equal(a, b)
    res, pag = engines[1], engines[2]
    for n_q in (1, 16):
        for spec in (Q.knn(k=10, n_probe=8),
                     Q.knn(k=10, n_probe=8).where(Pred(0, "==", 2))
                     .postfilter()):
            _bitwise(res.query(q[:n_q], spec), pag.query(q[:n_q], spec))
    for e in engines:
        e.close()


def test_rebuild_on_cuda_launches_kmeans_assign(cuda, tmp_path):
    """maintain(force="rebuild") re-clusters through K3 in both modes."""
    X, attrs, q = _data(n=2000)
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=10,
                    quantize="int8")
    for budget in (None, 0.1):
        path = str(tmp_path / f"r{budget}.db")
        eng = MicroNN(dim=DIM, n_attr=2, path=path, config=cfg,
                      memory_budget_mb=budget)
        eng.upsert(np.arange(len(X)), X, attrs)
        eng.build()
        before = kmeans_assign.LAUNCHES
        assert eng.maintain(force="rebuild") == "rebuild"
        assert kmeans_assign.LAUNCHES > before
        got = eng.query(X[:8], Q.knn(k=1, n_probe=8)).to_numpy()[0]
        assert list(got[:, 0]) == list(range(8))
        eng.close()
