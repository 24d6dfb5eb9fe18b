"""The port's serving front door (repro_torch.serving.frontdoor), mirroring
tests/test_frontdoor.py, and held against the JAX package's FrontDoor.

  * Coalescing is invisible: callers sharing a QuerySpec get the answers
    of the solo query() each replaced, bit for bit. On the CPU's "torch"
    backend a bucket of at most 8 queries takes the gather plan, so the
    reference's case (7 callers -> one bucket of 8) keeps solo and
    coalesced calls on one plan, as it does in JAX. The paged f32 tier
    runs the plain float32 scan, whose matrix product on the CPU rounds by
    batch shape, so there the CPU case holds ids exactly and scores within
    1e-5 * (||q||^2 + max ||v||^2) (the reference's own xla-paged case
    fails its bitwise check on the CPU too); on the card every tier is bit
    for bit (tests/test_torch_serving_gpu.py, chip_smoke.py).
  * One fused call is one executor.run_count() step (the port has no jit
    to count traces of).
  * Concurrency is safe: queries, session upserts and daemon maintenance
    from many threads leave the durable state of a single-threaded twin,
    and post-quiesce front-door answers equal direct query() bit for bit.
  * Against JAX: the same callers on one JAX-written database get equal
    ids and scores within the tolerance above.
"""
import asyncio
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.query import Q as JQ
from repro.core.types import IVFConfig as JConfig
from repro.serving import FrontDoor as JFrontDoor
from repro.storage.engine import MicroNN as JMicroNN
from repro_torch.core import executor
from repro_torch.core.query import Q, QuerySpec
from repro_torch.core.types import IVFConfig
from repro_torch.serving import FrontDoor, empty_stats
from repro_torch.storage.engine import MicroNN
from repro_torch.testing import compare_topk, score_tol

DIM = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clustered(n, seed, dim=DIM):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, dim)).astype(np.float32) * 5.0
    return (centers[rng.integers(0, 20, n)]
            + rng.normal(size=(n, dim))).astype(np.float32)


def _mk_engine(tmp_path, name, paged=False, n=900, seed=3, quant=None):
    X = clustered(n, seed)
    eng = MicroNN(dim=DIM, path=str(tmp_path / f"{name}.db"),
                  config=IVFConfig(dim=DIM, target_partition_size=50,
                                   kmeans_iters=10, delta_capacity=64,
                                   quantize=quant),
                  device="cpu", memory_budget_mb=0.05 if paged else None)
    eng.upsert(np.arange(n), X)
    eng.build()
    return eng, X


def _bitwise(a, b):
    np.testing.assert_array_equal(a.to_numpy()[0], b.to_numpy()[0])
    np.testing.assert_array_equal(a.to_numpy()[1], b.to_numpy()[1])


def _close(ref_ids, ref_scores, got, q, X):
    v2 = float(np.sum(X * X, -1).max())
    err, ok, bad = compare_topk(np.asarray(ref_scores), np.asarray(ref_ids),
                                got.to_numpy()[1], got.to_numpy()[0],
                                score_tol(np.atleast_2d(q), v2))
    assert ok, f"{bad} rows differ (max score err {err:.3e})"


# -- coalescing: bit-parity + one fused call per batch ----------------------


@pytest.mark.parametrize("tier", ["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_coalesced_bit_parity_vs_solo(tmp_path, paged, tier):
    eng, X = _mk_engine(tmp_path, f"par-{tier}", paged=paged,
                        quant="int8" if tier == "int8" else None)
    spec = Q.knn(k=10, n_probe=6)
    queries = X[:7] + 0.01   # 7 single-row callers -> one fused Q=7 call
    solo = [eng.query(queries[i], spec) for i in range(len(queries))]
    with FrontDoor(eng, window_s=30.0, max_batch_rows=len(queries)) as fd:
        futs = [fd.submit(queries[i], spec) for i in range(len(queries))]
        outs = [f.result(60) for f in futs]
        st = fd.stats()
    assert st["completed"] == len(queries)
    assert st["batches"] == 1 and st["coalesced"] == len(queries)
    for q, rs, ref in zip(queries, outs, solo):
        if paged and tier == "f32":
            ri, rsc = ref.to_numpy()
            _close(ri, rsc, rs, q, X)
        else:
            _bitwise(rs, ref)
    eng.close()


@pytest.fixture(scope="module", params=["none", "int8"])
def jax_db(request, tmp_path_factory):
    tier = request.param
    X = clustered(900, seed=3)
    kw = dict(dim=DIM, target_partition_size=50, kmeans_iters=10,
              delta_capacity=64, quantize=tier, rerank_factor=4)
    path = str(tmp_path_factory.mktemp("fd") / f"{tier}.db")
    jeng = JMicroNN(dim=DIM, path=path, config=JConfig(**kw))
    jeng.upsert(np.arange(900), X)
    jeng.build()
    jeng.store.db.commit()
    jeng.store.close()
    return path, kw, X


@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_frontdoor_matches_jax_frontdoor(jax_db, paged):
    path, kw, X = jax_db
    budget = 0.05 if paged else None
    shutil.copy(path, path + f".j{paged}")
    shutil.copy(path, path + f".t{paged}")
    jeng = JMicroNN(dim=DIM, path=path + f".j{paged}", config=JConfig(**kw),
                    memory_budget_mb=budget)
    jeng.recover()
    teng = MicroNN(dim=DIM, path=path + f".t{paged}", config=IVFConfig(**kw),
                   device="cpu", memory_budget_mb=budget)
    teng.recover()
    queries = X[200:212] + 0.01
    outs = {}
    for name, fd_cls, eng, spec in (
            ("jax", JFrontDoor, jeng, JQ.knn(k=10, n_probe=6)),
            ("port", FrontDoor, teng, Q.knn(k=10, n_probe=6))):
        with fd_cls(eng, window_s=30.0, max_batch_rows=len(queries)) as fd:
            futs = [fd.submit(q, spec) for q in queries]
            outs[name] = [f.result(60) for f in futs]
            assert fd.stats()["batches"] == 1
    for q, j, t in zip(queries, outs["jax"], outs["port"]):
        _close(np.asarray(j.ids), np.asarray(j.scores), t, q, X)
    jeng.store.close()
    teng.close()


def test_one_fused_call_is_one_run_count_step(tmp_path):
    """The port's counterpart of "equal specs compile once per bucket":
    six coalesced callers are one run_count() step, and a second identical
    wave is one more."""
    eng, X = _mk_engine(tmp_path, "runs")
    spec = QuerySpec(k=9, n_probe=7)
    with FrontDoor(eng, window_s=30.0, max_batch_rows=6) as fd:
        before = executor.run_count()
        futs = [fd.submit(X[i], spec) for i in range(6)]
        [f.result(60) for f in futs]
        st = fd.stats()
        assert st["batches"] == 1 and st["coalesced"] == 6, st
        assert executor.run_count() == before + 1
        futs = [fd.submit(X[6 + i], spec) for i in range(6)]
        [f.result(60) for f in futs]
        assert executor.run_count() == before + 2
    eng.close()


def test_distinct_specs_split_into_separate_calls(tmp_path):
    eng, X = _mk_engine(tmp_path, "groups")
    s1, s2 = Q.knn(k=5, n_probe=4), Q.knn(k=3, n_probe=4)
    with FrontDoor(eng, window_s=30.0, max_batch_rows=6) as fd:
        r0 = executor.run_count()
        futs = [fd.submit(X[i], s1 if i % 2 else s2) for i in range(6)]
        outs = [f.result(60) for f in futs]
        assert executor.run_count() == r0 + 2
        assert fd.stats()["batches"] == 2
    for i, rs in enumerate(outs):
        assert rs.to_numpy()[0].shape == (1, 5 if i % 2 else 3)
    eng.close()


def test_window_zero_disables_coalescing(tmp_path):
    eng, X = _mk_engine(tmp_path, "nowin")
    with FrontDoor(eng, window_s=0.0, max_batch_rows=1) as fd:
        futs = [fd.submit(X[i], Q.knn(k=5)) for i in range(5)]
        [f.result(60) for f in futs]
        fd.drain()
        st = fd.stats()
    assert st["batches"] == 0 and st["coalesced"] == 0
    assert st["solo"] == 5 and st["completed"] == 5
    eng.close()


def test_max_batch_rows_caps_fused_calls(tmp_path):
    eng, X = _mk_engine(tmp_path, "cap")
    spec = Q.knn(k=4, n_probe=4)
    with FrontDoor(eng, window_s=30.0, max_batch_rows=4) as fd:
        futs = [fd.submit(X[i], spec) for i in range(10)]
        outs = [f.result(60) for f in futs]
        st = fd.stats()
    assert st["completed"] == 10
    assert st["batches"] >= 2, "10 rows over a 4-row cap must split"
    for i, rs in enumerate(outs):
        np.testing.assert_array_equal(rs.to_numpy()[0],
                                      eng.query(X[i], spec).to_numpy()[0])
    eng.close()


# -- interleave stress: queries + session upserts + daemon maintenance -------


def _stress(tmp_path, paged):
    """A writer's sessions, three readers and the maintenance daemon on
    one engine, then the same writes on a single-threaded twin. The
    outcome checked -- the durable row set, exact answers, front door ==
    direct query after quiescing -- does not depend on how the threads
    interleave."""
    n0, extra, batches = 600, 40, 4
    eng, X = _mk_engine(tmp_path, f"stress-{int(paged)}", paged=paged,
                        n=n0, seed=13)
    new = clustered(batches * extra, seed=14)
    errors = []
    with FrontDoor(eng, window_s=0.002, maintenance=True) as fd:
        def writer():
            try:
                for b in range(batches):
                    lo = b * extra
                    with eng.session() as s:
                        s.upsert(np.arange(n0 + lo, n0 + lo + extra),
                                 new[lo:lo + extra])
                        if b % 2:
                            s.upsert(np.arange(5), new[lo:lo + 5])
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        def reader(seed):
            rng = np.random.default_rng(seed)
            try:
                for _ in range(8):
                    q = rng.normal(size=(DIM,)).astype(np.float32)
                    rs = fd.query(q, Q.knn(k=5, n_probe=4), timeout=60)
                    assert rs.to_numpy()[0].shape == (1, 5)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=writer)] + \
            [threading.Thread(target=reader, args=(100 + i,))
             for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors
        fd.drain(60)
        assert eng.scheduler.daemon_alive
        eng.maintain(until_idle=True)
        probe = X[:6] + 0.02
        spec = Q.knn(k=8, n_probe=6)
        _bitwise(fd.query(probe, spec, timeout=60), eng.query(probe, spec))
    twin, _ = _mk_engine(tmp_path, f"twin-{int(paged)}", paged=paged,
                         n=n0, seed=13)
    for b in range(batches):
        lo = b * extra
        with twin.session() as s:
            s.upsert(np.arange(n0 + lo, n0 + lo + extra), new[lo:lo + extra])
            if b % 2:
                s.upsert(np.arange(5), new[lo:lo + 5])
    twin.maintain(until_idle=True)
    ids_a, _, vecs_a = eng.store.all_rows()
    ids_b, _, vecs_b = twin.store.all_rows()
    oa, ob = np.argsort(ids_a), np.argsort(ids_b)
    np.testing.assert_array_equal(ids_a[oa], ids_b[ob])
    np.testing.assert_array_equal(vecs_a[oa], vecs_b[ob])
    ra = eng.query(X[:4], Q.exact(k=5)).to_numpy()
    rb = twin.query(X[:4], Q.exact(k=5)).to_numpy()
    np.testing.assert_array_equal(np.sort(ra[0], 1), np.sort(rb[0], 1))
    np.testing.assert_array_equal(np.sort(ra[1], 1), np.sort(rb[1], 1))
    assert not eng.scheduler.daemon_alive, "close() must stop the daemon"
    assert eng.scheduler.daemon_errors == 0, eng.scheduler.last_daemon_error
    eng.close()
    twin.close()


def test_interleave_stress_resident(tmp_path):
    _stress(tmp_path, paged=False)


def test_interleave_stress_paged(tmp_path):
    _stress(tmp_path, paged=True)


# -- daemonized maintenance ---------------------------------------------------


def test_daemon_drains_maintenance_queue(tmp_path):
    eng, X = _mk_engine(tmp_path, "daemon", n=500, seed=21)
    eng.upsert(np.arange(500, 560), clustered(60, seed=22))
    with FrontDoor(eng, maintenance=True, daemon_interval_s=0.001) as fd:
        assert eng.scheduler.daemon_alive
        t0 = time.monotonic()
        while eng.scheduler.queue_depth() > 0:
            assert time.monotonic() - t0 < 60.0, \
                eng.stats()["scheduler_depth"]
            eng.scheduler.kick()
            time.sleep(0.005)
        assert eng.scheduler.daemon_steps >= 1
        assert eng.scheduler.daemon_errors == 0
        rs = fd.query(X[0], Q.knn(k=5), timeout=60)
        assert rs.to_numpy()[0].shape == (1, 5)
    assert not eng.scheduler.daemon_alive
    eng.close()


# -- uniform observability ----------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_stats_uniform_frontdoor_keys(tmp_path, paged):
    eng, X = _mk_engine(tmp_path, f"stats-{int(paged)}", paged=paged,
                        n=400, seed=31)
    s = eng.stats()
    for key in ("scheduler_depth", "daemon_alive", "daemon_steps",
                "frontdoor", "run_count", "kernel_loads"):
        assert key in s, key
    assert s["frontdoor"] == empty_stats()
    with FrontDoor(eng, window_s=30.0, max_batch_rows=4,
                   maintenance=True) as fd:
        futs = [fd.submit(X[i], Q.knn(k=3)) for i in range(4)]
        [f.result(60) for f in futs]
        fd.drain()
        live = eng.stats()
        assert live["daemon_alive"]
        fs = live["frontdoor"]
        assert sorted(fs) == sorted(empty_stats())
        assert fs["submitted"] == 4 and fs["completed"] == 4
        assert fs["total_p50_ms"] > 0 and fs["queue_wait_p99_ms"] >= 0
    assert eng.stats()["frontdoor"] == empty_stats()
    eng.close()


def test_close_is_idempotent_and_rejects_new_work(tmp_path):
    eng, X = _mk_engine(tmp_path, "close", n=300, seed=41)
    fd = FrontDoor(eng)
    fd.query(X[0], Q.knn(k=3), timeout=60)
    fd.close()
    fd.close()
    with pytest.raises(RuntimeError, match="closed"):
        fd.submit(X[0], Q.knn(k=3))
    eng.close()


# -- async surface + adaptive coalescing window -------------------------------


def test_async_submit_bit_parity_and_coalescing(tmp_path):
    eng, X = _mk_engine(tmp_path, "async", n=400, seed=51)
    spec = Q.knn(k=5, n_probe=6)
    queries = X[:8] + 0.01
    solo = [eng.query(queries[i], spec) for i in range(len(queries))]

    async def run(fd):
        return await asyncio.gather(*[fd.submit_async(queries[i], spec)
                                      for i in range(len(queries))])

    with FrontDoor(eng, window_s=30.0, max_batch_rows=8) as fd:
        outs = asyncio.run(run(fd))
        st = fd.stats()
        assert st["batches"] == 1 and st["coalesced"] == 8
    with FrontDoor(eng, window_s=0.0) as fd:
        one = asyncio.run(fd.query_async(queries[0], spec))
    for rs, ref in zip(outs, solo):
        _bitwise(rs, ref)
    _bitwise(one, solo[0])
    eng.close()


def test_adaptive_window_tracks_arrival_rate(tmp_path):
    eng, X = _mk_engine(tmp_path, "adaptive", n=400, seed=52)
    spec = Q.knn(k=5)
    with FrontDoor(eng, window_s=0.25, adaptive_window=True,
                   coalesce_target=4) as fd:
        futs = [fd.submit(X[i], spec) for i in range(16)]
        [f.result(60) for f in futs]
        st = fd.stats()
        assert st["completed"] == 16
        assert st["arrival_ewma_ms"] >= 0.0
        assert 0.0 <= st["window_ms"] <= 250.0
        assert st["window_ms"] < 125.0
        assert 0.0 <= fd._effective_window() <= 0.25
    with FrontDoor(eng, window_s=0.05) as fd:
        fd.query(X[0], spec, timeout=60)
        assert fd.stats()["window_ms"] == pytest.approx(50.0)
    eng.close()


def test_stats_include_window_keys(tmp_path):
    es = empty_stats()
    assert "window_ms" in es and "arrival_ewma_ms" in es
    eng, X = _mk_engine(tmp_path, "wkeys", n=300, seed=53)
    with FrontDoor(eng) as fd:
        fd.query(X[0], Q.knn(k=3), timeout=60)
        assert sorted(fd.stats()) == sorted(es)
    eng.close()
