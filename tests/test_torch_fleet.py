"""The port's fleet (repro_torch.fleet): many tenants, one FramePool, one
budget, one maintenance daemon -- every case of tests/test_fleet.py against
the port, then the port's Fleet against the JAX package's Fleet on copies
of one root.

  * tenant isolation: a tenant's answers through the shared pool equal a
    solo paged engine's on a copy of its durable state (int8 bit for bit;
    f32 ids exactly and scores within 1e-5 * (||q||^2 + max ||v||^2): on
    the CPU the f32 frame scan is a library product that rounds by the
    chunk's shape, and the two pools chunk by different capacities);
  * the fleet-wide byte budget holds under a randomized multi-tenant
    workload; global CLOCK keeps a hot tenant resident; invalidation is
    scoped to its tenant;
  * no jit in the port: a query on a twin tenant is one fused call
    (`executor.run_count()`) and loads no kernel library;
  * deficit round robin steps every backlogged tenant within one round,
    and the daemon drains them all; spill and reopen recover an
    equivalent engine with cumulative counters;
  * against the JAX Fleet: equal ids per tenant query, equal recover()
    drift and tenants(), equal steps per step_round for the same backlog,
    health() and stats() with the reference's keys, and a JAX capture
    replayed through the port's fleet.
"""
import dataclasses
import os
import shutil
import time

import numpy as np
import pytest
import torch

from repro.core.query import Q as JQ
from repro.core.types import IVFConfig as JConfig
from repro.fleet import Fleet as JFleet
from repro.obs import recorder as jrecorder
from repro_torch import fleet as fleet_pkg
from repro_torch.core import executor
from repro_torch.core.query import Q
from repro_torch.core.types import IVFConfig
from repro_torch.fleet import Fleet, FramePool, TenantSLO
from repro_torch.fleet.pool import compute_frame_bytes
from repro_torch.kernels import build
from repro_torch.obs import recorder as obs_recorder
from repro_torch.storage.engine import MicroNN
from repro_torch.storage.pager import PartitionCache
from repro_torch.storage.store import VectorStore
from repro_torch.testing import compare_topk, score_tol
from tests.conftest import clustered_data

DIM = 16
CFG = dict(dim=DIM, target_partition_size=50, kmeans_iters=10,
           delta_capacity=64)
# fleet budgets (MiB) that seat fewer frames than one tenant's partitions
# (int8 frames are ~4x smaller)
BUDGET = {"none": 0.04, "int8": 0.012}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build_tenant(fleet, name, seed, n=600):
    X = clustered_data(n=n, dim=DIM, seed=seed)
    eng = fleet.get(name)
    eng.upsert(np.arange(n), X)
    eng.build()
    # fold the WAL into the main db file so a copy captures it all
    eng.store.db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
    return X


def _same(a, b, tier, q, X):
    """Fleet answer a == solo answer b: int8 bit for bit; f32 ids exactly,
    scores within the scaled tolerance (module docstring)."""
    (ai, as_), (bi, bs) = a.to_numpy(), b.to_numpy()
    np.testing.assert_array_equal(ai, bi)
    if tier == "int8":
        np.testing.assert_array_equal(as_, bs)
    else:
        tol = score_tol(q, float(np.sum(X * X, -1).max()))
        assert (np.abs(as_ - bs) <= tol).all()


@pytest.fixture(scope="module", params=["none", "int8"])
def fleet_root(request, tmp_path_factory):
    """One fleet, three distinct tenants, a budget far below the sum of
    their scan tiers -- plus a byte-identical twin of t0 (an orphan file
    the fleet adopts on access)."""
    tier = request.param
    root = str(tmp_path_factory.mktemp(f"fleet-{tier}"))
    fleet = Fleet(root, dim=DIM, budget_mb=BUDGET[tier], max_live=8,
                  config=IVFConfig(quantize=tier, **CFG), device="cpu")
    data = {n: _build_tenant(fleet, n, seed)
            for seed, n in enumerate(("t0", "t1", "t2"))}
    shutil.copy(os.path.join(root, "t0.db"), os.path.join(root, "twin.db"))
    yield fleet, root, data, tier
    fleet.close()


def test_tenant_isolation_vs_solo(fleet_root, tmp_path):
    """Every tenant's fleet answers equal a solo paged engine's on a copy
    of its durable state while all three interleave on ONE pool tight
    enough to force cross-tenant eviction."""
    fleet, root, data, tier = fleet_root
    # the shared pool seats fewer frames than ONE tenant's partitions
    assert fleet.pool.capacity < fleet.get("t0").index.k
    spec = Q.knn(k=10, n_probe=8)
    solo_rs = {}
    for name, X in data.items():
        dst = str(tmp_path / f"{name}.db")
        shutil.copy(os.path.join(root, f"{name}.db"), dst)
        solo = MicroNN(dim=DIM, path=dst,
                       config=IVFConfig(quantize=tier, **CFG),
                       memory_budget_mb=BUDGET[tier], device="cpu")
        solo.recover()
        solo_rs[name] = solo.query(X[:8], spec)
        solo.close()
    misses0 = sum(fleet.get(n).index.cache.misses for n in data)
    for _ in range(2):          # interleave so the frames compete
        for name, X in data.items():
            _same(fleet.get(name).query(X[:8], spec), solo_rs[name], tier,
                  X[:8], X)
    assert sum(fleet.get(n).index.cache.misses for n in data) > misses0


def test_shared_pool_budget_and_eviction_pressure(fleet_root):
    fleet, _, data, _ = fleet_root
    budget = fleet.pool.budget_bytes
    rng = np.random.default_rng(0)
    for _ in range(12):
        name = ("t0", "t1", "t2")[rng.integers(0, 3)]
        X = data[name]
        fleet.get(name).search(X[rng.integers(0, len(X), 4)], k=5,
                               n_probe=8)
        assert fleet.pool.resident_bytes <= budget
    s = fleet.stats()
    assert s["resident_bytes"] <= s["budget_bytes"]
    pool_stats = s["pool"]
    assert pool_stats["resident_partitions"] <= fleet.pool.capacity
    assert sum(t["resident_frames"]
               for t in pool_stats["tenants"].values()) \
        == pool_stats["resident_partitions"]


def test_one_fused_call_per_query_across_tenants(fleet_root):
    """The port has no jit: a twin tenant with byte-identical durable state
    answers in ONE fused scan call (run_count) and loads no kernel library
    (kernel_loads), and answers like t0."""
    fleet, _, data, _ = fleet_root
    q = data["t0"][:8]
    spec = Q.knn(k=10).probe(8)
    fleet.get("t0").query(q, spec)
    fleet.get("t0").query(q, spec)
    twin = fleet.get("twin")                     # adopts the orphan file
    r0, l0 = executor.run_count(), build.load_count()
    r_twin = twin.query(q, spec)
    assert executor.run_count() == r0 + 1
    assert build.load_count() == l0
    assert twin.stats()["kernel_loads"] == l0
    r_t0 = fleet.get("t0").query(q, spec)
    np.testing.assert_array_equal(r_twin.to_numpy()[0], r_t0.to_numpy()[0])


# -- raw pool-level contracts (no engines) -----------------------------------


def _mk_store(tmp_path, name, n=160, d=8, k=16, seed=0, id_base=0):
    rng = np.random.default_rng(seed)
    st = VectorStore(str(tmp_path / name), dim=d, n_attr=0)
    X = rng.normal(size=(n, d)).astype(np.float32)
    st.upsert(list(range(id_base, id_base + n)), X)
    assign = rng.integers(0, k, n)
    st.set_partitions(np.arange(id_base, id_base + n), assign,
                      rng.normal(size=(k, d)).astype(np.float32),
                      np.zeros(k))
    return st, int(np.bincount(assign, minlength=k).max())


def _mk_views(tmp_path, n_frames, names=("a", "b"), k=16):
    p_max = 0
    stores = {}
    for i, name in enumerate(names):
        st, pm = _mk_store(tmp_path, f"{name}.db", seed=i, k=k,
                           id_base=10_000 * i)
        stores[name] = st
        p_max = max(p_max, pm)
    fb = compute_frame_bytes(p_max, 8)
    pool = FramePool(dim=8, p_max=p_max, budget_bytes=n_frames * fb,
                     device="cpu")
    views = {name: PartitionCache(st, p_max=p_max, budget_bytes=0,
                                  pool=pool, tenant=name)
             for name, st in stores.items()}
    return pool, views, stores


def test_randomized_multitenant_faults_hold_budget_and_isolation(tmp_path):
    pool, views, _ = _mk_views(tmp_path, n_frames=6, names=("a", "b", "c"))
    budget = pool.budget_bytes
    rng = np.random.default_rng(1)
    names = list(views)
    for _ in range(60):
        name = names[rng.integers(0, 3)]
        cache = views[name]
        pids = rng.choice(16, size=rng.integers(1, 4), replace=False)
        f = cache.fault(list(pids))
        assert pool.resident_bytes <= budget
        assert len(pool._key_frame) <= pool.capacity
        assert pool.pinned_count(cache._tid) == len(pids)
        # isolation: the frames just pinned hold THIS tenant's rows
        lo = 10_000 * names.index(name)
        ids = cache.ids_pool.numpy()[np.asarray(f)]
        live = ids[ids >= 0]
        assert ((live >= lo) & (live < lo + 10_000)).all()
        cache.unpin(f)
        assert pool.pinned_count(cache._tid) == 0
    assert (pool._pins == 0).all()
    for name, cache in views.items():
        assert pool.resident_count(cache._tid) == len(cache._pid_frame)
    assert sum(pool.resident_count(v._tid) for v in views.values()) \
        == len(pool._key_frame)


def test_hot_tenant_stays_resident_under_cold_stream(tmp_path):
    """Global CLOCK fairness: tenant a's re-referenced working set keeps
    its reference bits fresh, so tenant b's cold stream recycles b's own
    cold frames instead of flushing a."""
    pool, views, _ = _mk_views(tmp_path, n_frames=8)
    a, b = views["a"], views["b"]
    hot = [0, 1, 2, 3, 4]
    a.unpin(a.fault(hot))
    for i in range(5):                  # ride out the first sweep
        b.unpin(b.fault([i % 16]))
        a.unpin(a.fault(hot))
    warm_misses = a.misses
    for i in range(5, 30):
        b.unpin(b.fault([i % 16]))
        a.unpin(a.fault(hot))
    assert a.misses == warm_misses, \
        "cold tenant's stream evicted the hot tenant's working set"
    assert pool.resident_count(a._tid) == len(hot)
    assert b.misses > b.hits
    top = pool.top_evictors(1)
    assert top[0]["evictor"] == "b" and top[0]["evictions"] > 0


def test_tenant_invalidation_is_scoped(tmp_path):
    """One tenant's write invalidation must not drop a co-tenant's frame
    for the same partition id."""
    pool, views, _ = _mk_views(tmp_path, n_frames=8)
    a, b = views["a"], views["b"]
    a.unpin(a.fault([3]))
    b.unpin(b.fault([3]))
    a.invalidate([3])
    assert 3 not in a._pid_frame
    assert 3 in b._pid_frame
    b.stage([5])
    b.invalidate_all()
    assert not b._pid_frame and not b._staged
    assert pool.resident_count(b._tid) == 0
    pool.invalidate_tenant(a._tid)          # idempotent on an empty tenant
    assert pool.resident_count(a._tid) == 0


# -- fleet scheduler + spill/reopen ------------------------------------------


def _fleet_with_backlog(root, names, n=400, fleet_cls=Fleet, cfg_cls=IVFConfig,
                        **kw):
    fleet = fleet_cls(str(root), dim=DIM, budget_mb=0.05, max_live=8,
                      config=cfg_cls(**CFG), max_rows_per_step=256, **kw)
    rng = np.random.default_rng(7)
    for name in names:
        X = clustered_data(n=n, dim=DIM, seed=3)
        eng = fleet.get(name)
        eng.upsert(np.arange(n), X)
        eng.build()
        # overflow the delta threshold: flush work lands in the queue
        extra = rng.normal(size=(64, DIM)).astype(np.float32)
        eng.upsert(np.arange(9000, 9064), extra)
    return fleet


def test_deficit_round_robin_serves_every_backlogged_tenant(tmp_path):
    fleet = _fleet_with_backlog(tmp_path / "fl", ("churn", "steady"),
                                device="cpu")
    churn, steady = fleet.get("churn"), fleet.get("steady")
    assert churn.stats()["scheduler_depth"] > 0
    assert steady.stats()["scheduler_depth"] > 0
    fleet.scheduler.step_round()
    # ONE round: both tenants stepped (the starvation bound)
    assert churn.scheduler.daemon_steps >= 1
    assert steady.scheduler.daemon_steps >= 1
    rng = np.random.default_rng(8)
    for r in range(10):
        churn.upsert(np.arange(9500 + 64 * r, 9564 + 64 * r),
                     rng.normal(size=(64, DIM)).astype(np.float32))
        fleet.scheduler.step_round()
        if steady.stats()["scheduler_depth"] == 0:
            break
    assert steady.stats()["scheduler_depth"] == 0, \
        "churning tenant starved its neighbour's maintenance"
    fleet.close()


def test_fleet_daemon_drains_all_tenants(tmp_path):
    fleet = _fleet_with_backlog(tmp_path / "fl", ("x", "y"), device="cpu")
    fleet.start_maintenance()
    try:
        t0 = time.monotonic()
        while any(fleet.get(n).stats()["scheduler_depth"] > 0
                  for n in ("x", "y")):
            assert time.monotonic() - t0 < 30.0
            time.sleep(0.01)
        assert fleet.stats()["daemon_alive"]
    finally:
        fleet.stop_maintenance()
    assert not fleet.stats()["daemon_alive"]
    for n in ("x", "y"):
        eng = fleet.get(n)
        assert int(eng.index.delta.count) == 0
        assert eng.scheduler.daemon_steps >= 1
    fleet.close()


def test_spill_reopen_round_trip(tmp_path):
    """max_live=1: opening tenant b spills tenant a (store closed, frames
    dropped); re-opening a recovers an equivalent engine with cumulative
    per-tenant counters and latency series."""
    fleet = Fleet(str(tmp_path / "fl"), dim=DIM, budget_mb=0.05,
                  max_live=1, config=IVFConfig(**CFG), device="cpu")
    Xa = _build_tenant(fleet, "a", seed=0, n=400)
    q = Xa[:4]
    before = fleet.query("a", q, Q.knn(k=5).probe(6))
    hits_before = fleet.get("a").index.cache.hits
    queries_before = fleet._tenant_health("a")["queries"]
    a_ref = fleet.get("a")
    _build_tenant(fleet, "b", seed=1, n=400)    # evicts a (max_live=1)
    assert fleet.live_tenants() == ["b"]
    assert a_ref.index is None and a_ref._spilled
    assert fleet.stats()["pool"]["tenants"]["a"]["resident_frames"] == 0
    again = fleet.query("a", q, Q.knn(k=5).probe(6))    # lazy reopen
    np.testing.assert_array_equal(before.to_numpy()[0], again.to_numpy()[0])
    np.testing.assert_array_equal(before.to_numpy()[1], again.to_numpy()[1])
    assert fleet.get("a") is not a_ref
    assert fleet.get("a").index.cache.hits >= hits_before
    assert fleet._tenant_health("a")["queries"] == queries_before + 1
    assert fleet.stats()["tenant_spills"] >= 2
    fleet.close()


# -- the port's own contracts ------------------------------------------------


def test_fleet_refusals_raise_valueerror(tmp_path):
    root = str(tmp_path / "fl")
    with pytest.raises(ValueError, match="budget_mb"):
        Fleet(root, dim=DIM, budget_mb=0, device="cpu")
    with pytest.raises(ValueError, match="max_live"):
        Fleet(root, dim=DIM, max_live=0, device="cpu")
    with pytest.raises(ValueError, match="p99_ms"):
        TenantSLO(p99_ms=0.0)
    with pytest.raises(ValueError, match="target"):
        TenantSLO(target=1.0)
    fleet = Fleet(root, dim=DIM, budget_mb=0.05, device="cpu")
    for bad in ("", "_manifest", "a/b", "../x", ".hidden"):
        with pytest.raises(ValueError, match="tenant name"):
            fleet.get(bad)
    assert fleet.tenants() == []        # a refused name registers nothing
    with pytest.raises(ValueError, match="p99_ms"):
        fleet.set_slo("a", p99_ms=-1.0)
    fleet.close()
    fleet.close()                       # idempotent
    with pytest.raises(ValueError, match="closed"):
        fleet.get("a")
    with pytest.raises(ValueError, match="closed"):
        fleet.tenants()


def test_fleet_default_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Fleet(str(tmp_path / "fl"), dim=DIM)
    fleet = Fleet(str(tmp_path / "fl"), dim=DIM, device="cpu")
    assert fleet.device.type == "cpu" and fleet.pool.device.type == "cpu"
    assert fleet.get("a").device.type == "cpu"
    fleet.close()


def test_fleet_exports_are_lazy():
    assert fleet_pkg.Fleet is Fleet and "Fleet" in dir(fleet_pkg)
    assert fleet_pkg.TenantSLO is TenantSLO
    assert fleet_pkg.FleetScheduler.__name__ == "FleetScheduler"
    with pytest.raises(AttributeError):
        fleet_pkg.NoSuchThing


def test_pool_starts_at_pad_to_and_grows_on_register(tmp_path):
    fleet = Fleet(str(tmp_path / "fl"), dim=DIM, budget_mb=0.5,
                  config=IVFConfig(quantize="int8", **CFG), device="cpu")
    assert fleet.pool.p_max == fleet.config.pad_to
    _build_tenant(fleet, "a", seed=0, n=400)
    eng = fleet.get("a")
    assert fleet.pool.p_max >= int(eng.index.counts.max())
    assert fleet.pool.p_max % fleet.config.pad_to == 0
    fleet.close()


# -- against the JAX package's Fleet on copies of one root --------------------


def _jfleet(root, **kw):
    return JFleet(str(root), dim=DIM, budget_mb=0.04, max_live=8,
                  config=JConfig(**CFG), **kw)


def _pfleet(root, **kw):
    return Fleet(str(root), dim=DIM, budget_mb=0.04, max_live=8,
                 config=IVFConfig(**CFG), device="cpu", **kw)


@pytest.fixture(scope="module")
def twin_roots(tmp_path_factory):
    """Three tenants built by the JAX Fleet, a stray db file (orphan) and a
    registered tenant whose files vanished (missing); then the root copied
    byte for byte, so each package opens its own copy."""
    base = tmp_path_factory.mktemp("parity")
    jf = _jfleet(base / "jax")
    data = {n: _build_tenant(jf, n, seed)
            for seed, n in enumerate(("p0", "p1", "p2"))}
    _build_tenant(jf, "gone", 9, n=200)
    jf.close()
    for suffix in ("", "-wal", "-shm"):
        try:
            os.remove(base / "jax" / f"gone.db{suffix}")
        except FileNotFoundError:
            pass
    shutil.copy(base / "jax" / "p0.db", base / "jax" / "stray.db")
    shutil.copytree(base / "jax", base / "port")
    return base, data


def test_parity_ids_per_tenant_query(twin_roots):
    base, data = twin_roots
    jf, pf = _jfleet(base / "jax"), _pfleet(base / "port")
    try:
        for name, X in data.items():
            for i in range(0, 16, 4):
                q = X[i:i + 4] + 0.01
                jr = jf.query(name, q, JQ.knn(k=10, n_probe=8))
                pr = pf.query(name, q, Q.knn(k=10, n_probe=8))
                err, ok, bad = compare_topk(
                    np.asarray(jr.scores), np.asarray(jr.ids),
                    pr.to_numpy()[1], pr.to_numpy()[0],
                    score_tol(q, float(np.sum(X * X, -1).max())))
                assert ok, f"{name}: {bad} rows differ ({err:.3e})"
    finally:
        jf.close()
        pf.close()


def test_parity_recover_drift_and_tenants(twin_roots):
    base, _ = twin_roots
    jf, pf = _jfleet(base / "jax"), _pfleet(base / "port")
    try:
        jd, pd = jf.recover(), pf.recover()
        assert pd == jd == {"orphans": ["stray"], "missing": ["gone"]}
        assert pf.tenants() == jf.tenants() == ["gone", "p0", "p1", "p2"]
        assert pf.health()["manifest"] == jf.health()["manifest"]
    finally:
        jf.close()
        pf.close()


def _keys(d):
    """A dict's key tree (dicts of tenants or pairs reduced to one entry)."""
    return {k: (_keys(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


def test_parity_health_and_stats_keys(twin_roots):
    base, data = twin_roots
    jf, pf = _jfleet(base / "jax"), _pfleet(base / "port")
    try:
        # the latency series are per tenant name and process-wide
        n0 = [f._tenant_health("p0")["queries"] for f in (jf, pf)]
        for f, spec in ((jf, JQ.knn(k=4, n_probe=8)),
                        (pf, Q.knn(k=4, n_probe=8))):
            for name, X in data.items():
                f.query(name, X[:2], spec)
            # generous objectives (the JAX side's first query compiles),
            # and an absurd one that every query violates
            for name in ("p0", "p2"):
                f.set_slo(name, p99_ms=600_000.0, target=0.5)
            f.set_slo("p1", p99_ms=1e-6)
        jh, ph = jf.health(), pf.health()
        assert set(ph) == set(jh)
        assert _keys(ph["pool"]) == _keys(jh["pool"])
        assert set(ph["tenants"]) == set(jh["tenants"])
        for name in jh["tenants"]:
            assert set(ph["tenants"][name]) == set(jh["tenants"][name])
        assert ph["degraded"] == jh["degraded"] == ["p1"]
        assert ph["status"] == jh["status"] == "degraded"
        assert jh["tenants"]["p0"]["queries"] - n0[0] == 1
        assert ph["tenants"]["p0"]["queries"] - n0[1] == 1
        assert [set(e) for e in ph["noisy_neighbors"]] == \
            [set(e) for e in jh["noisy_neighbors"]][:len(ph["noisy_neighbors"])]
        js, ps = jf.stats(), pf.stats()
        assert set(ps) == set(js)
        assert set(ps["pool"]) == set(js["pool"])
        assert ps["live_tenants"] == js["live_tenants"]
        assert ps["budget_bytes"] == js["budget_bytes"]
    finally:
        jf.close()
        pf.close()


def test_parity_step_counts_per_round(tmp_path):
    jroot = tmp_path / "jax"
    jf = _fleet_with_backlog(jroot, ("churn", "steady"), fleet_cls=JFleet,
                             cfg_cls=JConfig)
    jf.close()
    shutil.copytree(jroot, tmp_path / "port")
    jf = JFleet(str(jroot), dim=DIM, budget_mb=0.05, max_live=8,
                config=JConfig(**CFG), max_rows_per_step=256)
    pf = Fleet(str(tmp_path / "port"), dim=DIM, budget_mb=0.05, max_live=8,
               config=IVFConfig(**CFG), max_rows_per_step=256, device="cpu")
    try:
        for name in ("churn", "steady"):        # open in the same order
            jf.get(name)
            pf.get(name)
        rounds = []
        for _ in range(20):
            j, p = jf.scheduler.step_round(), pf.scheduler.step_round()
            rounds.append((j, p))
            if not j and not p:
                break
        assert rounds[0][0] > 0 and not rounds[-1][0]
        assert [p for _, p in rounds] == [j for j, _ in rounds], rounds
        for name in ("churn", "steady"):
            assert pf.get(name).scheduler.daemon_steps == \
                jf.get(name).scheduler.daemon_steps
    finally:
        jf.close()
        pf.close()


def test_parity_jax_capture_replays_through_port_fleet(twin_roots,
                                                       tmp_path):
    """A workload captured through the JAX Fleet (max_live=1: every touch
    of another tenant spills) replays through the port's Fleet: the same
    tenant touches drive the same opens and spills, every query self-checks
    by double execution, and each answer's ids equal the JAX answer."""
    base, data = twin_roots
    for arm in ("jax", "port"):
        shutil.copytree(base / arm, tmp_path / arm)
    jf = JFleet(str(tmp_path / "jax"), dim=DIM, budget_mb=0.04, max_live=1,
                config=JConfig(**CFG))
    cap = str(tmp_path / "cap.db")
    answers = []
    names = ("p0", "p1", "p2")
    with jrecorder.recording(cap):
        for i in range(6):
            name = names[i % 3]
            q = data[name][i:i + 2]
            answers.append(np.asarray(
                jf.query(name, q, JQ.knn(k=4, n_probe=4)).ids))
    j_spills = jf.stats()["tenant_spills"]
    jf.close()
    recs = obs_recorder.load(cap)
    sites = [r.site for r in recs]
    assert sites.count(obs_recorder.SITE_FLEET_GET) == 6
    assert sites.count(obs_recorder.SITE_ENGINE) == 6
    # a JAX spec unpickles as the JAX package's QuerySpec: restate it as
    # the port's; the digest is of JAX's float32 bits, so the port
    # self-checks instead
    port_recs = [dataclasses.replace(
        r, digest=None,
        spec=None if r.spec is None else Q.knn(k=r.spec.k,
                                               n_probe=r.spec.n_probe))
        for r in recs]
    pf = Fleet(str(tmp_path / "port"), dim=DIM, budget_mb=0.04, max_live=1,
               config=IVFConfig(**CFG), device="cpu")
    rep = obs_recorder.replay(port_recs, fleet=pf, strict=True)
    assert rep.ok and rep.events == 6 and rep.replayed == 6
    assert rep.self_checked == 6
    # every replayed query re-touched its tenant: 6 get events + 6 engine
    # records, so the port spilled at each switch of tenant, as JAX did
    assert pf.stats()["tenant_spills"] >= j_spills
    engine_recs = [r for r in port_recs if r.site == obs_recorder.SITE_ENGINE]
    for r, ids in zip(engine_recs, answers):
        got = pf.query(r.tenant, r.vecs, r.spec).to_numpy()[0]
        np.testing.assert_array_equal(got, ids)
    pf.close()
