"""The port's flight recorder, SLO health, manifest and HTTP exposition
endpoint (repro_torch.obs.recorder / .http, repro_torch.fleet.manager),
mirroring the engine-site, front-door, fleet, attribution, health,
manifest and HTTP cases of tests/test_flight.py.

  * capture -> replay is bit-exact (ids and float32 scores), resident and
    paged, and a store changed between capture and replay is caught;
  * the recorder is bounded and sampled, and drops an unpicklable spec;
  * front-door admissions (digestless) replay by double execution;
  * a multi-tenant capture through a Fleet replays with its tenant touches;
  * eviction attribution names cross-tenant pairs and stays inside the
    registry's cardinality guard;
  * Fleet.health() has the reference's schema and flips a tenant to
    "degraded" exactly when its burn rate exceeds 1; the manifest is the
    tenant directory and recover() reports orphans and missing stores;
  * /metrics, /healthz, /traces, /slow, /events answer without the engine
    write mutex, and scraping during a live workload changes no answer.
"""
import json
import os
import shutil
import sqlite3
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.obs import recorder as jrecorder
from repro_torch.core.query import Q
from repro_torch.core.types import IVFConfig
from repro_torch.fleet import Fleet, FramePool, TenantSLO
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs.http import ExpositionServer
from repro_torch.serving import FrontDoor
from repro_torch.storage.engine import MicroNN

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


def _mk(tmp_path, name, *, paged=False, n=400, seed=0, **eng_kw):
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=8,
                    delta_capacity=64)
    eng = MicroNN(dim=DIM, path=str(tmp_path / f"{name}.db"), config=cfg,
                  device="cpu", memory_budget_mb=0.05 if paged else None,
                  **eng_kw)
    X = clustered(n, seed)
    eng.upsert(np.arange(n), X)
    eng.build()
    return eng, X


def _mk_fleet(tmp_path, *, tenants=("a", "b"), n=300, budget_mb=0.5,
              **kw):
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=4)
    fleet = Fleet(str(tmp_path / "fleet"), dim=DIM, budget_mb=budget_mb,
                  config=cfg, device="cpu", **kw)
    X = clustered(n, 3)
    for t in tenants:
        eng = fleet.get(t)
        with eng.session() as s:
            s.upsert(np.arange(n), X)
        eng.build()
    return fleet, X


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


# -- capture / replay --------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_replay_bit_identical_engine(tmp_path, paged):
    eng, X = _mk(tmp_path, f"rep{paged}", paged=paged)
    cap = str(tmp_path / "cap.db")
    specs = [Q.knn(k=5, n_probe=4).backend("torch"), Q.knn(k=3, n_probe=4),
             Q.exact(k=7)]
    with obs_recorder.recording(cap) as rec:
        for i, spec in enumerate(specs):
            eng.query(X[i:i + 2], spec)
        assert rec.recorded == len(specs)
    rep = obs_recorder.replay(cap, engine=eng, strict=True)
    assert rep.ok and rep.replayed == rep.matched == len(specs)
    eng.close()


def test_capture_file_format_is_the_reference_one(tmp_path):
    """A port capture has the reference's table, columns, vector encoding
    and result digest (a pickled spec unpickles only in the package that
    wrote it)."""
    eng, X = _mk(tmp_path, "fmt")
    cap = str(tmp_path / "cap.db")
    with obs_recorder.recording(cap):
        rs = eng.query(X[:3], Q.knn(k=4, n_probe=4))
    conn = sqlite3.connect(cap)
    try:
        cols = [r[1] for r in conn.execute("PRAGMA table_info(flight)")]
        q, dim, vecs, digest = conn.execute(
            "SELECT q, dim, vecs, digest FROM flight").fetchone()
    finally:
        conn.close()
    assert cols == ["seq", "ts_offset", "tenant", "site", "spec", "vecs",
                    "q", "dim", "digest"]
    assert (q, dim) == (3, DIM)
    np.testing.assert_array_equal(
        np.frombuffer(vecs, np.float32).reshape(q, dim), X[:3])
    assert digest == obs_recorder.result_digest(rs)

    class _RS:                      # the reference digest of the same bits
        def to_numpy(self):
            return rs.to_numpy()
    assert jrecorder.result_digest(_RS()) == digest
    eng.close()


def test_replay_detects_divergence(tmp_path):
    eng, X = _mk(tmp_path, "div")
    cap = str(tmp_path / "cap.db")
    with obs_recorder.recording(cap):
        eng.query(X[:2], Q.knn(k=3, n_probe=4))
    eng.upsert(np.arange(200), X[:200] + 1.0)
    eng.maintain(force="flush")
    rep = obs_recorder.replay(cap, engine=eng)
    assert not rep.ok and rep.mismatches
    with pytest.raises(AssertionError):
        obs_recorder.replay(cap, engine=eng, strict=True)
    eng.close()


def test_replay_multi_tenant_fleet(tmp_path):
    fleet, X = _mk_fleet(tmp_path, tenants=("a", "b", "c"))
    cap = str(tmp_path / "cap.db")
    with obs_recorder.recording(cap):
        for i in range(6):
            fleet.query("abc"[i % 3], X[i:i + 2], Q.knn(k=4, n_probe=4))
    recs = obs_recorder.load(cap)
    # every engine.query capture carries its tenant and digest; the
    # fleet.get touches interleave as events
    sites = {r.site for r in recs}
    assert obs_recorder.SITE_ENGINE in sites
    assert obs_recorder.SITE_FLEET_GET in sites
    assert {r.tenant for r in recs} == {"a", "b", "c"}
    rep = obs_recorder.replay(cap, fleet=fleet, strict=True)
    assert rep.ok and rep.replayed == 6 and rep.events == 6
    fleet.close()


def test_recorder_bounded_and_sampled(tmp_path):
    eng, X = _mk(tmp_path, "bnd")
    spec = Q.knn(k=3, n_probe=4)
    cap1 = str(tmp_path / "cap1.db")
    with obs_recorder.recording(cap1, sample_every=3) as rec:
        for i in range(9):
            eng.query(X[i:i + 1], spec)
    assert rec.recorded == 3
    assert len(obs_recorder.load(cap1)) == 3
    cap2 = str(tmp_path / "cap2.db")
    with obs_recorder.recording(cap2, max_records=4) as rec:
        for i in range(10):
            eng.query(X[i:i + 1], spec)
        assert rec.stats()["full"]
    assert len(obs_recorder.load(cap2)) == 4
    assert obs_recorder.active() is None
    eng.query(X[:1], spec)
    assert len(obs_recorder.load(cap2)) == 4
    eng.close()


def test_recorder_unpicklable_spec_dropped(tmp_path):
    eng, X = _mk(tmp_path, "unp")
    cap = str(tmp_path / "cap.db")

    class Opaque:
        def __reduce__(self):
            raise TypeError("not picklable")

    with obs_recorder.recording(cap) as rec:
        rec.record(obs_recorder.SITE_ENGINE, None, X[:1], Opaque())
        eng.query(X[:1], Q.knn(k=3, n_probe=4))
        assert rec.stats()["dropped"] == 1
    recs = obs_recorder.load(cap)
    assert len(recs) == 1 and recs[0].digest is not None
    assert obs_recorder.replay(cap, engine=eng, strict=True).ok
    eng.close()


def test_frontdoor_capture_replays(tmp_path):
    eng, X = _mk(tmp_path, "fd")
    cap = str(tmp_path / "cap.db")
    spec = Q.knn(k=5, n_probe=4)
    with obs_recorder.recording(cap):
        with FrontDoor(eng, window_s=30.0, max_batch_rows=6) as fd:
            futs = [fd.submit(X[i:i + 1], spec) for i in range(6)]
            for f in futs:
                f.result(timeout=60)
    recs = obs_recorder.load(cap, sites=[obs_recorder.SITE_FRONTDOOR])
    assert len(recs) == 6 and all(r.digest is None for r in recs)
    rep = obs_recorder.replay(cap, engine=eng, strict=True)
    assert rep.ok and rep.self_checked == 6
    eng.close()


# -- noisy-neighbour attribution ----------------------------------------------


def test_eviction_matrix_attributes_cross_tenant(tmp_path):
    # a budget of ~4 frames: two tenants with disjoint hot sets must evict
    # each other, and the matrix has to say so, by name
    fleet, X = _mk_fleet(tmp_path, tenants=("alice", "bob"),
                         budget_mb=0.02)
    spec = Q.knn(k=4, n_probe=8)
    for i in range(12):
        fleet.query("alice", X[i:i + 1], spec)
        fleet.query("bob", X[i + 1:i + 2], spec)
    matrix = fleet.pool.stats()["eviction_matrix"]
    assert matrix, "no evictions recorded under a 4-frame budget"
    pairs = {(v, e) for v, row in matrix.items() for e in row}
    assert any(v != e for v, e in pairs), pairs
    total = sum(n for row in matrix.values() for n in row.values())
    top = fleet.pool.top_evictors(3)
    assert top and top[0]["evictions"] <= total
    assert set(top[0]) == {"evictor", "victim", "evictions"}
    assert [t["evictions"] for t in top] == sorted(
        (t["evictions"] for t in top), reverse=True)
    assert fleet.health()["noisy_neighbors"] == fleet.pool.top_evictors(5)
    snap = obs_metrics.default_registry().snapshot()["counters"]
    attributed = {k: v for k, v in snap.items()
                  if k.startswith("evictions_attributed")
                  and ("alice" in k or "bob" in k)}
    assert sum(attributed.values()) >= total > 0
    fleet.close()


def test_attribution_cardinality_bounded_1000_tenants():
    reg = obs_metrics.default_registry()
    evicted0 = reg.counter("obs_series_evicted").value
    pool = FramePool(dim=4, p_max=8, budget_bytes=1 << 16, device="cpu")
    with pool._lock:
        for i in range(1000):
            pool._note_eviction(i, (i + 1) % 1000)
    with reg._lock:
        n_series = len(reg._by_name.get("evictions_attributed", ()))
    assert n_series <= reg.max_series_per_name
    assert reg.counter("obs_series_evicted").value - evicted0 >= \
        1000 - reg.max_series_per_name
    st = pool.stats()
    n_pairs = sum(len(r) for r in st["eviction_matrix"].values())
    assert n_pairs + st["eviction_matrix_overflow"] == 1000
    assert n_pairs <= pool.attr_max_pairs


# -- SLO layer + health ------------------------------------------------------


def test_health_schema_and_slo_verdicts(tmp_path):
    fleet, X = _mk_fleet(tmp_path, tenants=("fast", "slow"))
    for i in range(8):
        fleet.query("fast", X[i:i + 1], Q.knn(k=3, n_probe=4))
        fleet.query("slow", X[i:i + 1], Q.knn(k=3, n_probe=4))
    # a generous objective stays inside its budget; an absurd one is
    # violated by every query -> burn >> 1 -> degraded
    fleet.set_slo("fast", p99_ms=600_000.0, target=0.5)
    fleet.set_slo("slow", p99_ms=1e-6, target=0.99)
    h = fleet.health()
    assert set(h) == {"schema", "status", "tenants", "degraded", "pool",
                      "daemon_alive", "live_tenants", "noisy_neighbors",
                      "manifest"}
    assert h["schema"] == 1
    assert set(h["pool"]) == {"budget_bytes", "resident_bytes", "pressure"}
    assert set(h["manifest"]) == {"orphans", "missing"}
    t = h["tenants"]["fast"]
    assert set(t) == {"verdict", "queries", "p99_ms", "objective_ms",
                      "target", "violation_fraction", "burn_rate"}
    assert t["verdict"] == "ok" and t["burn_rate"] <= 1.0
    assert t["queries"] >= 8
    s = h["tenants"]["slow"]
    assert s["verdict"] == "degraded" and s["burn_rate"] > 1.0
    assert "slow" in h["degraded"] and h["status"] == "degraded"
    assert 0.0 < h["pool"]["pressure"] <= 1.0
    assert h["live_tenants"] == ["fast", "slow"] and not h["daemon_alive"]
    assert json.dumps(h)
    fleet.close()


def test_slo_default_and_override(tmp_path):
    fleet, _ = _mk_fleet(tmp_path, tenants=("a",),
                         slo=TenantSLO(p99_ms=123.0, target=0.9))
    assert fleet.slo_for("a").p99_ms == 123.0
    fleet.set_slo("a", p99_ms=7.0, target=0.95)
    assert fleet.slo_for("a") == TenantSLO(p99_ms=7.0, target=0.95)
    assert fleet.slo_for("other").p99_ms == 123.0   # the default applies
    assert fleet._tenant_health("ghost")["verdict"] == "ok"   # idle
    fleet.close()


# -- manifest ----------------------------------------------------------------


def test_manifest_is_the_tenant_directory(tmp_path):
    fleet, _ = _mk_fleet(tmp_path, tenants=("a", "b"))
    assert fleet.tenants() == ["a", "b"]
    fleet.close()
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=4)
    f2 = Fleet(str(tmp_path / "fleet"), dim=DIM, budget_mb=0.5, config=cfg,
               device="cpu")
    assert f2.tenants() == ["a", "b"]
    f2.drop("a")                # one transaction + file removal
    assert f2.tenants() == ["b"]
    assert not os.path.exists(os.path.join(f2.root, "a.db"))
    f2.close()
    f3 = Fleet(str(tmp_path / "fleet"), dim=DIM, budget_mb=0.5, config=cfg,
               device="cpu")
    assert f3.tenants() == ["b"]
    f3.close()


def test_manifest_reconciles_orphans_and_missing(tmp_path):
    fleet, _ = _mk_fleet(tmp_path, tenants=("a", "b"))
    # orphan: a db file the manifest never registered (spill "a" first, so
    # the copied main file is checkpointed and self-contained)
    fleet.close(name="a")
    shutil.copy(os.path.join(fleet.root, "a.db"),
                os.path.join(fleet.root, "stray.db"))
    # missing: a registered tenant whose files vanished out of band
    fleet.close(name="b")
    for suffix in ("", "-wal", "-shm"):
        try:
            os.remove(os.path.join(fleet.root, "b.db" + suffix))
        except FileNotFoundError:
            pass
    drift = fleet.recover()
    assert drift == {"orphans": ["stray"], "missing": ["b"]}
    assert fleet.health()["manifest"] == drift
    assert "stray" not in fleet.tenants()       # the manifest is authority
    fleet.get("stray")                          # touching adopts it
    assert "stray" in fleet.tenants()
    assert fleet.recover()["orphans"] == []
    fleet.close()


# -- exposition endpoint -----------------------------------------------------


def test_http_endpoints_engine(tmp_path):
    eng, X = _mk(tmp_path, "http", paged=True)
    eng.query(X[:2], Q.knn(k=3, n_probe=4), trace=True)
    srv = ExpositionServer.for_target(eng).start()
    try:
        code, ctype, body = _get(srv.url + "/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert b"# TYPE " in body and b"# HELP " in body
        code, ctype, body = _get(srv.url + "/healthz")
        doc = json.loads(body)
        assert code == 200 and ctype.startswith("application/json")
        assert "hits" in doc and "misses" in doc
        code, _, body = _get(srv.url + "/traces")
        traces = json.loads(body)
        assert code == 200 and len(traces) == 1 and "spans" in traces[0]
        for path in ("/slow", "/events"):
            code, _, body = _get(srv.url + path)
            assert code == 200 and isinstance(json.loads(body), list)
        assert _get(srv.url + "/metrics")[2]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/nope")
        assert e.value.code == 404
    finally:
        srv.stop()
        eng.close()


def test_http_serves_while_engine_mutex_held(tmp_path):
    eng, X = _mk(tmp_path, "mutex")
    srv = ExpositionServer.for_target(eng).start()
    try:
        with eng.lock:
            for path in ("/metrics", "/healthz", "/traces"):
                assert _get(srv.url + path, timeout=10)[0] == 200
    finally:
        srv.stop()
        eng.close()


def test_http_live_workload_unperturbed(tmp_path):
    """Scrapers on every endpoint while a front door with the maintenance
    daemon serves: well-formed pages, and answers equal the quiet run's
    bit for bit. The engine-target counterpart of the reference's fleet
    case."""
    eng, X = _mk(tmp_path, "live", paged=True)
    spec = Q.knn(k=5, n_probe=4)
    quiet = [eng.query(X[i:i + 2], spec).to_numpy() for i in range(6)]
    srv = ExpositionServer.for_target(eng).start()
    stop, scraping = threading.Event(), threading.Event()
    errs = []

    def scrape():
        paths = ("/metrics", "/healthz", "/traces", "/events", "/slow")
        i = 0
        while not stop.is_set():
            try:
                code, _, body = _get(srv.url + paths[i % len(paths)])
                assert code == 200 and body
            except Exception as e:      # pragma: no cover
                errs.append(e)
                scraping.set()
                return
            scraping.set()
            i += 1

    threads = [threading.Thread(target=scrape) for _ in range(3)]
    try:
        with FrontDoor(eng, maintenance=True) as fd:
            for t in threads:
                t.start()
            assert scraping.wait(60)       # the load starts under scrapes
            live = [fd.query(X[i:i + 2], spec, timeout=60).to_numpy()
                    for i in range(6)]
            for _ in range(4):
                fd.query(X[:3], spec, timeout=60)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        srv.stop()
    assert not errs, errs
    for (qi, qs), (li, ls) in zip(quiet, live):
        np.testing.assert_array_equal(qi, li)
        np.testing.assert_array_equal(qs, ls)
    eng.close()


def test_http_healthz_serves_fleet_health(tmp_path):
    fleet, X = _mk_fleet(tmp_path, tenants=("a", "b"))
    fleet.query("a", X[:2], Q.knn(k=3, n_probe=4))
    srv = ExpositionServer.for_target(fleet).start()
    try:
        code, ctype, body = _get(srv.url + "/healthz")
        doc = json.loads(body)
        assert code == 200 and ctype.startswith("application/json")
        assert doc["schema"] == 1 and set(doc["tenants"]) == {"a", "b"}
        assert doc["tenants"]["a"]["queries"] >= 1
        code, _, body = _get(srv.url + "/metrics")
        assert code == 200 and b"tenant_opens" in body
        # a fleet has no trace ring: the ring endpoints answer empty
        assert json.loads(_get(srv.url + "/traces")[2]) == []
    finally:
        srv.stop()
        fleet.close()


def test_http_live_workload_unperturbed_fleet(tmp_path):
    """Scrapers on every endpoint during a live fleet workload (daemon on)
    get well-formed pages, and answers equal the quiet run's bit for bit."""
    fleet, X = _mk_fleet(tmp_path, tenants=("a", "b"))
    spec = Q.knn(k=5, n_probe=4)
    quiet = [fleet.query("a", X[i:i + 2], spec).to_numpy()
             for i in range(6)]
    srv = ExpositionServer.for_target(fleet).start()
    fleet.start_maintenance()
    stop, scraping = threading.Event(), threading.Event()
    errs = []

    def scrape():
        paths = ("/metrics", "/healthz", "/traces", "/events", "/slow")
        i = 0
        while not stop.is_set():
            try:
                code, _, body = _get(srv.url + paths[i % len(paths)])
                assert code == 200 and body
            except Exception as e:      # pragma: no cover
                errs.append(e)
                scraping.set()
                return
            scraping.set()
            i += 1

    threads = [threading.Thread(target=scrape) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        assert scraping.wait(60)        # the load starts under scrapes
        live = [fleet.query("a", X[i:i + 2], spec).to_numpy()
                for i in range(6)]
        for _ in range(4):
            fleet.query("b", X[:3], spec)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        fleet.stop_maintenance()
        srv.stop()
    assert not errs, errs
    for (qi, qs), (li, ls) in zip(quiet, live):
        np.testing.assert_array_equal(qi, li)
        np.testing.assert_array_equal(qs, ls)
    assert fleet.health()["schema"] == 1
    fleet.close()
