"""The port's flight recorder and HTTP exposition endpoint
(repro_torch.obs.recorder / .http), mirroring the engine-site, front-door,
attribution and HTTP cases of tests/test_flight.py (its fleet cases wait
for the port of the fleet manager).

  * capture -> replay is bit-exact (ids and float32 scores), resident and
    paged, and a store changed between capture and replay is caught;
  * the recorder is bounded and sampled, and drops an unpicklable spec;
  * front-door admissions (digestless) replay by double execution;
  * eviction attribution stays inside the registry's cardinality guard;
  * /metrics, /healthz, /traces, /slow, /events answer without the engine
    write mutex, and scraping during a live workload changes no answer.
"""
import json
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
from repro_torch.fleet.pool import FramePool
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
