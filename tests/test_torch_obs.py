"""The port's observability layer (repro_torch.obs, the engine's traces and
stats) against the JAX package's (repro.obs), mirroring tests/test_obs.py.

  * the registry: the same sequence of operations gives the same
    snapshot() and the same Prometheus text in both packages;
  * explain(): on one database, the same stage names in the same order as
    the JAX engine, and equal counters where the layout is equal
    (partitions, n_probe, k, candidates, rf, pager hits / misses); the
    counters that differ by design (`backend`, the jit keys `compiled` /
    `cache_hit`, `launches`) are listed in ROADMAP's Differences;
  * free when off: an untraced query registers no series and enters no
    ring; the kill-switch silences trace=True;
  * exact when on: the fault span equals the pager's counter deltas, the
    scan span's `compiled` / `launches` equal the kernel-load and launch
    deltas, and one query is one run_count() step;
  * where the work happens: a traced query waits for the device only at
    its trace's finish and probes once; its stages are micronn.* ranges
    under torch.profiler, traced or not; build() records its stages in
    its stage_s histograms and one "build" event;
  * the scheduler's counters and event log, the ring and slow log, the
    front door's traced submits.

All on the CPU (the kernels' plain versions); the card's side is in
chip_smoke.py.
"""
import contextlib
import gc
import json
import re
import shutil
import threading
import time
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.query import Q as JQ
from repro.core.types import IVFConfig as JConfig
from repro.obs import metrics as jmetrics
from repro.storage.engine import MicroNN as JMicroNN
from repro_torch.core import executor
from repro_torch.core.hybrid import Pred
from repro_torch.core.query import Q
from repro_torch.core.types import IVFConfig
from repro_torch.kernels import build, ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import trace as obs_trace
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


def _mk(tmp_path, name, *, paged=False, quant=False, n=400, seed=0,
        **eng_kw):
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=8,
                    delta_capacity=64,
                    **({"quantize": "int8", "rerank_factor": 4}
                       if quant else {}))
    eng = MicroNN(dim=DIM, path=str(tmp_path / f"{name}.db"), config=cfg,
                  device="cpu", memory_budget_mb=0.05 if paged else None,
                  **eng_kw)
    X = clustered(n, seed)
    eng.upsert(np.arange(n), X)
    eng.build()
    return eng, X


# -- the registry, against the JAX package's ---------------------------------


def _registry_ops(mod):
    """One sequence of registry operations; -> (snapshot, prometheus)."""
    reg = mod.MetricsRegistry(max_series_per_name=3)
    s = reg.scope(component="pager", inst="0")
    s.counter("hits").inc(3)
    s.counter("misses").inc()
    s.scope(tenant='a"b').counter("hits").inc(2)
    reg.gauge("depth").set(2.5)
    reg.gauge("live", fn=lambda: 7)
    h = reg.histogram("wait.s", component="fd")
    for v in (1e-4, 3e-4, 0.002, 0.02, 0.5, 7.0):
        h.observe(v)
    for i in range(5):                       # evicts two series
        reg.counter("chatty", rid=str(i)).inc(i)
    other = mod.Histogram("other")
    other.observe(0.003)
    h.merge(other)
    return reg.snapshot(), reg.to_prometheus()


def test_registry_snapshot_and_prometheus_equal_jax():
    snap, text = _registry_ops(obs_metrics)
    jsnap, jtext = _registry_ops(jmetrics)
    assert snap == jsnap
    assert text == jtext


def test_counter_gauge_get_or_create():
    reg = obs_metrics.MetricsRegistry()
    c = reg.counter("reqs", comp="a")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert reg.counter("reqs", comp="a") is c
    assert reg.counter("reqs", comp="b") is not c
    g = reg.gauge("depth")
    g.set(3.5)
    assert g.value == 3.5
    reg.gauge("live", fn=lambda: 7)
    assert reg.gauge("live").value == 7
    with pytest.raises(AssertionError):
        reg.histogram("reqs", comp="a")


def test_histogram_quantiles_and_merge():
    reg = obs_metrics.MetricsRegistry()
    h = reg.histogram("lat")
    assert h.quantile(0.5) == 0.0
    for v in (0.001, 0.002, 0.004, 0.008, 0.1):
        h.observe(v)
    assert h.count == 5 and h.sum == pytest.approx(0.115)
    assert 0.001 <= h.quantile(0.50) <= 0.01
    assert h.quantile(1.0) == pytest.approx(0.1)
    h2 = obs_metrics.Histogram("lat2")
    h2.observe(0.2)
    h.merge(h2)
    assert h.count == 6
    assert h.quantile(1.0) == pytest.approx(0.2)
    with pytest.raises(AssertionError):
        h.merge(obs_metrics.Histogram("odd", buckets=(1.0, 2.0)))


def test_scope_binds_and_nests_labels():
    reg = obs_metrics.MetricsRegistry()
    s = reg.scope(engine="0")
    c = s.counter("ops", component="pager")
    assert dict(c.labels) == {"engine": "0", "component": "pager"}
    s2 = s.scope(component="exec").scope(component="exec2")
    assert dict(s2.counter("ops").labels) == {"engine": "0",
                                              "component": "exec2"}


def test_snapshot_and_prometheus_export():
    reg = obs_metrics.MetricsRegistry()
    reg.counter("hits", component="pager").inc(3)
    reg.gauge("depth").set(2)
    reg.histogram("wait_s").observe(0.005)
    snap = reg.snapshot()
    assert snap["counters"]['hits{component="pager"}'] == 3
    assert snap["gauges"]["depth"] == 2
    hs = snap["histograms"]["wait_s"]
    assert hs["count"] == 1 and hs["p50"] > 0
    text = reg.to_prometheus()
    assert "# TYPE hits counter" in text
    assert 'hits{component="pager"} 3' in text
    assert "# TYPE wait_s histogram" in text
    assert 'le="+Inf"' in text and "wait_s_count 1" in text


def test_registry_cardinality_guard_caps_per_name_series():
    reg = obs_metrics.MetricsRegistry(max_series_per_name=4)
    for i in range(10):
        reg.counter("chatty", rid=str(i)).inc()
    chatty = [k for k in reg.snapshot()["counters"]
              if k.startswith("chatty")]
    assert len(chatty) == 4
    kept = {k.split('rid="')[1].rstrip('"}') for k in chatty}
    assert kept == {"6", "7", "8", "9"}
    assert reg.counter("obs_series_evicted").value == 6
    assert reg.counter("chatty", rid="0").value == 0


def test_registry_cardinality_guard_lru_touch_on_reuse():
    reg = obs_metrics.MetricsRegistry(max_series_per_name=3)
    hot = reg.counter("m", k="hot")
    hot.inc(5)
    for i in range(8):
        reg.counter("m", k=f"cold{i}")
        assert reg.counter("m", k="hot") is hot
    assert hot.value == 5
    assert reg.counter("obs_series_evicted").value == 6
    for i in range(10):
        reg.gauge("g_other", i=str(i)).set(i)
    assert reg.counter("m", k="hot") is hot


_PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')


def _parse_prom_labels(s):
    """Strict text-format label parser (escapes \\\\, \\" and \\n)."""
    out = {}
    i = 0
    while i < len(s):
        eq = s.index("=", i)
        key = s[i:eq]
        assert s[eq + 1] == '"', s
        i, val = eq + 2, []
        while s[i] != '"':
            if s[i] == "\\":
                esc = s[i + 1]
                assert esc in ('\\', '"', 'n'), f"bad escape \\{esc}"
                val.append({"\\": "\\", '"': '"', "n": "\n"}[esc])
                i += 2
            else:
                val.append(s[i])
                i += 1
        out[key] = "".join(val)
        i += 1
        if i < len(s):
            assert s[i] == ",", s
            i += 1
    return out


def test_prometheus_roundtrip_nasty_labels():
    reg = obs_metrics.MetricsRegistry()
    nasty = {"path": 'C:\\tmp\\"x"', "note": 'line1\nline2', "plain": "ok"}
    reg.counter("pager.hits", **nasty).inc(3)
    reg.counter("pager.hits", plain="other").inc(1)
    reg.gauge("depth", q='say "when"').set(2.5)
    reg.histogram("wait.s", tenant="a\\b").observe(0.004)
    helps, types, samples = {}, {}, []
    for line in reg.to_prometheus().splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            fam = line.split(" ", 3)[2]
            helps[fam] = helps.get(fam, 0) + 1
        elif line.startswith("# TYPE "):
            fam = line.split(" ", 3)[2]
            types[fam] = types.get(fam, 0) + 1
            assert fam in helps
        else:
            m = _PROM_SAMPLE.match(line)
            assert m, f"unparseable sample line: {line!r}"
            name, raw, value = m.groups()
            samples.append((name, _parse_prom_labels(raw) if raw else {},
                            float(value)))
    assert helps == {"pager_hits": 1, "depth": 1, "wait_s": 1}
    assert types == helps
    assert [ls for n, ls, v in samples
            if n == "pager_hits" and v == 3.0] == [nasty]
    assert any(n == "depth" and ls == {"q": 'say "when"'} and v == 2.5
               for n, ls, v in samples)
    assert [ls for n, ls, _ in samples if n == "wait_s_bucket"
            and ls.get("le") == "+Inf"] == [{"tenant": "a\\b", "le": "+Inf"}]


# -- explain(): complete traces in every engine mode -------------------------


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_explain_complete_all_modes(tmp_path, paged, quant):
    eng, X = _mk(tmp_path, f"ex-{paged}-{quant}", paged=paged, quant=quant)
    tr = eng.explain(X[:2] + 0.01, Q.knn(k=5, n_probe=4))
    assert tr is not None and tr.mode == ("paged" if paged else "resident")
    assert tr.n_queries == 2 and tr.total_ms > 0 and tr.spec is not None
    for stage in ("plan", "probe", "scan", "merge"):
        assert stage in tr, (stage, tr.span_names)
    scan = tr.get("scan")
    assert scan.counters["partitions"] > 0 and scan.counters["rows"] > 0
    assert scan.counters["backend"] == "torch"
    assert scan.counters["quantized"] is quant
    assert tr.counter("probe", "partitions") > 0
    assert ("pager_fault" in tr) == paged
    assert ("rerank" in tr) == quant
    assert tr.result is not None and tr.result.trace is tr
    assert tr in eng.traces.traces()
    assert sum(s.dur_ms for s in tr.spans.values()) <= tr.total_ms
    txt = tr.format()
    assert "scan" in txt and "QueryTrace" in txt
    eng.close()


# the counters both packages compute from the same layout
_SHARED = {"plan": ("kind", "k", "n_probe", "hybrid", "predicate"),
           "probe": ("partitions", "n_probe", "kind", "rows_cap"),
           "pager_fault": ("hits", "misses", "admitted"),
           "scan": ("partitions", "rows", "chunks", "q_bucket",
                    "quantized", "fused"),
           "rerank": ("candidates", "rf", "rows_gathered", "k_out",
                      "fused"),
           "merge": ("k", "k_scan", "fused")}


@pytest.fixture(scope="module", params=["none", "int8"])
def twin_engines(request, tmp_path_factory):
    """The JAX and the port's engines, resident and paged, each on its own
    copy of one JAX-written database."""
    tier = request.param
    X = clustered(900, seed=3)
    attrs = (np.arange(900) % 4).astype(np.float32)[:, None]
    kw = dict(dim=DIM, target_partition_size=50, kmeans_iters=10,
              delta_capacity=64, quantize=tier, rerank_factor=4)
    path = str(tmp_path_factory.mktemp("explain") / f"{tier}.db")
    jeng = JMicroNN(dim=DIM, n_attr=1, path=path, config=JConfig(**kw))
    jeng.upsert(np.arange(900), X, attrs)
    jeng.build()
    jeng.store.db.commit()
    jeng.store.close()
    engines = {}
    for name, budget in (("res", None), ("pag", 0.05)):
        for side in ("jax", "port"):
            p = f"{path}.{side}.{name}"
            shutil.copy(path, p)
            if side == "jax":
                e = JMicroNN(dim=DIM, n_attr=1, path=p, config=JConfig(**kw),
                             memory_budget_mb=budget)
            else:
                e = MicroNN(dim=DIM, n_attr=1, path=p, config=IVFConfig(**kw),
                            device="cpu", memory_budget_mb=budget)
            e.recover()
            engines[side, name] = e
    yield engines, X
    for (side, _), e in engines.items():
        e.store.close() if side == "jax" else e.close()


_ROUTES = {
    "ann": (lambda q: q.knn(k=10, n_probe=4), ("res", "pag")),
    "exact": (lambda q: q.exact(k=10), ("res",)),
    "prefilter": (lambda q: q.knn(k=10, n_probe=4).where(
        _pred(q, 0, "==", 1.0)).prefilter(64), ("res",)),
    "postfilter": (lambda q: q.knn(k=10, n_probe=4).where(
        _pred(q, 0, "<", 2.0)).postfilter(), ("res", "pag")),
}


def _pred(q, col, op, v):
    if q is Q:
        return Pred(col, op, v)
    from repro.core.hybrid import Pred as JPred
    return JPred(col, op, v)


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_explain_matches_jax(twin_engines, route):
    engines, X = twin_engines
    make, modes = _ROUTES[route]
    q = X[100:102] + 0.01
    for mode in modes:
        jt = engines["jax", mode].explain(q, make(JQ))
        pt = engines["port", mode].explain(q, make(Q))
        assert pt.span_names == jt.span_names, (mode, route)
        for name, keys in _SHARED.items():
            if name not in jt:
                continue
            for key in keys:
                assert pt.counter(name, key, None) == \
                    jt.counter(name, key, None), (mode, route, name, key)
        ji, ps = np.asarray(jt.result.ids), pt.result.to_numpy()[0]
        np.testing.assert_array_equal(np.sort(ji, 1), np.sort(ps, 1))


def test_trace_counters_reconcile_paged(tmp_path):
    eng, X = _mk(tmp_path, "recon", paged=True, quant=True, n=600)
    spec = Q.knn(k=5, n_probe=4)
    eng.query(X[:2], spec)
    s0 = eng.stats()
    tr = eng.explain(X[300:302], spec)
    s1 = eng.stats()
    for key in ("hits", "misses", "bytes_read"):
        assert tr.counter("pager_fault", key) == s1[key] - s0[key], key
    assert tr.counter("pager_fault", "hits") \
        + tr.counter("pager_fault", "misses") > 0
    eng.close()


def test_trace_launch_and_load_counters_reconcile(tmp_path):
    """The port's counterpart of the reference's compile reconciliation:
    the scan span's `launches` and `compiled` equal the launch and
    kernel-load deltas (both 0 on the CPU, where the plain versions run),
    and every query is one run_count() step."""
    eng, X = _mk(tmp_path, "loads", quant=True)
    spec = Q.knn(k=7, n_probe=5)
    for i in range(2):
        l0 = sum(ops.launch_counts().values())
        c0, r0 = build.load_count(), executor.run_count()
        tr = eng.explain(X[i:i + 1], spec)
        assert tr.counter("scan", "launches") == \
            sum(ops.launch_counts().values()) - l0
        assert tr.counter("scan", "compiled") == build.load_count() - c0
        assert tr.counter("scan", "cache_hit") is \
            (tr.counter("scan", "compiled") == 0)
        assert executor.run_count() == r0 + 1
    st = eng.stats()
    assert st["run_count"] == executor.run_count()
    assert st["kernel_loads"] == build.load_count()
    assert "trace_count" not in st and "compile_cache_size" not in st
    snap = obs_metrics.default_registry().snapshot()["gauges"]
    assert snap['run_count{component="executor"}'] == executor.run_count()
    eng.close()


# -- stages where the work happens: no waits, one probe, profiler ranges -----


@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_traced_query_waits_only_at_finish_and_probes_once(tmp_path,
                                                           monkeypatch,
                                                           paged):
    """A traced int8 query calls no device synchronisation before its
    trace's finish, and computes its centroid scores as often as the
    untraced query does (the probe span reads the real probe)."""
    eng, X = _mk(tmp_path, f"nosync-{paged}", paged=paged, quant=True)
    spec = Q.knn(k=5, n_probe=4)
    q = X[:16] + 0.01          # above SMALL_Q_GATHER_MAX: the union plan
    eng.query(q, spec)
    calls = [0]
    real_scores = executor._centroid_scores

    def counted(*a, **kw):
        calls[0] += 1
        return real_scores(*a, **kw)

    monkeypatch.setattr(executor, "_centroid_scores", counted)
    eng.query(q, spec)
    untraced, calls[0] = calls[0], 0
    events = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: events.append("sync"))
    monkeypatch.setattr(executor, "_sync",
                        lambda *a, **kw: events.append("sync"), raising=False)
    real_finish = obs_trace.QueryTrace.finish

    def finish(self):
        events.append("finish")
        return real_finish(self)

    monkeypatch.setattr(obs_trace.QueryTrace, "finish", finish)
    tr = eng.explain(q, spec)
    assert untraced >= 1 and calls[0] == untraced
    assert events[0] == "finish", events
    assert tr.span_names[-2:] == ("rerank", "merge")
    for name in ("rerank", "merge"):
        assert tr.get(name).dur_ms > 0, name
    assert sum(s.dur_ms for s in tr.spans.values()) <= tr.total_ms
    for s in tr.spans.values():
        assert not any(isinstance(v, torch.Tensor)
                       for v in s.counters.values()), s
    if not paged:
        # the probe union's size, read at finish, is the distinct probes'
        parts = executor.find_nearest_centroids(
            eng.index, torch.as_tensor(q), 4)
        n = int(torch.unique(parts).numel())
        assert tr.counter("probe", "partitions") == n
        assert tr.counter("scan", "rows") == n * eng.index.p_max
        assert tr.counter("rerank", "candidates") == \
            16 * min(5 * 4, n * eng.index.p_max)
    eng.close()


def test_ring_keeps_no_traced_result_alive(tmp_path):
    """A traced query's trace refers to its result without holding it, so
    dropping the result frees it (and its device tensors) at once, with
    no garbage collection; explain()'s trace holds its result."""
    eng, X = _mk(tmp_path, "weak")
    spec = Q.knn(k=5, n_probe=4)
    gc.disable()
    try:
        rs = eng.query(X[:2], spec, trace=True)
        tr = rs.trace
        assert tr.result is rs and tr in eng.traces.traces()
        gone = weakref.ref(rs)
        del rs
        assert gone() is None and tr.result is None
    finally:
        gc.enable()
    tr = eng.explain(X[:2], spec)
    assert tr.result is not None and tr.result.trace is tr
    eng.close()


def test_stage_hook_is_the_shared_noop_when_nothing_records():
    assert obs_trace.current() is None
    assert not torch.autograd._profiler_enabled()
    assert obs_trace.stage(obs_trace.STAGE_SCAN) is obs_trace.NO_STAGE
    assert not obs_trace.NO_STAGE
    tr = obs_trace.QueryTrace()
    with obs_trace.activate(tr):
        with obs_trace.stage(obs_trace.STAGE_SCAN) as st:
            assert st and st is not obs_trace.NO_STAGE
            st.note(rows=torch.tensor(3), chunks=1)
        with obs_trace.stage(obs_trace.STAGE_SCAN) as st:
            st.note(rows=torch.tensor(4), chunks=1)
        obs_trace.set_enabled(False)
        try:
            assert obs_trace.stage("x") is obs_trace.NO_STAGE
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                assert obs_trace.stage("x") is obs_trace.NO_STAGE
        finally:
            obs_trace.set_enabled(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        st = obs_trace.stage("x")
        assert st is not obs_trace.NO_STAGE and not st
    tr.finish()
    scan = tr.get("scan")
    assert scan.calls == 2 and scan.counters == {"rows": 7, "chunks": 2}
    assert tr.span_names == ("scan",)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_untraced_query_stages_are_profiler_ranges(tmp_path, quant):
    """Under torch.profiler an untraced query's stages are the ranges
    micronn.plan, .probe, .scan, (.rerank,) .merge: disjoint, in order."""
    eng, X = _mk(tmp_path, f"prof-{quant}", quant=quant)
    spec = Q.knn(k=5, n_probe=4)
    q = X[:16] + 0.01
    eng.query(q, spec)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rs = eng.query(q, spec)
    assert rs.trace is None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(obs_trace.RANGE_PREFIX))
    want = ["plan", "probe", "scan"] + (["rerank"] if quant else []) \
        + ["merge"]
    assert [n for _, _, n in ranges] == ["micronn." + w for w in want]
    for (_, end, _), (start, _, _) in zip(ranges, ranges[1:]):
        assert end <= start
    assert len(eng.traces) == 1    # the build's event alone
    eng.close()


# -- build(): its stages, from inside -----------------------------------------


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_build_records_its_stages(tmp_path, quant):
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=8,
                    delta_capacity=64,
                    **({"quantize": "int8", "rerank_factor": 4}
                       if quant else {}))
    eng = MicroNN(dim=DIM, path=str(tmp_path / "b.db"), config=cfg,
                  device="cpu")
    eng.upsert(np.arange(400), clustered(400, 1))
    t0 = time.perf_counter()
    eng.build()
    wall = time.perf_counter() - t0
    want = [s for s in obs_trace.BUILD_STAGES
            if quant or s not in ("quantize", "codes")]
    inst = dict(eng.metrics.labels)["inst"]
    hist = {}
    for key, h in obs_metrics.default_registry().snapshot()[
            "histograms"].items():
        labels = dict(re.findall(r'(\w+)="([^"]*)"', key))
        if key.startswith("stage_s{") and labels.get("inst") == inst:
            assert labels["action"] == "build"
            assert labels["component"] == "engine"
            hist[labels["stage"]] = h
    assert sorted(hist) == sorted(want)
    assert all(h["count"] == 1 for h in hist.values())
    assert sum(h["sum"] for h in hist.values()) <= wall
    builds = [e for e in eng.traces.events() if e.kind == "build"]
    assert len(builds) == 1
    ev = builds[0]
    assert list(ev.stages) == want and ev.rows == 400
    for name in want:
        assert ev.stages[name] / 1e3 == pytest.approx(hist[name]["sum"])
    assert ev.to_dict()["stages"] == ev.stages
    assert eng.traces.traces() == []
    eng.close()


# -- the store's reads, the write stages, the planner's plans ----------------


def _counter(scope_labels, name, **labels):
    want = dict(scope_labels, **labels)
    for (n, labs), m in obs_metrics.default_registry()._metrics.items():
        if n == name and dict(labs) == want:
            return m.value
    return None


def test_store_read_counters_count_each_call(tmp_path):
    """rows_read / bytes_read move once a call by the rows the call
    returned and their payload bytes; a repeated or missing id reads no
    row of its own."""
    from repro_torch.storage.store import VectorStore
    d, n = 8, 120
    rng = np.random.default_rng(5)
    st = VectorStore(str(tmp_path / "r.db"), dim=d, n_attr=2)
    X = rng.normal(size=(n, d)).astype(np.float32)
    st.upsert(np.arange(n), X, rng.random((n, 2)).astype(np.float32))
    parts = rng.integers(0, 6, n)
    st.set_partitions(np.arange(n), parts, np.zeros((6, d), np.float32),
                      np.bincount(parts, minlength=6).astype(np.float32))
    coded = np.arange(0, n, 2)
    st.set_code_tier(coded, np.ones((len(coded), d), np.int8),
                     np.zeros(d, np.float32), np.ones(d, np.float32))
    rows, nbytes = st._c_rows_read, st._c_bytes_read
    for kw in ({"with_vecs": True}, {"with_codes": True, "with_vecs": False,
                                      "with_attrs": True}):
        r0, b0 = rows.value, nbytes.value
        blocks = st.scan_partitions([4, 1, 3], 64, **kw)
        got = int(blocks.valid.sum())
        want_b = got * 4 * d if kw["with_vecs"] else \
            int(blocks.code_ok.sum()) * d + got * 4 * 2
        assert rows.value - r0 == got > 0
        assert nbytes.value - b0 == want_b
    r0, b0 = rows.value, nbytes.value
    _, found = st.vectors_for([7, 3, 7, n + 5, 9])
    assert list(found) == [True, True, True, False, True]
    assert rows.value - r0 == 3 and nbytes.value - b0 == 3 * 4 * d
    st.close()


@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_write_stages_one_commit_a_session_one_flush_a_flush(
        tmp_path, monkeypatch, paged):
    eng, X = _mk(tmp_path, "w", paged=paged, quant=True)
    flushes = []
    real = MicroNN.maintain

    def maintain(self, force=None, **kw):
        if force == "flush":
            flushes.append(1)
        return real(self, force, **kw)

    monkeypatch.setattr(MicroNN, "maintain", maintain)
    rng = np.random.default_rng(9)
    for i in range(6):
        with eng.session() as s:
            s.upsert(np.arange(1000 + 30 * i, 1030 + 30 * i),
                     rng.normal(size=(30, DIM)).astype(np.float32))
            s.delete(np.arange(5 * i, 5 * i + 3))
    eng.upsert(np.arange(5000, 5040),
               rng.normal(size=(40, DIM)).astype(np.float32))
    hist = {}
    for (name, labs), m in obs_metrics.default_registry()._metrics.items():
        labs = dict(labs)
        if name == "stage_s" and labs.get("inst") == \
                dict(eng.metrics.labels)["inst"] and \
                labs.get("action") == "write":
            hist[labs["stage"]] = m
    assert hist["commit"].count == 6          # sessions only
    assert len(flushes) >= 2 and hist["flush"].count == len(flushes)
    assert hist["commit"].sum > 0 and hist["flush"].sum > 0
    eng.close()


def test_plan_counter_matches_plan_spec(tmp_path, monkeypatch):
    from repro_torch.core.optimizer import HybridOptimizer
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=8)
    eng = MicroNN(dim=DIM, n_attr=2, path=str(tmp_path / "p.db"),
                  config=cfg, device="cpu")
    rng = np.random.default_rng(3)
    X = clustered(2000, 3)
    A = np.stack([rng.integers(0, 10, 2000), rng.random(2000)],
                 1).astype(np.float32)
    eng.upsert(np.arange(2000), X, A)
    eng.build()
    plans = []
    real = HybridOptimizer.plan_spec

    def plan_spec(self, index, spec):
        out, dec = real(self, index, spec)
        plans.append(dec.plan)
        return out, dec

    monkeypatch.setattr(HybridOptimizer, "plan_spec", plan_spec)
    scope = dict(eng.metrics.labels, component="planner")
    before = {p: _counter(scope, "plans", plan=p) for p in ("pre", "post")}
    for i, pred in enumerate([Pred(1, "lt", 0.01), Pred(0, "eq", 3.0),
                              Pred(1, "lt", 0.5), Pred(1, "lt", 0.002),
                              Pred(0, "eq", 7.0)]):
        eng.query(X[:4], Q.knn(k=5, n_probe=4).where(pred))
    eng.query(X[:4], Q.knn(k=5, n_probe=4))          # no predicate
    for p in ("pre", "post"):
        assert _counter(scope, "plans", plan=p) - before[p] == \
            plans.count(p)
    assert set(plans) == {"pre", "post"}
    eng.close()


def test_untraced_results_equal_without_the_counters(tmp_path, monkeypatch):
    """Two engines on the same rows, writes and queries, the second with
    the store's, the planner's and the write path's instruments turned
    into no-ops: the same ids and scores bit for bit."""
    from repro_torch.core.optimizer import HybridOptimizer
    from repro_torch.storage.store import VectorStore

    def drive(tag, paged):
        cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=8,
                        delta_capacity=64, quantize="int8", rerank_factor=4)
        eng = MicroNN(dim=DIM, n_attr=2, path=str(tmp_path / f"{tag}.db"),
                      config=cfg, device="cpu",
                      memory_budget_mb=0.05 if paged else None)
        rng = np.random.default_rng(11)
        X = clustered(1500, 4)
        A = np.stack([rng.integers(0, 10, 1500), rng.random(1500)],
                     1).astype(np.float32)
        eng.upsert(np.arange(1500), X, A)
        eng.build()
        out = []
        for i in range(4):
            with eng.session() as s:
                s.upsert(np.arange(2000 + 40 * i, 2040 + 40 * i),
                         X[40 * i:40 * i + 40], A[:40])
                s.delete(np.arange(7 * i, 7 * i + 4))
            for pred in (Pred(1, "lt", 0.02), Pred(0, "eq", float(i))):
                ids, sc = eng.query(X[100:108], Q.knn(k=10, n_probe=6)
                                    .where(pred)).to_numpy()
                out.append((ids.copy(), sc.copy()))
        eng.close()
        return out

    for paged in (False, True):
        on = drive(f"on{paged}", paged)
        with monkeypatch.context() as m:
            m.setattr(VectorStore, "_count_read", lambda self, r, b: None)
            m.setattr(MicroNN, "_write_trace",
                      lambda self: contextlib.nullcontext())
            real_init = HybridOptimizer.__init__

            def init(self, *a, **kw):
                real_init(self, *a, **kw)
                self._c_plans = {p: SimpleNamespace(inc=lambda n=1: None)
                                 for p in ("pre", "post")}
            m.setattr(HybridOptimizer, "__init__", init)
            off = drive(f"off{paged}", paged)
        for (i1, s1), (i2, s2) in zip(on, off):
            assert np.array_equal(i1, i2)
            assert np.array_equal(s1.view(np.int32), s2.view(np.int32))


# -- tracing off: zero cost, zero allocation ---------------------------------


def test_untraced_queries_allocate_nothing(tmp_path):
    eng, X = _mk(tmp_path, "zero")
    spec = Q.knn(k=5, n_probe=4)
    eng.query(X[:1], spec)
    reg = obs_metrics.default_registry()
    size0, ring0 = reg.size(), len(eng.traces)
    for i in range(5):
        assert eng.query(X[i:i + 1], spec).trace is None
    assert reg.size() == size0, "an untraced query registered a series"
    assert len(eng.traces) == ring0, "an untraced query entered the ring"
    obs_trace.set_enabled(False)
    try:
        rs = eng.query(X[:1], spec, trace=True)
        assert rs.trace is None and len(eng.traces) == ring0
    finally:
        obs_trace.set_enabled(True)
    eng.close()


# -- front door: per-caller traces under concurrent load ---------------------


def test_frontdoor_traced_submits_under_threads(tmp_path):
    eng, X = _mk(tmp_path, "fdtrace")
    spec = Q.knn(k=5, n_probe=4)
    n_req = 8
    solo = [eng.query(X[i] + 0.01, spec) for i in range(n_req)]
    results = [None] * n_req
    # a window far above the test's length, closed by max_batch_rows:
    # the dispatcher fuses all eight requests once they are queued
    with FrontDoor(eng, window_s=30.0, max_batch_rows=n_req) as fd:
        def worker(i):
            results[i] = fd.query(X[i] + 0.01, spec, trace=(i % 2 == 0),
                                  timeout=60)
        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(n_req)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        st = fd.stats()
    assert st["completed"] == n_req and st["failed"] == 0
    assert st["batches"] == 1 and st["coalesced"] == n_req
    for i, rs in enumerate(results):
        np.testing.assert_array_equal(rs.to_numpy()[0],
                                      solo[i].to_numpy()[0])
        if i % 2 == 0:
            tr = rs.trace
            assert tr is not None and "queue_wait" in tr
            for stage in ("plan", "probe", "scan"):
                assert stage in tr, (stage, tr.span_names)
            assert tr.shared is not None
            assert tr in eng.traces.traces()
            assert tr.counter("split", "callers") == n_req
        else:
            assert rs.trace is None
    traced = [r.trace for i, r in enumerate(results) if i % 2 == 0]
    assert len({id(t.get("scan")) for t in traced}) == 1
    eng.close()


def test_frontdoor_stats_derive_from_histograms(tmp_path):
    eng, X = _mk(tmp_path, "fdh")
    with FrontDoor(eng, window_s=0.0) as fd:
        for i in range(4):
            fd.query(X[i], Q.knn(k=5, n_probe=4), timeout=30)
        st = fd.stats()
        assert st["total_p50_ms"] > 0 and st["execute_p99_ms"] > 0
        assert fd.metrics.histogram("total_s").count == 4
    eng.close()


# -- scheduler telemetry + maintenance event log -----------------------------


def test_scheduler_telemetry_and_event_log(tmp_path):
    eng, X = _mk(tmp_path, "sched", n=400)
    eng.upsert(np.arange(400, 480), clustered(80, seed=9))
    reports = eng.maintain(until_idle=True)
    assert reports
    st = eng.scheduler.stats()
    assert st["steps"] == len(reports)
    assert st["rows_moved"] == sum(r.rows for r in reports)
    assert st["bytes_written"] == sum(r.bytes_written for r in reports)
    assert sum(st["actions"].values()) == st["steps"]
    assert st["actions"]["flush"] >= 1
    assert eng.stats()["scheduler"]["steps"] == st["steps"]
    events = eng.traces.events()
    kinds = [e.kind for e in events]
    assert kinds.count("step") == len(reports)
    assert kinds.index("planned") < kinds.index("step")
    steps = [e for e in events if e.kind == "step"]
    assert sum(e.rows for e in steps) == st["rows_moved"]
    assert all(e.dur_ms >= 0 and e.action for e in steps)
    assert all(e.to_dict()["kind"] == e.kind for e in events)
    eng.close()


# -- trace ring + slow-query log ---------------------------------------------


def test_trace_ring_bounded_and_slow_log(tmp_path):
    eng, X = _mk(tmp_path, "ring", trace_ring_capacity=4, slow_query_ms=0.0)
    spec = Q.knn(k=5, n_probe=4)
    for i in range(6):
        eng.explain(X[i:i + 1], spec)
    assert len(eng.traces) == 4 and len(eng.traces.traces()) == 4
    slow = eng.traces.slow()
    assert len(slow) == 6 and all(t.total_ms >= 0.0 for t in slow)
    eng.traces.clear()
    assert len(eng.traces) == 0 and not eng.traces.slow()
    eng.close()


def test_slow_log_threshold_filters(tmp_path):
    eng, X = _mk(tmp_path, "slowhi", slow_query_ms=1e9)
    eng.explain(X[:1], Q.knn(k=5, n_probe=4))
    assert len(eng.traces.traces()) == 1
    assert eng.traces.slow() == []
    eng.close()


# -- recorder + traces + daemon under threads, pinned against a twin ---------


def test_interleave_recorder_traces_pinned_vs_twin(tmp_path):
    """Flight recorder + trace ring + maintenance daemon under threaded
    traced submits: every answer equals a single-threaded twin's bit for
    bit, the capture replays on the twin, the daemon survives. Each round
    the dispatcher waits for all callers (max_batch_rows = callers, a
    window far above the test's length), so every fused call has exactly
    one request per thread and no request runs solo."""
    eng, X = _mk(tmp_path, "il-mt", seed=5)
    twin, _ = _mk(tmp_path, "il-st", seed=5)
    spec = Q.knn(k=5, n_probe=4)
    n_threads, per = 4, 6
    probes = [[X[(t * per + j) % len(X)] + 0.01 for j in range(per)]
              for t in range(n_threads)]
    results = [[None] * per for _ in range(n_threads)]
    errors = []
    cap = str(tmp_path / "cap.db")
    with obs_recorder.recording(cap) as rec:
        with FrontDoor(eng, window_s=30.0, max_batch_rows=n_threads,
                       maintenance=True) as fd:
            def caller(t):
                try:
                    for j in range(per):
                        results[t][j] = fd.query(
                            probes[t][j], spec, trace=(t % 2 == 0),
                            timeout=60)
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)
            threads = [threading.Thread(target=caller, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
            assert not errors, errors
            assert eng.scheduler.daemon_alive
            assert fd.stats()["solo"] == 0
            eng.upsert(np.arange(400, 440), clustered(40, seed=6))
            eng.maintain(until_idle=True)
            assert any(e.kind == "step" for e in eng.traces.events())
        assert rec.recorded == n_threads * per
    for t in range(n_threads):
        for j in range(per):
            a = results[t][j].to_numpy()
            b = twin.query(probes[t][j], spec).to_numpy()
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            rs = results[t][j]
            if t % 2 == 0:
                assert rs.trace is not None \
                    and rs.trace in eng.traces.traces()
            else:
                assert rs.trace is None
    rep = obs_recorder.replay(cap, engine=twin, strict=True)
    assert rep.ok and rep.self_checked == n_threads * per
    eng.close()
    twin.close()
