"""The port's hybrid planner against the JAX package: selectivity
estimation (AttributeStats), the optimizer's decisions and caps (paper
Eqs. 1-3), the pre-filter plan's compaction and results, the executor's
routing of "auto" / "pre" / "post", the engine's spec rewrite, and the
search / mqo shims.

The estimates run on the host in float64 numpy with the reference's calls,
so they, and every decision and cap, must be equal. Result scores sum in a
different order: they agree within 1e-5 * (||q||^2 + max ||v||^2), ids row
by row except inside runs of reference scores tied within that tolerance
(repro_torch.testing).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as jexecutor
from repro.core import hybrid as jhybrid
from repro.core import ivf as jivf
from repro.core import mqo as jmqo
from repro.core import optimizer as joptimizer
from repro.core import query as jquery
from repro.core import search as jsearch
from repro.core.types import IVFConfig as JConfig
from repro.storage.engine import MicroNN as JMicroNN
from repro_torch import convert
from repro_torch.core import executor, hybrid, mqo, optimizer, query, search
from repro_torch.core.types import IVFConfig
from repro_torch.storage.engine import MicroNN
from repro_torch.testing import compare_topk, score_tol

from test_torch_slice import jax_arrays

DIM = 32
N = 2000
CFG = dict(dim=DIM, target_partition_size=50, minibatch_size=128,
           kmeans_iters=10, delta_capacity=256, rerank_factor=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=N, seed=11):
    """The reference's hybrid_index data: clustered rows, a categorical, a
    continuous and a tag-bitset attribute."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, DIM)).astype(np.float32) * 5.0
    X = (centers[rng.integers(0, 20, n)]
         + rng.normal(size=(n, DIM))).astype(np.float32)
    attrs = np.stack([rng.integers(0, 10, n), rng.normal(size=n) * 10,
                      rng.integers(0, 2 ** 8, n)], axis=1).astype(np.float32)
    q = (X[rng.integers(0, n, 16)]
         + 0.3 * rng.normal(size=(16, DIM))).astype(np.float32)
    return X, attrs, q


_BUILDS = {}


def _indexes(tier):
    """(JAX index, port index converted from it, X, attrs, q)."""
    if tier not in _BUILDS:
        X, attrs, q = _data()
        jidx = jivf.build_index(X, attrs=attrs,
                                cfg=JConfig(quantize=tier, **CFG))
        tidx = convert.index_from_arrays(
            jax_arrays(jidx), dataclasses.asdict(jidx.config), "cpu")
        _BUILDS[tier] = (jidx, tidx, X, attrs, q)
    return _BUILDS[tier]


def _tree(mod, t):
    """A predicate tree from a nested tuple, in either package's types."""
    if t[0] in ("and", "or"):
        kids = tuple(_tree(mod, c) for c in t[1:])
        return mod.And(kids) if t[0] == "and" else mod.Or(kids)
    return mod.Pred(*t)


TREES = [
    (0, "eq", 3.0), (0, "ne", 3.0), (0, "eq", 42.0), (1, "lt", -25.0),
    (1, "le", 0.0), (1, "gt", 15.0), (1, "ge", -100.0), (1, "lt", 1e9),
    (2, "match", 5.0), (2, "match", 129.0),
    ("and", (0, "eq", 3.0), (1, "gt", 15.0)),
    ("or", (0, "eq", 1.0), (0, "eq", 2.0)),
    ("or", ("and", (0, "eq", 3.0), (2, "match", 1.0)), (1, "lt", -20.0)),
]


def _live_attrs(jidx):
    flat = np.asarray(jidx.attrs).reshape(-1, jidx.attrs.shape[-1])
    return flat[np.asarray(jidx.valid).reshape(-1)]


@pytest.mark.parametrize("t", TREES, ids=lambda t: str(t).replace(" ", ""))
def test_attribute_stats_equal_jax(t):
    _, _, _, attrs, _ = _indexes("none")
    js = jhybrid.AttributeStats(attrs, bitset_cols=(2,))
    ts = hybrid.AttributeStats(attrs, bitset_cols=(2,))
    jt, tt = _tree(jhybrid, t), _tree(hybrid, t)
    assert ts.cardinality(tt) == js.cardinality(jt)
    assert ts.selectivity_factor(tt) == js.selectivity_factor(jt)
    for c in range(attrs.shape[1]):
        np.testing.assert_array_equal(ts.cols[c].counts, js.cols[c].counts)
        assert ts.cols[c].n_distinct == js.cols[c].n_distinct


@pytest.mark.parametrize("max_cap", [None, 512])
def test_optimizer_decisions_and_caps_equal_jax(max_cap):
    jidx, tidx, _, _, _ = _indexes("none")
    live = _live_attrs(jidx)
    jopt = joptimizer.HybridOptimizer(
        jhybrid.AttributeStats(live, bitset_cols=(2,)),
        max_prefilter_cap=max_cap)
    topt = optimizer.HybridOptimizer(
        hybrid.AttributeStats(live, bitset_cols=(2,)),
        max_prefilter_cap=max_cap)
    assert tidx.num_live() == int(jidx.num_live())
    plans = set()
    for t in TREES:
        for n_probe in (1, 4, 8, 32):
            jd = jopt.choose(jidx, _tree(jhybrid, t), n_probe)
            td = topt.choose(tidx, _tree(hybrid, t), n_probe)
            assert dataclasses.asdict(td) == dataclasses.asdict(jd), t
            plans.add(td.plan)
            for h in ("auto", "pre", "post"):
                jspec = dataclasses.replace(
                    jquery.Q.knn(k=10, n_probe=n_probe)
                    .where(_tree(jhybrid, t)), hybrid=h)
                tspec = dataclasses.replace(
                    query.Q.knn(k=10, n_probe=n_probe)
                    .where(_tree(hybrid, t)), hybrid=h)
                js, jdec = jopt.plan_spec(jidx, jspec)
                ts, tdec = topt.plan_spec(tidx, tspec)
                assert (ts.hybrid, ts.cap) == (js.hybrid, js.cap)
                assert dataclasses.asdict(tdec) == dataclasses.asdict(jdec)
    assert plans == {"pre", "post"}


@pytest.mark.parametrize("cap", [64, 256, 2048])
def test_plan_prefilter_rows_equal_jax(cap):
    jidx, tidx, _, attrs, q = _indexes("none")
    t = ("or", (0, "eq", 3.0), (1, "gt", 12.0))        # ~300 rows qualify
    jf = jhybrid.compile_filter(_tree(jhybrid, t))
    tf = hybrid.compile_filter(_tree(hybrid, t))
    jplan = jexecutor.plan_prefilter(jidx, jnp.asarray(q), 10, jf, cap)
    tplan = executor.plan_prefilter(tidx, torch.from_numpy(q), 10, tf, cap)
    np.testing.assert_array_equal(np.asarray(jplan.rows), tplan.rows.numpy())
    n_ok = int(((attrs[:, 0] == 3) | (attrs[:, 1] > 12)).sum())
    total = tidx.k * tidx.p_max
    assert int((tplan.rows < total).sum()) == min(cap, n_ok)


def test_compact_rows_is_nonzero_with_size():
    rng = np.random.default_rng(5)
    for n, p, cap in ((1, 1.0, 1), (37, 0.0, 8), (500, 0.3, 64),
                      (500, 0.3, 400), (1000, 0.9, 1000)):
        ok = rng.random(n) < p
        got = executor.compact_rows(torch.from_numpy(ok), cap).numpy()
        want = np.asarray(jnp.nonzero(jnp.asarray(ok), size=cap,
                                      fill_value=n)[0])
        np.testing.assert_array_equal(got, want)


def _assert_same(jres, tres, q, X):
    v2 = float(np.sum(X * X, -1).max())
    err, ok, bad = compare_topk(np.asarray(jres.scores), np.asarray(jres.ids),
                                tres.to_numpy()[1], tres.to_numpy()[0],
                                score_tol(q, v2))
    assert ok, f"{bad} query rows differ (max score err {err:.3e})"


@pytest.mark.parametrize("tier", ["none", "int8"])
@pytest.mark.parametrize("hyb", ["auto", "pre", "post"])
def test_hybrid_plans_match_jax(tier, hyb):
    """An unresolved "auto" runs the fused post-filter on both sides; "pre"
    scans the compacted rows (a cap that truncates included)."""
    jidx, tidx, X, attrs, q = _indexes(tier)
    for t, cap in (((0, "eq", 3.0), 512), ((1, "gt", 15.0), 64)):
        jspec = dataclasses.replace(
            jquery.Q.knn(k=10, n_probe=4).where(_tree(jhybrid, t)),
            hybrid=hyb, cap=cap if hyb == "pre" else None)
        tspec = dataclasses.replace(
            query.Q.knn(k=10, n_probe=4).where(_tree(hybrid, t)),
            hybrid=hyb, cap=cap if hyb == "pre" else None)
        jres = jexecutor.run(jidx, jnp.asarray(q), jspec)
        tres = executor.run(tidx, q, tspec)
        _assert_same(jres, tres, q, X)
        got = tres.to_numpy()[0]
        keep = hybrid.compile_filter(_tree(hybrid, t))(
            torch.from_numpy(attrs)).numpy()
        assert keep[got[got >= 0]].all()


def test_prefilter_has_full_recall():
    """The pre-filter plan is exact over the qualifying rows: recall 1.0
    against a filtered brute force."""
    _, tidx, X, attrs, q = _indexes("int8")
    t = ("and", (0, "eq", 3.0), (1, "gt", 5.0))
    ok = (attrs[:, 0] == 3) & (attrs[:, 1] > 5)
    spec = query.Q.knn(k=10).where(_tree(hybrid, t)).prefilter(512)
    got = executor.run(tidx, q, spec).to_numpy()[0]
    d2 = ((q[:, None, :].astype(np.float64) - X[None, :, :]) ** 2).sum(-1)
    d2[:, ~ok] = np.inf
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10]
    for row, want in zip(got, gt):
        assert set(row.tolist()) == set(want.tolist())


def test_prefilter_needs_a_cap():
    _, tidx, _, _, q = _indexes("none")
    spec = query.Q.knn(k=10).where(hybrid.Pred(0, "eq", 3.0)).prefilter()
    with pytest.raises(ValueError, match="cap"):
        executor.run(tidx, q, spec)


def test_engine_resolves_hybrid_specs_like_jax(tmp_path):
    """A JAX-written database recovered by the port: MicroNN.query rewrites
    "auto" (and an open "pre" cap) through the optimizer exactly as the JAX
    engine does, and the answers agree."""
    X, attrs, q = _data(n=1500, seed=13)
    path = str(tmp_path / "h.db")
    jeng = JMicroNN(dim=DIM, n_attr=3, path=path, config=JConfig(**CFG))
    jeng.upsert(np.arange(1500), X, attrs)
    jeng.build()
    teng = MicroNN(dim=DIM, n_attr=3, path=path, config=IVFConfig(**CFG),
                   device="cpu")
    teng.recover()
    for t in ((0, "eq", 3.0), ("and", (0, "eq", 3.0), (1, "gt", 10.0)),
              (1, "gt", -5.0)):
        for h in ("auto", "pre"):
            jspec = dataclasses.replace(
                jquery.Q.knn(k=10, n_probe=4).where(_tree(jhybrid, t)),
                hybrid=h)
            tspec = dataclasses.replace(
                query.Q.knn(k=10, n_probe=4).where(_tree(hybrid, t)),
                hybrid=h)
            js = jeng._resolve_spec(jeng.index, jeng.optimizer, jspec)
            ts = teng._resolve_spec(teng.index, teng.optimizer, tspec)
            assert (ts.hybrid, ts.cap) == (js.hybrid, js.cap)
            _assert_same(jeng.query(q, jspec), teng.query(q, tspec), q, X)
    jeng.store.close()
    teng.close()


def test_search_and_mqo_shims_match_jax():
    jidx, tidx, X, attrs, q = _indexes("none")
    jf = jhybrid.compile_filter(jhybrid.Pred(0, "ne", 3.0))
    tf = hybrid.compile_filter(hybrid.Pred(0, "ne", 3.0))
    jq = jnp.asarray(q)
    pairs = [
        (jsearch.ann_search(jidx, jq, 10, 4),
         search.ann_search(tidx, q, 10, 4)),
        (jsearch.ann_search(jidx, jq, 10, 4, attr_filter=jf),
         search.ann_search(tidx, q, 10, 4, attr_filter=tf)),
        (jsearch.exact_search(jidx, jq, 10, attr_filter=jf),
         search.exact_search(tidx, q, 10, attr_filter=tf)),
        (jsearch.prefilter_search(jidx, jq, 10, jf, cap=256),
         search.prefilter_search(tidx, q, 10, tf, cap=256)),
        (jmqo.mqo_search(jidx, jq, 10, 4, u_max=12),
         mqo.mqo_search(tidx, q, 10, 4, u_max=12)),
    ]
    for jres, tres in pairs:
        _assert_same(jres, tres, q, X)
    jex = jsearch.exact_search(jidx, jq, 10)
    tex = search.exact_search(tidx, q, 10)
    assert float(search.recall_at_k(pairs[0][1], tex, 10)) == \
        pytest.approx(float(jsearch.recall_at_k(pairs[0][0], jex, 10)))
    for args in ((16, 4), (16, 4, 10), (3, 8, None, False)):
        assert mqo.gathered_bytes(tidx, *args) == \
            jmqo.gathered_bytes(jidx, *args)
    # the optimizer's kwarg shim: a selective predicate goes "pre" and is
    # exact over the qualifying rows
    opt = optimizer.HybridOptimizer(hybrid.AttributeStats(attrs))
    pred = hybrid.And((hybrid.Pred(0, "eq", 3.0), hybrid.Pred(1, "gt", 15.0)))
    res, dec = opt.execute(tidx, q, pred, 10, n_probe=8)
    assert dec.plan == "pre"
    exact = search.exact_search(tidx, q, 10,
                                attr_filter=hybrid.compile_filter(pred))
    assert float(search.recall_at_k(res, exact, 10)) == 1.0
