"""The predicate program that the port's scan kernels evaluate per row
(core/hybrid.compile_program, kernels/csrc/pred_program.cuh), and the
small-Q gather plan (executor.plan_ann_gather), against the JAX package.

  * compile_program's plain evaluation (kernels/ref.eval_program) equals
    the port's eval_predicate and the JAX package's, op by op and on
    drawn trees; the instruction and depth limits raise;
  * the plain K1 / K2 with a program equal the Pallas kernels with attrs
    and attr_filter (interpret mode), and the port's own mask route;
  * the executor's post-filter batches (resident, paged) equal JAX's;
  * plan_ann_gather on the "torch" backend equals JAX's gather plan, and
    the "cuda" route keeps the union plan, whose ids still equal JAX's.

Tolerance: scores within 1e-5 * (||q||^2 + max ||v||^2), ids equal
outside runs of tied scores (repro_torch.testing); the port's program
route and mask route are compared exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import executor as jexecutor
from repro.core import hybrid as jhybrid
from repro.core import ivf as jivf
from repro.core import query as jquery
from repro.core.types import IVFConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import sq_scan as jsq
from repro.storage.engine import MicroNN as JMicroNN
from repro_torch import convert
from repro_torch.core import executor, hybrid, query
from repro_torch.core.types import IVFConfig
from repro_torch.kernels import ivf_scan, ref, sq_scan
from repro_torch.storage.engine import MicroNN
from repro_torch.testing import compare_topk, score_tol

DIM = 16
CFG = dict(dim=DIM, target_partition_size=50, kmeans_iters=15,
           delta_capacity=64, rerank_factor=4)
MASKED = float(np.finfo(np.float32).max)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mirror(node, mod):
    """The same tree built from another package's Pred / And / Or."""
    if isinstance(node, hybrid.Pred):
        return mod.Pred(node.col, node.op, node.value)
    kids = tuple(_mirror(c, mod) for c in node.children)
    return mod.And(kids) if isinstance(node, hybrid.And) else mod.Or(kids)


def _attr_rows(n=400, seed=0):
    """Attribute rows with the values the ops must get exactly right:
    integers 0-7 (also as tag bitsets), the float32 of 0.1 and of 0.3,
    ties at the comparison values, and uniform fractions."""
    rng = np.random.default_rng(seed)
    a = np.stack([rng.integers(0, 8, n).astype(np.float32),
                  rng.choice(np.array([0.1, 0.3, 0.5, 0.25], np.float32), n),
                  rng.random(n).astype(np.float32)], axis=1)
    return a


P, And, Or = hybrid.Pred, hybrid.And, hybrid.Or
TREES = [
    P(0, "<", 3), P(0, "<=", 3), P(0, ">", 3), P(0, ">=", 3),
    P(0, "==", 3), P(0, "!=", 3),
    # 0.1 is not a float32: the value is rounded to float32 once
    P(1, "==", 0.1), P(1, "!=", 0.1), P(1, "<", 0.1), P(1, "<=", 0.3),
    P(0, "match", 5), P(0, "match", 2), P(0, "match", 0),
    And((P(0, ">=", 2), P(2, "<", 0.5))),
    Or((P(0, "==", 1), P(1, "==", 0.25), P(2, ">", 0.9))),
    And((Or((P(0, "==", 1), P(0, "!=", 4))), P(2, "<", 0.7),
         Or((And((P(1, ">", 0.2), P(0, "match", 1))), P(2, ">=", 0.95))))),
    And((P(0, "<", 6),)),
]


@pytest.mark.parametrize("tree", TREES, ids=lambda t: repr(t)[:60])
def test_program_equals_eval_predicate_and_jax(tree):
    a = _attr_rows()
    prog = hybrid.compile_program(tree)
    got = ref.eval_program(prog, torch.from_numpy(a)).numpy()
    port = hybrid.eval_predicate(tree, torch.from_numpy(a)).numpy()
    jax_ = np.asarray(jhybrid.eval_predicate(_mirror(tree, jhybrid),
                                             jnp.asarray(a)))
    np.testing.assert_array_equal(got, port)
    np.testing.assert_array_equal(got, jax_)
    # memoised on the frozen tree, and carried by the compiled filter
    assert hybrid.compile_program(_mirror(tree, hybrid)) is prog
    assert hybrid.compile_filter(tree).program is prog


_leaf = st.builds(
    P, st.integers(0, 2),
    st.sampled_from(["lt", "le", "gt", "ge", "eq", "ne", "match"]),
    st.sampled_from([0.0, 1.0, 2.0, 3.0, 5.0, 0.1, 0.25, 0.3, 0.5, 0.75]))
_tree = st.recursive(
    _leaf, lambda kids: st.one_of(
        st.builds(And, st.lists(kids, min_size=1, max_size=4).map(tuple)),
        st.builds(Or, st.lists(kids, min_size=1, max_size=4).map(tuple))),
    max_leaves=12)


@settings(max_examples=60, deadline=None)
@given(_tree)
def test_drawn_programs_equal_eval_predicate_and_jax(tree):
    a = _attr_rows(n=64, seed=1)
    got = ref.eval_program(hybrid.compile_program(tree),
                           torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(
        got, hybrid.eval_predicate(tree, torch.from_numpy(a)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jhybrid.eval_predicate(_mirror(tree, jhybrid),
                                               jnp.asarray(a))))


def test_program_layout_and_limits():
    prog = hybrid.compile_program(And((P(1, "<", 0.1), P(0, "match", 6))))
    ops = hybrid.PROGRAM_OPS
    assert prog.code == (ops["lt"] | 1 << 8, ops["match"] | 0 << 8,
                         ops["and"] | 2 << 8)
    assert prog.word[0] == int(np.float32(0.1).view(np.uint32))
    assert prog.word[1] == 6 and prog.depth == 2 and prog.max_col == 1
    packed = prog.packed
    assert packed.dtype == np.uint32 and packed.shape == (129,)
    assert packed[0] == 3 and tuple(packed[1:4]) == prog.code
    assert tuple(packed[65:68]) == prog.word
    # 64 instructions fit, 65 do not (seven Ors of eight leaves: depth 14)
    ors = tuple(Or(tuple(P(0, "<", 8 * i + j) for j in range(8)))
                for i in range(7))
    fits = hybrid.compile_program(And(ors))
    assert len(fits) == 64 and fits.depth == 14
    with pytest.raises(ValueError, match="MAX_PROGRAM = 64"):
        hybrid.compile_program(And(ors + (P(1, ">", 0.5),)))
    # a node folds its results whenever FOLD_EVERY (8) are on the stack, so
    # a long IN-list stays shallow: 33 leaves, 4 folds and the last And
    flat = hybrid.compile_program(And(tuple(P(0, "<", i) for i in range(33))))
    assert len(flat) == 38 and flat.depth == 8
    a = torch.from_numpy(_attr_rows(n=64, seed=2))
    tree = Or(tuple(P(0, "==", i) for i in range(33)))
    np.testing.assert_array_equal(
        ref.eval_program(hybrid.compile_program(tree), a).numpy(),
        hybrid.eval_predicate(tree, a).numpy())
    # nesting still deepens it: each level leaves 7 results below its last
    # child, so five levels need a stack of 36
    deep = P(0, "<", 1)
    for lvl in range(5):
        deep = (And if lvl % 2 else Or)(
            tuple(P(0, ">", j) for j in range(7)) + (deep,))
    assert hybrid.compile_program(deep.children[-1]).depth == 29
    with pytest.raises(ValueError, match="MAX_DEPTH = 32"):
        hybrid.compile_program(deep)
    # a tree over either limit keeps its filter, without a program: the
    # scans take its keep mask
    for over in (deep, And(ors + (P(1, ">", 0.5),))):
        f = hybrid.compile_filter(over)
        assert f.program is None and f.predicate is over
        np.testing.assert_array_equal(
            f(a).numpy(), hybrid.eval_predicate(over, a).numpy())


# -- the plain scans with a program against the Pallas kernels ---------------


def _scan_inputs(seed=0, kp=10, p_max=24, dim=32, n_q=5, n=4, p_valid=0.8):
    rng = np.random.default_rng(seed)
    vectors = (rng.normal(size=(kp, p_max, dim)) * 2).astype(np.float32)
    valid = rng.random((kp, p_max)) < p_valid
    ids = np.arange(kp * p_max, dtype=np.int32).reshape(kp, p_max)
    attrs = np.stack([rng.integers(0, 4, (kp, p_max)),
                      rng.random((kp, p_max))], -1).astype(np.float32)
    queries = (vectors[rng.integers(0, kp, n_q), rng.integers(0, p_max, n_q)]
               + 0.1 * rng.normal(size=(n_q, dim))).astype(np.float32)
    part_ids = rng.choice(kp, n, replace=False).astype(np.int32)
    qsel = rng.random((n_q, n)) < 0.6
    qsel[:, 0] = True
    return dict(vectors=vectors, valid=valid, ids=ids, attrs=attrs,
                queries=queries, part_ids=part_ids, qsel=qsel)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_topk(ref_, got, inp):
    v2 = float(np.sum(inp["vectors"] ** 2, axis=-1).max())
    s, i = np.asarray(ref_[0]), np.asarray(ref_[1])
    i = np.where(s >= MASKED, -1, i)     # the Pallas merge's re-emits
    err, ok, bad = compare_topk(s, i, got[0].numpy(), got[1].numpy(),
                                score_tol(inp["queries"], v2))
    assert ok, f"{bad} rows differ (max score err {err:.3e})"


SCAN_PREDS = [P(1, "<", 0.3), P(0, "==", 3),
              And((P(0, "!=", 2), Or((P(1, ">=", 0.5), P(0, "<", 1)))))]


@pytest.mark.parametrize("pred", SCAN_PREDS, ids=["lt", "eq", "tree"])
@pytest.mark.parametrize("with_qsel", [False, True])
def test_ivf_scan_program_matches_pallas_and_mask(pred, with_qsel):
    inp = _scan_inputs(seed=3)
    K = 8
    args = (jnp.asarray(inp["queries"]), jnp.asarray(inp["vectors"]),
            jnp.asarray(inp["valid"]), jnp.asarray(inp["ids"]),
            jnp.asarray(inp["part_ids"]))
    kw = dict(attrs=jnp.asarray(inp["attrs"]),
              attr_filter=jhybrid.compile_filter(_mirror(pred, jhybrid)),
              interpret=True)
    if with_qsel:
        ref_ = jops.scan_topk_mqo(*args, jnp.asarray(inp["qsel"]), K, **kw)
    else:
        ref_ = jops.scan_topk(*args, K, **kw)
    f = hybrid.compile_filter(pred)
    common = (_t(inp["queries"]), _t(inp["vectors"]), _t(inp["valid"]),
              _t(inp["ids"]), _t(inp["part_ids"]), K)
    qsel = _t(inp["qsel"]) if with_qsel else None
    got = ivf_scan.ivf_scan_topk(*common, qsel=qsel,
                                 attrs=_t(inp["attrs"]), program=f.program)
    _assert_topk(ref_, got, inp)
    mask = ivf_scan.ivf_scan_topk(*common, qsel=qsel,
                                  keep=f(_t(inp["attrs"])))
    assert torch.equal(got[0], mask[0]) and torch.equal(got[1], mask[1])


@pytest.mark.parametrize("pred", SCAN_PREDS, ids=["lt", "eq", "tree"])
@pytest.mark.parametrize("with_norms", [True, False])
def test_sq_scan_program_matches_pallas_and_mask(pred, with_norms):
    from repro.core import quantize as jquantize
    inp = _scan_inputs(seed=11)
    jst = jquantize.train(jnp.asarray(inp["vectors"].reshape(-1, 32)))
    codes = np.asarray(jquantize.encode(jst, jnp.asarray(inp["vectors"])))
    norms = np.asarray(jquantize.row_norms(jst, jnp.asarray(codes))) \
        if with_norms else None
    K = 30
    ref_ = jsq.sq_scan_topk(
        jnp.asarray(inp["queries"]), jnp.asarray(codes),
        jst.lo, jst.scale, jnp.asarray(inp["valid"]),
        jnp.asarray(inp["ids"]), jnp.asarray(inp["part_ids"]), K,
        qsel=jnp.asarray(inp["qsel"]), attrs=jnp.asarray(inp["attrs"]),
        attr_filter=jhybrid.compile_filter(_mirror(pred, jhybrid)),
        norms=None if norms is None else jnp.asarray(norms),
        interpret=True)
    f = hybrid.compile_filter(pred)
    common = (_t(inp["queries"]), _t(codes), _t(np.asarray(jst.lo)),
              _t(np.asarray(jst.scale)), _t(inp["valid"]), _t(inp["ids"]),
              _t(inp["part_ids"]), K)
    kw = dict(qsel=_t(inp["qsel"]),
              norms=None if norms is None else _t(norms))
    got = sq_scan.sq_scan_topk(*common, attrs=_t(inp["attrs"]),
                               program=f.program, **kw)
    _assert_topk(ref_, got, inp)
    mask = sq_scan.sq_scan_topk(*common, keep=f(_t(inp["attrs"])), **kw)
    assert torch.equal(got[0], mask[0]) and torch.equal(got[1], mask[1])


def test_scan_filter_routes():
    a = torch.from_numpy(_attr_rows(n=24).reshape(2, 12, 3))
    f = hybrid.compile_filter(P(0, "<", 3))
    keep, attrs, prog = executor.scan_filter(f, a)
    assert keep is None and attrs is a and prog is f.program
    # an opaque callable has no program: its mask is the scan's input

    def opaque(x):
        return x[..., 2] > 0.5
    keep, attrs, prog = executor.scan_filter(opaque, a)
    assert prog is None and attrs is None
    assert torch.equal(keep, a[..., 2] > 0.5)
    assert executor.scan_filter(None, a) == (None, None, None)


def test_wrapper_checks_program_columns():
    inp = _scan_inputs(seed=4)
    prog = hybrid.compile_program(P(2, "<", 1.0))    # attrs has 2 columns
    from repro_torch.kernels import common
    with pytest.raises(ValueError, match="column 2 of 2"):
        common.program_args("ivf_scan", 10, 24, _t(inp["attrs"]), prog)
    with pytest.raises(ValueError, match="needs attrs"):
        common.program_args("ivf_scan", 10, 24, None, prog)


# -- the executor's filtered batches against the JAX package -----------------


def _data(n=1500, seed=8):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, DIM)).astype(np.float32) * 5.0
    X = (centers[rng.integers(0, 20, n)]
         + rng.normal(size=(n, DIM))).astype(np.float32)
    attrs = np.stack([rng.integers(0, 5, n), rng.random(n)],
                     axis=1).astype(np.float32)
    return X, attrs


@pytest.fixture(scope="module", params=["none", "int8"])
def engines(request, tmp_path_factory):
    """A JAX-written database, the JAX resident and paged engines over it,
    and the port's resident and paged engines recovered from it."""
    tier = request.param
    X, attrs = _data()
    path = str(tmp_path_factory.mktemp("pred") / f"{tier}.db")
    jcfg = JConfig(quantize=tier, **CFG)
    jeng = JMicroNN(dim=DIM, n_attr=2, path=path, config=jcfg)
    jeng.upsert(np.arange(len(X)), X, attrs)
    jeng.build()
    jpag = JMicroNN(dim=DIM, n_attr=2, path=path, config=jcfg,
                    memory_budget_mb=0.05)
    jpag.recover()
    tcfg = IVFConfig(quantize=tier, **CFG)
    tres = MicroNN(dim=DIM, n_attr=2, path=path, config=tcfg, device="cpu")
    tres.recover()
    tpag = MicroNN(dim=DIM, n_attr=2, path=path, config=tcfg, device="cpu",
                   memory_budget_mb=0.05)
    tpag.recover()
    yield jeng, jpag, tres, tpag, X
    for e in (jeng, jpag):
        e.store.close()
    tres.close()
    tpag.close()


def _close(jres, tres, q, X):
    v2 = float(np.sum(X * X, -1).max())
    err, ok, bad = compare_topk(np.asarray(jres.scores), np.asarray(jres.ids),
                                tres.to_numpy()[1], tres.to_numpy()[0],
                                score_tol(q, v2))
    assert ok, f"{bad} query rows differ (max score err {err:.3e})"


@pytest.mark.parametrize("pred,n_q", [(SCAN_PREDS[0], 4),
                                      (SCAN_PREDS[2], 16)],
                         ids=["lt-4", "tree-16"])
def test_postfilter_batches_match_jax(engines, pred, n_q):
    """Resident (4 queries: the gather plan; 16: the union plan's scans)
    and paged post-filter batches against the JAX engines. (The exact
    route with a program -- no qsel -- is held to the Pallas kernel by
    test_ivf_scan_program_matches_pallas_and_mask[False-*].)"""
    jeng, jpag, tres, tpag, X = engines
    q = X[300:300 + n_q] + 0.1
    jpred = _mirror(pred, jhybrid)
    spec = query.Q.knn(k=10, n_probe=6).where(pred).postfilter()
    jspec = jquery.Q.knn(k=10, n_probe=6).where(jpred).postfilter()
    _close(jeng.query(q, jspec), tres.query(q, spec), q, X)
    _close(jpag.query(q, jspec), tpag.query(q, spec), q, X)
    # paged == resident bit for bit on the program route where both take
    # the union plan (above 8 queries on the "torch" backend; the resident
    # engine's smaller batches take the gather plan, as JAX's do)
    a, b = tres.query(q, spec).to_numpy(), tpag.query(q, spec).to_numpy()
    np.testing.assert_array_equal(a[0], b[0])
    if n_q > executor.SMALL_Q_GATHER_MAX:
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("n_vals", [33, 70])
def test_in_list_queries_match_jax(engines, n_vals):
    """An IN-list (an Or of `eq` leaves) as a post-filter and through the
    optimizer, against the JAX engines: 33 values fit the program (the
    stack folds every 8), 70 exceed MAX_PROGRAM and take the keep-mask
    route; both answer as JAX does."""
    jeng, jpag, tres, tpag, X = engines
    vals = [1.0, 3.0] + [10.0 + i for i in range(n_vals - 2)]
    pred = Or(tuple(P(0, "==", v) for v in vals))
    assert (hybrid.compile_filter(pred).program is not None) == (n_vals < 64)
    q = X[500:516] + 0.1
    jpred = _mirror(pred, jhybrid)
    for spec, jspec in (
            (query.Q.knn(k=10, n_probe=6).where(pred).postfilter(),
             jquery.Q.knn(k=10, n_probe=6).where(jpred).postfilter()),
            (query.Q.knn(k=10, n_probe=6).where(pred),
             jquery.Q.knn(k=10, n_probe=6).where(jpred))):
        _close(jeng.query(q, jspec), tres.query(q, spec), q, X)
        _close(jpag.query(q, jspec), tpag.query(q, spec), q, X)


def test_postfilter_takes_the_program_route(engines, monkeypatch):
    """No whole-index mask: a tree predicate reaches the scan as a program
    over the attrs, an opaque callable as its mask."""
    _, _, tres, tpag, X = engines
    seen = []
    real = ivf_scan.ivf_scan_plain

    def spy(*a, **k):
        seen.append((k.get("keep") is None, k.get("program") is not None))
        return real(*a, **k)
    monkeypatch.setattr(ivf_scan, "ivf_scan_plain", spy)
    q = X[:16] + 0.1
    pred = P(0, "==", 3)
    tres.query(q, query.Q.exact(k=10).where(pred))
    assert seen == [(True, True)]
    seen.clear()
    f = hybrid.compile_filter(pred)
    tres.query(q, query.Q.exact(k=10).where(lambda a: f(a)))
    assert seen == [(False, False)]


# -- plan_ann_gather ----------------------------------------------------------


def _jax_arrays(idx):
    out = {name: np.asarray(getattr(idx, name)) for name in
           ("centroids", "csizes", "vectors", "ids", "attrs", "valid",
            "counts", "base_mean_size")}
    for name in ("vectors", "ids", "attrs", "valid", "count", "codes"):
        leaf = getattr(idx.delta, name)
        out[f"delta.{name}"] = None if leaf is None else np.asarray(leaf)
    for name in ("codes", "code_norms", "drift"):
        leaf = getattr(idx, name)
        out[name] = None if leaf is None else np.asarray(leaf)
    if idx.qstats is not None:
        out["qstats.lo"] = np.asarray(idx.qstats.lo)
        out["qstats.scale"] = np.asarray(idx.qstats.scale)
    return out


_GATHER = {}


def _gather_pair(tier, metric="l2"):
    key = (tier, metric)
    if key not in _GATHER:
        X, attrs = _data(n=2000, seed=0)
        jidx = jivf.build_index(X, attrs=attrs, cfg=JConfig(
            metric=metric, quantize=tier, **CFG))
        tidx = convert.index_from_arrays(
            _jax_arrays(jidx), dataclasses.asdict(jidx.config), "cpu")
        _GATHER[key] = (jidx, tidx, X)
    return _GATHER[key]


@pytest.mark.parametrize("n_q,pred", [(1, None), (5, P(0, "<", 2)),
                                       (8, None)], ids=["1", "5-pred", "8"])
@pytest.mark.parametrize("tier", ["none", "int8"])
def test_gather_plan_matches_jax(tier, n_q, pred):
    """The gather plan on both sides: the same per-query probe lists, and
    the JAX engine's jitted entry point (which takes its gather plan at
    these Q off the TPU) against the port's on the "torch" backend."""
    jidx, tidx, X = _gather_pair(tier)
    q = X[700:700 + n_q] + 0.2
    jf = None if pred is None else jhybrid.compile_filter(
        _mirror(pred, jhybrid))
    tf = None if pred is None else hybrid.compile_filter(pred)
    jplan = jexecutor.plan_ann_gather(jidx, jnp.asarray(q), 10, 4, jf)
    tplan = executor.plan_ann_gather(tidx, torch.from_numpy(q), 10, 4, tf)
    np.testing.assert_array_equal(np.asarray(jplan.parts_pq),
                                  tplan.parts_pq.numpy())
    jspec, tspec = jquery.Q.knn(k=10, n_probe=4), query.Q.knn(k=10,
                                                              n_probe=4)
    if pred is not None:
        jspec = jspec.where(_mirror(pred, jhybrid)).postfilter()
        tspec = tspec.where(pred).postfilter()
    jres = jexecutor.run(jidx, jnp.asarray(q), jspec)
    tres = executor.run(tidx, q, tspec)
    v2 = float(np.sum(X * X, -1).max())
    err, ok, bad = compare_topk(np.asarray(jres.scores), np.asarray(jres.ids),
                                tres.to_numpy()[1], tres.to_numpy()[0],
                                score_tol(q, v2))
    assert ok, f"{bad} rows differ (max score err {err:.3e})"


@pytest.mark.parametrize("n_q,tier", [(1, "int8"), (5, "none")])
def test_small_q_routing_follows_the_backend(tier, n_q, monkeypatch):
    """On the "torch" backend a bucketed batch of <= 8 queries takes the
    gather plan, as JAX's does off the Pallas path; the "cuda" backend
    keeps the union plan, whose ids also equal JAX's gather plan's."""
    jidx, tidx, X = _gather_pair(tier)
    q = X[900:900 + n_q] + 0.2
    spec = query.Q.knn(k=10, n_probe=4)
    jres = jexecutor.run(jidx, jnp.asarray(q), jquery.Q.knn(k=10, n_probe=4))
    kinds = []
    real = executor.execute_plan

    def spy(index, plan, **kw):
        kinds.append(plan.kind)
        return real(index, plan, **kw)
    monkeypatch.setattr(executor, "execute_plan", spy)
    got_torch = executor.run(tidx, q, spec)
    monkeypatch.setattr(executor, "_own_backend", lambda index: "cuda")
    got_cuda = executor.run(tidx, q, spec)
    assert kinds == ["ann_gather", "ann"]
    v2 = float(np.sum(X * X, -1).max())
    for got in (got_torch, got_cuda):
        err, ok, bad = compare_topk(
            np.asarray(jres.scores), np.asarray(jres.ids),
            got.to_numpy()[1], got.to_numpy()[0], score_tol(q, v2))
        assert ok, f"{bad} rows differ (max score err {err:.3e})"
    # a union cap, or more than 8 queries, keeps the union plan
    kinds.clear()
    monkeypatch.setattr(executor, "_own_backend", lambda index: "torch")
    executor.run(tidx, q, spec.union_cap(64))
    executor.run(tidx, X[:9], spec)
    assert kinds == ["ann", "ann"]
