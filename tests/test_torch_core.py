"""Module parity between the JAX package and the PyTorch port: top-k
selection and merging, the quantizer, predicates, the QuerySpec object
model and ResultSet merge/split. Inputs come from numpy with a seed and go
to both sides.

Top-k, predicates and codes involve no float arithmetic that could differ,
so they must match exactly; the tie order of equal scores is part of the
contract (lax.top_k returns ties in index order). Float results that sum
in a different order (the fold's beta, decode norms) agree within
1e-6 relative, a few float32 ulps.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as jhybrid
from repro.core import kmeans as jkmeans
from repro.core import quantize as jquantize
from repro.core import query as jquery
from repro.core import topk as jtopk
from repro.core.types import SearchResult as JSearchResult
from repro_torch.core import hybrid, ivf, kmeans, quantize, query, topk
from repro_torch.core.types import (DeltaStore, IVFConfig, QuantStats,
                                    SearchResult)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough, and more
    only oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tied_scores(seed, shape, levels=6):
    """Scores drawn from a few levels, so ties are everywhere."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, levels, size=shape).astype(np.float32)
    s[rng.random(shape) < 0.1] = np.finfo(np.float32).max
    return s


@pytest.mark.parametrize("k", [1, 5, 12])
def test_topk_smallest_pins_tie_order(k):
    s = _tied_scores(0, (7, 12))
    ids = np.random.default_rng(1).integers(0, 50, (7, 12)).astype(np.int32)
    js, ji = jtopk.topk_smallest(jnp.asarray(s), jnp.asarray(ids), k)
    ts, ti = topk.topk_smallest(_t(s), _t(ids), k)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_merge_topk_and_mask_scores_match():
    a, b = _tied_scores(2, (4, 8)), _tied_scores(3, (4, 6))
    ia = np.arange(32, dtype=np.int32).reshape(4, 8)
    ib = 100 + np.arange(24, dtype=np.int32).reshape(4, 6)
    js, ji = jtopk.merge_topk(jnp.asarray(a), jnp.asarray(ia),
                              jnp.asarray(b), jnp.asarray(ib), 9)
    ts, ti = topk.merge_topk(_t(a), _t(ia), _t(b), _t(ib), 9)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    valid = np.random.default_rng(4).random((4, 8)) < 0.5
    np.testing.assert_array_equal(
        np.asarray(jtopk.mask_scores(jnp.asarray(a), jnp.asarray(valid))),
        topk.mask_scores(_t(a), _t(valid)).numpy())


def test_dedup_by_id_matches():
    rng = np.random.default_rng(5)
    s = _tied_scores(6, (5, 10))
    ids = rng.integers(0, 6, (5, 10)).astype(np.int32)   # many duplicates
    ids[rng.random((5, 10)) < 0.2] = -1
    js, ji = jtopk.dedup_by_id(jnp.asarray(s), jnp.asarray(ids))
    ts, ti = topk.dedup_by_id(_t(s), _t(ids))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def _quant_inputs():
    rng = np.random.default_rng(7)
    X = (rng.normal(size=(300, 24)) * 3).astype(np.float32)
    X[:, 5] = 1.5                      # a constant column (MIN_SCALE)
    q = (rng.normal(size=(6, 24)) * 2).astype(np.float32)
    return X, q


def test_quantize_codes_bitwise():
    X, _ = _quant_inputs()
    jst = jquantize.train(jnp.asarray(X))
    tst = quantize.train(_t(X))
    np.testing.assert_array_equal(np.asarray(jst.lo), tst.lo.numpy())
    np.testing.assert_array_equal(np.asarray(jst.scale), tst.scale.numpy())
    # round half to even on both sides: codes equal bit for bit
    np.testing.assert_array_equal(
        np.asarray(jquantize.encode(jst, jnp.asarray(X))),
        quantize.encode(tst, _t(X)).numpy())
    np.testing.assert_array_equal(jquantize.encode_np(jst, X),
                                  quantize.encode_np(tst, X))
    codes = quantize.encode(tst, _t(X))
    np.testing.assert_allclose(
        np.asarray(jquantize.decode(jst, jnp.asarray(codes.numpy()))),
        quantize.decode(tst, codes).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jquantize.row_norms(jst, jnp.asarray(codes.numpy()))),
        quantize.row_norms(tst, codes).numpy(), rtol=1e-6)
    # the stats round-trip through host arrays is exact
    lo, scale = quantize.stats_to_arrays(tst)
    back = quantize.stats_from_arrays(lo, scale, device="cpu")
    assert torch.equal(back.lo, tst.lo) and torch.equal(back.scale, tst.scale)


def test_quantize_round_half_to_even():
    st = QuantStats(lo=torch.zeros(4), scale=torch.ones(4))
    x = torch.tensor([[0.5, 1.5, 2.5, 253.5]])
    jst = jquantize.QuantStats(lo=jnp.zeros(4), scale=jnp.ones(4))
    np.testing.assert_array_equal(
        quantize.encode(st, x).numpy(),
        np.asarray(jquantize.encode(jst, jnp.asarray(x.numpy()))))
    assert quantize.encode(st, x).tolist() == [[-128, -126, -126, 126]]


def test_fold_queries_matches():
    X, q = _quant_inputs()
    jst = jquantize.train(jnp.asarray(X))
    tst = quantize.train(_t(X))
    jq, ja, jb = jquantize.fold_queries(jst, jnp.asarray(q))
    tq, ta, tb = quantize.fold_queries(tst, _t(q))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    # beta carries q . lo, a float32 dot summed in another order
    np.testing.assert_allclose(np.asarray(jb), tb.numpy(), rtol=1e-6,
                               atol=1e-6 * float(np.abs(q).sum()))


_PREDS = [
    ("Pred(0,'<',2)", lambda m: m.Pred(0, "<", 2.0)),
    ("Pred(1,'>=',0.5)", lambda m: m.Pred(1, ">=", 0.5)),
    ("Pred(0,'!=',3)", lambda m: m.Pred(0, "!=", 3.0)),
    ("match", lambda m: m.Pred(2, "match", 5.0)),
    ("and/or", lambda m: m.Or((m.And((m.Pred(0, "==", 1.0),
                                      m.Pred(1, "<=", 0.3))),
                               m.Pred(2, "match", 2.0)))),
]


@pytest.mark.parametrize("name,build", _PREDS, ids=[p[0] for p in _PREDS])
def test_compile_filter_matches(name, build):
    rng = np.random.default_rng(8)
    attrs = np.stack([rng.integers(0, 5, 200).astype(np.float32),
                      rng.random(200).astype(np.float32),
                      rng.integers(0, 8, 200).astype(np.float32)], axis=1)
    jf = jhybrid.compile_filter(build(jhybrid))
    tf = hybrid.compile_filter(build(hybrid))
    np.testing.assert_array_equal(np.asarray(jf(jnp.asarray(attrs))),
                                  tf(_t(attrs)).numpy())
    # memoised: an equal tree yields the same callable object
    assert hybrid.compile_filter(build(hybrid)) is tf
    assert tf.predicate == build(hybrid)


def test_query_spec_hashing_and_equality():
    P = hybrid.Pred
    a = query.Q.knn(k=20).probe(4).where(P(0, "==", 3)).where(P(1, "<", 2))
    b = query.Q.knn(k=20, n_probe=4).where(P(0, "eq", 3), P(1, "lt", 2))
    assert a == b and hash(a) == hash(b)
    assert a.predicate == hybrid.And((P(0, "eq", 3), P(1, "lt", 2)))
    assert a != a.quantized(False) and a.exact().kind == "exact"
    assert len({a, b, a.postfilter(), a.backend("torch")}) == 3
    # the same call chain on the JAX side yields the same field values
    JP = jhybrid.Pred
    ja = jquery.Q.knn(k=20).probe(4).where(JP(0, "==", 3)).where(JP(1, "<", 2))
    ta = dataclasses.asdict(a)
    jd = dataclasses.asdict(ja)
    assert {k: v for k, v in ta.items() if k != "predicate"} == \
        {k: v for k, v in jd.items() if k != "predicate"}
    assert hybrid._freeze(a.predicate) == jhybrid._freeze(ja.predicate)
    with pytest.raises(ValueError):
        query.QuerySpec(on_backend="pallas")
    with pytest.raises(TypeError):
        query.Q.knn().where(hybrid.compile_filter(P(0, "<", 1)),
                            lambda attrs: attrs[..., 0] > 0)


def _result_pair(seed, n_q=4, k=6, id_hi=15):
    rng = np.random.default_rng(seed)
    s = np.sort(rng.integers(0, 9, (n_q, k)).astype(np.float32), axis=1)
    ids = rng.integers(0, id_hi, (n_q, k)).astype(np.int32)
    return s, ids


def test_result_set_merge_matches():
    (sa, ia), (sb, ib) = _result_pair(10), _result_pair(11, k=5)
    jm = jquery.ResultSet.of(JSearchResult(ids=jnp.asarray(ia),
                                           scores=jnp.asarray(sa))).merge(
        jquery.ResultSet.of(JSearchResult(ids=jnp.asarray(ib),
                                          scores=jnp.asarray(sb))), k=7)
    tm = query.ResultSet.of(SearchResult(ids=_t(ia), scores=_t(sa))).merge(
        query.ResultSet.of(SearchResult(ids=_t(ib), scores=_t(sb))), k=7)
    np.testing.assert_array_equal(np.asarray(jm.ids), tm.to_numpy()[0])
    np.testing.assert_array_equal(np.asarray(jm.scores), tm.to_numpy()[1])


def test_result_set_split_and_iteration():
    s, ids = _result_pair(12, n_q=5)
    ids[0, 3:] = -1
    rs = query.ResultSet.of(SearchResult(ids=_t(ids), scores=_t(s)))
    parts = rs.split([2, 3])
    assert [p.num_queries for p in parts] == [2, 3]
    np.testing.assert_array_equal(parts[1].to_numpy()[0], ids[2:])
    assert len(rs[0]) == 3 and len(list(rs)) == 5
    with pytest.raises(ValueError):
        rs.split([2, 2])


@pytest.mark.parametrize("balanced", [False, True])
def test_final_assign_matches_jax(balanced):
    # unbalanced: the kmeans_assign kernel's plain version at penalty 0;
    # balanced: the sequential penalised arg-min (assign_minibatch)
    rng = np.random.default_rng(13)
    cents = (rng.normal(size=(40, 16)) * 3).astype(np.float32)
    batch = (cents[rng.integers(0, 40, 150)]
             + rng.normal(size=(150, 16))).astype(np.float32)
    counts = rng.integers(0, 30, 40).astype(np.float32)
    jc, ja = jkmeans.final_assign(jnp.asarray(cents), jnp.asarray(counts),
                                  jnp.asarray(batch), balance_weight=1.0,
                                  target_size=20, balanced=balanced)
    tc, ta = kmeans.final_assign(_t(cents), _t(counts), _t(batch),
                                 balance_weight=1.0, target_size=20,
                                 balanced=balanced)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


_X_SMALL = np.random.default_rng(14).normal(size=(60, 8)).astype(np.float32)
_CFG_SMALL = IVFConfig(dim=8, target_partition_size=20, kmeans_iters=2,
                       minibatch_size=16)
# each public function that places tensors, called with **kw -> the device
# its result lives on (None where it returns host arrays only)
_PLACERS = [
    ("build_index", lambda **kw: ivf.build_index(
        _X_SMALL, cfg=_CFG_SMALL, **kw).device),
    ("MiniBatchKMeans",
     lambda **kw: kmeans.MiniBatchKMeans(_CFG_SMALL, **kw).device),
    ("fit_in_memory",
     lambda **kw: kmeans.fit_in_memory(_X_SMALL, _CFG_SMALL, **kw) and None),
    ("stats_from_arrays", lambda **kw: quantize.stats_from_arrays(
        np.zeros(8, np.float32), np.ones(8, np.float32), **kw).lo.device),
    ("DeltaStore.empty",
     lambda **kw: DeltaStore.empty(4, 8, 1, **kw).vectors.device),
]


@pytest.mark.parametrize("name,place", _PLACERS, ids=[p[0] for p in _PLACERS])
def test_entry_points_default_to_the_card(name, place):
    # no device argument means the card: without one, resolve_device's
    # RuntimeError; an explicit device="cpu" still runs on the host
    if torch.cuda.is_available():
        assert getattr(place(), "type", "cuda") == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            place()
    assert getattr(place(device="cpu"), "type", "cpu") == "cpu"
