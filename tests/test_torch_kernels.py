"""The three kernels' plain PyTorch versions against the JAX package's
Pallas kernels, run in interpret mode on the CPU as tests/test_kernels.py
and tests/test_int8_scan.py run them. On CPU tensors the port's wrappers
take the plain versions, so these tests drive the same entry points the
executor and the build call.

Tolerance: scores agree within 1e-5 * (||q||^2 + max ||v||^2) per query
(repro_torch.testing): the two sides sum dot products in different
orders, and a fixed absolute bound fails on scores that cancel near zero.
Ids agree position by position except inside runs of reference scores
tied within that tolerance, where they are compared as sets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jquantize
from repro.core.hybrid import Pred as JPred
from repro.core.hybrid import compile_filter as jcompile
from repro.kernels import ops as jops
from repro.kernels import sq_scan as jsq
from repro_torch.core import quantize
from repro_torch.core.hybrid import Pred, compile_filter
from repro_torch.core.types import QuantStats
from repro_torch.kernels import common, ivf_scan, kmeans_assign, sq_scan
from repro_torch.testing import compare_topk, score_tol

MASKED = float(np.finfo(np.float32).max)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough, and more
    only oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed=0, kp=10, p_max=24, dim=32, n_q=5, n=4, p_valid=0.8):
    rng = np.random.default_rng(seed)
    vectors = (rng.normal(size=(kp, p_max, dim)) * 2).astype(np.float32)
    valid = rng.random((kp, p_max)) < p_valid
    ids = np.arange(kp * p_max, dtype=np.int32).reshape(kp, p_max)
    attrs = rng.integers(0, 4, size=(kp, p_max, 2)).astype(np.float32)
    queries = (vectors[rng.integers(0, kp, n_q), rng.integers(0, p_max, n_q)]
               + 0.1 * rng.normal(size=(n_q, dim))).astype(np.float32)
    part_ids = rng.choice(kp, n, replace=False).astype(np.int32)
    qsel = rng.random((n_q, n)) < 0.6
    qsel[:, 0] = True
    return dict(vectors=vectors, valid=valid, ids=ids, attrs=attrs,
                queries=queries, part_ids=part_ids, qsel=qsel)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tol(inp):
    v2 = float(np.sum(inp["vectors"] ** 2, axis=-1).max())
    return score_tol(inp["queries"], v2)


def _invalidate(s, i):
    """Score-based invalidation: the Pallas running merge re-emits an
    already-extracted id once its buffer runs out (ROADMAP Queue C); the
    port emits -1 there directly."""
    s, i = np.asarray(s), np.asarray(i)
    return s, np.where(s >= MASKED, -1, i)


def _assert_topk(ref, got, tol):
    err, ok, bad = compare_topk(*_invalidate(*ref), got[0].numpy(),
                                got[1].numpy(), tol)
    assert ok, f"{bad} rows differ (max score err {err:.3e})"


PRED = Pred(0, ">=", 2.0)
JPRED = JPred(0, ">=", 2.0)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("with_qsel", [False, True])
@pytest.mark.parametrize("with_keep", [False, True])
def test_ivf_scan_plain_matches_pallas(metric, with_qsel, with_keep):
    inp = _scan_inputs(seed=3)
    K = 8
    jf = jcompile(JPRED) if with_keep else None
    args = (jnp.asarray(inp["queries"]), jnp.asarray(inp["vectors"]),
            jnp.asarray(inp["valid"]), jnp.asarray(inp["ids"]),
            jnp.asarray(inp["part_ids"]))
    kw = dict(metric=metric, attrs=jnp.asarray(inp["attrs"]),
              attr_filter=jf, interpret=True)
    if with_qsel:
        ref = jops.scan_topk_mqo(*args, jnp.asarray(inp["qsel"]), K, **kw)
    else:
        ref = jops.scan_topk(*args, K, **kw)
    keep = compile_filter(PRED)(_t(inp["attrs"])) if with_keep else None
    got = ivf_scan.ivf_scan_topk(
        _t(inp["queries"]), _t(inp["vectors"]), _t(inp["valid"]),
        _t(inp["ids"]), _t(inp["part_ids"]), K, metric=metric,
        qsel=_t(inp["qsel"]) if with_qsel else None, keep=keep)
    _assert_topk(ref, got, _tol(inp))


@pytest.mark.parametrize("case", ["all_masked", "k_above_rows"])
def test_ivf_scan_exhausted_buffer(case):
    # fewer qualifying rows than k_out: the port fills (MASKED, -1); the
    # Pallas kernel's repeated ids are invalidated by score before compare
    inp = _scan_inputs(seed=5, p_valid=0.0 if case == "all_masked" else 0.1)
    K = 40
    ref = jops.scan_topk_mqo(
        jnp.asarray(inp["queries"]), jnp.asarray(inp["vectors"]),
        jnp.asarray(inp["valid"]), jnp.asarray(inp["ids"]),
        jnp.asarray(inp["part_ids"]), jnp.asarray(inp["qsel"]), K,
        interpret=True)
    got = ivf_scan.ivf_scan_topk(
        _t(inp["queries"]), _t(inp["vectors"]), _t(inp["valid"]),
        _t(inp["ids"]), _t(inp["part_ids"]), K, qsel=_t(inp["qsel"]))
    s, i = got[0].numpy(), got[1].numpy()
    assert ((i == -1) == (s >= MASKED)).all()
    real = i[i >= 0]
    for row in i:                       # never a repeated id
        r = row[row >= 0]
        assert len(set(r.tolist())) == len(r)
    if case == "all_masked":
        assert real.size == 0
    _assert_topk(ref, got, _tol(inp))


def _sq_inputs(seed, metric):
    inp = _scan_inputs(seed=seed, kp=12, p_max=16, dim=24, n_q=6, n=5)
    X = inp["vectors"].reshape(-1, inp["vectors"].shape[-1])
    jst = jquantize.train(jnp.asarray(X))
    codes = np.asarray(jquantize.encode(jst, jnp.asarray(inp["vectors"])))
    norms = np.asarray(jquantize.row_norms(jst, jnp.asarray(codes)))
    inp.update(codes=codes, norms=norms, lo=np.asarray(jst.lo),
               scale=np.asarray(jst.scale))
    return inp


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("with_norms", [True, False])
@pytest.mark.parametrize("with_qsel", [False, True])
def test_sq_scan_plain_matches_pallas(metric, with_norms, with_qsel):
    inp = _sq_inputs(seed=11, metric=metric)
    K = 30
    norms = inp["norms"] if with_norms else None
    qsel = inp["qsel"] if with_qsel else None
    ref = jsq.sq_scan_topk(
        jnp.asarray(inp["queries"]), jnp.asarray(inp["codes"]),
        jnp.asarray(inp["lo"]), jnp.asarray(inp["scale"]),
        jnp.asarray(inp["valid"]), jnp.asarray(inp["ids"]),
        jnp.asarray(inp["part_ids"]), K, metric=metric,
        qsel=None if qsel is None else jnp.asarray(qsel),
        norms=None if norms is None else jnp.asarray(norms),
        interpret=True)
    got = sq_scan.sq_scan_topk(
        _t(inp["queries"]), _t(inp["codes"]), _t(inp["lo"]),
        _t(inp["scale"]), _t(inp["valid"]), _t(inp["ids"]),
        _t(inp["part_ids"]), K, metric=metric,
        qsel=None if qsel is None else _t(qsel),
        norms=None if norms is None else _t(norms))
    # approximate (quantized) scores are of the same magnitude as the
    # float32 ones, so the same tolerance applies
    _assert_topk(ref, got, _tol(inp))


def test_sq_scan_keep_mask_and_flat_row_ids():
    # the post-filter mask and ids=None (flat row ids p * p_max + slot,
    # what the executor's rerank gathers) against the Pallas fused filter
    inp = _sq_inputs(seed=13, metric="l2")
    K = 20
    flat = np.arange(inp["ids"].size, dtype=np.int32).reshape(
        inp["ids"].shape)
    ref = jsq.sq_scan_topk(
        jnp.asarray(inp["queries"]), jnp.asarray(inp["codes"]),
        jnp.asarray(inp["lo"]), jnp.asarray(inp["scale"]),
        jnp.asarray(inp["valid"]), jnp.asarray(flat),
        jnp.asarray(inp["part_ids"]), K, qsel=jnp.asarray(inp["qsel"]),
        attrs=jnp.asarray(inp["attrs"]), attr_filter=jcompile(JPRED),
        norms=jnp.asarray(inp["norms"]), interpret=True)
    got = sq_scan.sq_scan_topk(
        _t(inp["queries"]), _t(inp["codes"]), _t(inp["lo"]),
        _t(inp["scale"]), _t(inp["valid"]), None, _t(inp["part_ids"]), K,
        qsel=_t(inp["qsel"]), keep=compile_filter(PRED)(_t(inp["attrs"])),
        norms=_t(inp["norms"]))
    _assert_topk(ref, got, _tol(inp))
    rows = got[1].numpy()
    assert (rows[rows >= 0] < inp["ids"].size).all()


def test_sq_scan_folded_accumulators_exact():
    # the plain version's integer-domain dots equal int32 accumulation
    # exactly (the contract the CUDA kernel's __dp4a path is held to)
    inp = _sq_inputs(seed=17, metric="l2")
    st = QuantStats(lo=_t(inp["lo"]), scale=_t(inp["scale"]))
    q_i8, alpha, beta = quantize.fold_queries(st, _t(inp["queries"]))
    flat = _t(inp["codes"]).reshape(-1, inp["codes"].shape[-1])
    from repro_torch.kernels.ref import int_domain_dots
    dots = int_domain_dots(q_i8, alpha, beta, flat)
    acc = q_i8.to(torch.int64) @ flat.to(torch.int64).T
    terms = alpha[:, None] * acc.to(torch.float32)
    n_q = beta.shape[0]
    want = terms[:n_q] + terms[n_q:] + beta[:, None]
    assert torch.equal(dots, want)


@pytest.mark.parametrize("balance_weight", [0.0, 1.0])
@pytest.mark.parametrize("k", [300, 97])
def test_kmeans_assign_plain_matches_pallas(balance_weight, k):
    # k not a multiple of the Pallas tile (256): its padded centroids get a
    # 1e18 penalty; the port bounds the ragged tile instead
    rng = np.random.default_rng(k)
    d = 16
    cents = (rng.normal(size=(k, d)) * 3).astype(np.float32)
    batch = (cents[rng.integers(0, k, 200)]
             + rng.normal(size=(200, d))).astype(np.float32)
    counts = rng.integers(0, 50, k).astype(np.float32)
    a_j, c_j = jops.assign_nearest(
        jnp.asarray(batch), jnp.asarray(cents), jnp.asarray(counts),
        balance_weight=balance_weight, target_size=20, scale=2.5,
        tile_k=256, interpret=True)
    a_t, c_t = kmeans_assign.kmeans_assign(
        _t(batch), _t(cents), _t(counts), balance_weight=balance_weight,
        target_size=20, scale=2.5)
    a_j, c_j = np.asarray(a_j), np.asarray(c_j)
    a_t, c_t = a_t.numpy(), c_t.numpy()
    tol = 1e-5 * (np.sum(batch ** 2, -1) + np.sum(cents ** 2, -1).max())
    assert (np.abs(c_j - c_t) <= tol).all()
    # a different arg-min only where the two centroids' exact costs tie
    # within the tolerance
    x64, c64 = batch.astype(np.float64), cents.astype(np.float64)
    pen = counts * (balance_weight * 2.5 / 20)
    cost = ((x64[:, None, :] - c64[None]) ** 2).sum(-1) + pen[None]
    rows = np.arange(len(batch))
    assert (np.abs(cost[rows, a_j] - cost[rows, a_t]) <= tol).all()


# The scan plan on an H100 (132 SMs): about two blocks per SM, shared out
# over each query's probe positions (or over groups of up to 8 queries
# without a selection). The main path's shapes: 8 probes at Q = 1 and 32,
# the exact scan of 10,000 partitions at Q = 8, 4,096 union positions at
# Q = 512.
@pytest.mark.parametrize("n_q,n,group,chunks", [
    (1, 8, 1, 8),            # one selected pair per block
    (8, 10000, 8, 264),      # exact, one group of 8 queries
    (8, 10000, 1, 33),       # exact without row sharing
    (32, 256, 1, 8),
    (512, 4096, 1, 1),       # one block per query: pass 2 is a copy
    (512, 10000, 8, 4),
    (1000, 50, 1, 1),        # more queries than blocks at once
    (3, 2, 4, 2),            # never more chunks than positions
])
def test_scan_plan_chunks(n_q, n, group, chunks):
    assert common.scan_plan(n_q, n, 568, 132, group) == chunks


@pytest.mark.parametrize("n_q,n,p_max", [
    (65536, 8, 568),                  # above the grid's y limit
    (1, 2 ** 31 // 568 + 1, 568),     # positions overflow int32
])
def test_scan_plan_limits(n_q, n, p_max):
    with pytest.raises(ValueError):
        common.scan_plan(n_q, n, p_max, 132)
    common.scan_plan(min(n_q, 65535), min(n, (2 ** 31 - 1) // p_max), p_max,
                     132)


@pytest.mark.parametrize("n_q,with_qsel,group", [
    (1, False, 1), (3, False, 4), (8, False, 8), (512, False, 8),
    (8, True, 1), (512, True, 1)])
def test_query_group(n_q, with_qsel, group):
    # rows are shared across queries only on the exact route (no qsel)
    qsel = np.ones((n_q, 4), bool) if with_qsel else None
    assert ivf_scan.query_group(n_q, qsel) == group
