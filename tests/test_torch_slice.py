"""The port's resident slice as a whole against the JAX package.

1. An index built by repro.core.ivf.build_index is carried over with
   repro_torch.convert.index_from_arrays; the same QuerySpecs then run
   through repro.core.executor.run and the port's executor.run (knn at
   Q in {1, 5, 16}, exact, a post-filter predicate, after an upsert and a
   delete into the delta), for l2, ip and cosine, float32 and int8.
2. A database written by repro.storage.MicroNN is recovered by the port's
   MicroNN and answers the same queries.
3. The port's own build from the same rows and seed is held to the JAX
   build's recall and, at a measured floor, its partition assignment.
4. The port imports neither jax nor repro, and without a GPU its engine
   (resident or paged) refuses the default device.

Tolerance: scores within 1e-5 * (||q||^2 + max ||v||^2) per query (float32
sums in different orders; see repro_torch.testing), ids equal row by row
except inside runs of reference scores tied within that tolerance.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import executor as jexecutor
from repro.core import ivf as jivf
from repro.core import query as jquery
from repro.core.hybrid import Pred as JPred
from repro.core.types import IVFConfig as JConfig
from repro.storage.engine import MicroNN as JMicroNN
from repro_torch import convert
from repro_torch.core import delta, executor, ivf, query
from repro_torch.core.hybrid import Pred
from repro_torch.core.types import IVFConfig
from repro_torch.storage.engine import MicroNN
from repro_torch.testing import compare_topk, score_tol

DIM = 32
CFG = dict(dim=DIM, target_partition_size=50, minibatch_size=128,
           kmeans_iters=10, delta_capacity=256, rerank_factor=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run beside the JAX package's under xdist on shared
    cores; at their small sizes one intra-op thread is enough, and more
    only oversubscribe the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, DIM)).astype(np.float32) * 5.0
    X = (centers[rng.integers(0, 20, n)]
         + rng.normal(size=(n, DIM))).astype(np.float32)
    attrs = np.stack([rng.integers(0, 5, n), rng.random(n)],
                     axis=1).astype(np.float32)
    q = (X[rng.integers(0, n, 16)]
         + 0.3 * rng.normal(size=(16, DIM))).astype(np.float32)
    return X, attrs, q


def jax_arrays(idx):
    """Leaves of a JAX IVFIndex as numpy arrays (the convert contract)."""
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


def _convert(jidx):
    return convert.index_from_arrays(
        jax_arrays(jidx), dataclasses.asdict(jidx.config), "cpu")


_BUILDS = {}


def _jax_index(metric, tier):
    key = (metric, tier)
    if key not in _BUILDS:
        X, attrs, q = _data()
        cfg = JConfig(metric=metric, quantize=tier, **CFG)
        _BUILDS[key] = (jivf.build_index(X, attrs=attrs, cfg=cfg), X, attrs,
                        q)
    return _BUILDS[key]


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _assert_same(jres, tres, q, X, metric):
    qn = _unit(q) if metric == "cosine" else q
    v2 = 1.0 if metric == "cosine" else float(np.sum(X * X, -1).max())
    err, ok, bad = compare_topk(np.asarray(jres.scores), np.asarray(jres.ids),
                                tres.to_numpy()[1], tres.to_numpy()[0],
                                score_tol(qn, v2))
    assert ok, f"{bad} query rows differ (max score err {err:.3e})"


def _both(jidx, tidx, q, jspec, tspec, X, metric):
    jres = jexecutor.run(jidx, jnp.asarray(q), jspec)
    tres = executor.run(tidx, q, tspec)
    _assert_same(jres, tres, q, X, metric)
    return jres, tres


_KNN_CASES = [("l2", t, n) for t in ("none", "int8") for n in (1, 5, 16)] \
    + [(m, t, 5) for m in ("ip", "cosine") for t in ("none", "int8")]


@pytest.mark.parametrize("metric,tier,n_q", _KNN_CASES)
def test_knn_matches_jax(metric, tier, n_q):
    jidx, X, _, q = _jax_index(metric, tier)
    tidx = _convert(jidx)
    _both(jidx, tidx, q[:n_q], jquery.Q.knn(k=10, n_probe=4),
          query.Q.knn(k=10, n_probe=4), X, metric)


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_exact_and_postfilter_match_jax(tier):
    jidx, X, attrs, q = _jax_index("l2", tier)
    tidx = _convert(jidx)
    _both(jidx, tidx, q[:6], jquery.Q.exact(k=10), query.Q.exact(k=10), X,
          "l2")
    jres, tres = _both(
        jidx, tidx, q[:12],
        jquery.Q.knn(k=10, n_probe=4).where(JPred(0, "==", 2)).postfilter(),
        query.Q.knn(k=10, n_probe=4).where(Pred(0, "==", 2)).postfilter(),
        X, "l2")
    got = tres.to_numpy()[0]
    assert (attrs[got[got >= 0], 0] == 2).all()


@pytest.mark.parametrize("metric,tier", [("l2", "int8"), ("cosine", "none")])
def test_delta_upsert_delete_match_jax(metric, tier):
    jidx, X, attrs, q = _jax_index(metric, tier)
    rng = np.random.default_rng(3)
    # 6 fresh rows near the queries + 4 overwrites of existing ids
    new_ids = np.array([5000, 5001, 5002, 5003, 5004, 5005, 7, 70, 700, 1500],
                       np.int32)
    vecs = np.concatenate([q[:6] + 0.05 * rng.normal(size=(6, DIM)),
                           X[rng.integers(0, 2000, 4)]]).astype(np.float32)
    new_attrs = rng.integers(0, 5, (10, 2)).astype(np.float32)
    dele = np.array([5001, 11, 12, int(np.argmin(((X - q[0]) ** 2).sum(1)))],
                    np.int32)
    j2 = jdelta.delete(jdelta.upsert(jidx, jnp.asarray(vecs),
                                     jnp.asarray(new_ids),
                                     jnp.asarray(new_attrs)),
                       jnp.asarray(dele))
    t2 = delta.delete(delta.upsert(_convert(jidx), torch.from_numpy(vecs),
                                   torch.from_numpy(new_ids),
                                   torch.from_numpy(new_attrs)),
                      torch.from_numpy(dele))
    t2c = _convert(j2)           # the delta leaves carried over directly
    assert torch.equal(t2.valid, t2c.valid)
    assert torch.equal(t2.delta.valid, t2c.delta.valid)
    assert t2.delta.count == t2c.delta.count == 10
    Xall = np.concatenate([X, vecs])
    for tidx in (t2, t2c):
        jres, tres = _both(j2, tidx, q[:8], jquery.Q.knn(k=10, n_probe=4),
                           query.Q.knn(k=10, n_probe=4), Xall, metric)
        got = tres.to_numpy()[0]
        assert not np.isin(got, dele).any()
        assert (got[:6, 0] == new_ids[:6])[np.arange(6) != 1].all()


def test_delta_only_ops_and_grow_layout_match_jax():
    jidx, X, attrs, q = _jax_index("cosine", "int8")
    tidx = _convert(jidx)
    vecs = (q[:5] * 3).astype(np.float32)
    ids = np.array([9000, 9001, 9002, 9000, 3], np.int32)   # a repeat
    a = np.ones((5, 2), np.float32)
    jd = jdelta.delta_only_delete(
        jdelta.delta_only_upsert(jidx.delta, jnp.asarray(vecs),
                                 jnp.asarray(ids), jnp.asarray(a), "cosine",
                                 jidx.qstats), jnp.asarray(ids[1:2]))
    td = delta.delta_only_delete(
        delta.delta_only_upsert(tidx.delta, torch.from_numpy(vecs),
                                torch.from_numpy(ids), torch.from_numpy(a),
                                "cosine", tidx.qstats),
        torch.from_numpy(ids[1:2]))
    assert td.count == int(jd.count) == 5
    np.testing.assert_array_equal(np.asarray(jd.valid), td.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jd.ids), td.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jd.codes), td.codes.numpy())
    np.testing.assert_allclose(np.asarray(jd.vectors), td.vectors.numpy(),
                               rtol=1e-6, atol=1e-7)
    jg = jivf.grow_layout(jidx, jidx.p_max + 8)
    tg = ivf.grow_layout(tidx, tidx.p_max + 8)
    assert tg.p_max == jg.p_max
    for name in ("vectors", "ids", "attrs", "valid", "codes"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(tg, name).numpy())
    np.testing.assert_allclose(np.asarray(jg.code_norms),
                               tg.code_norms.numpy(), rtol=1e-6)


def test_coalesced_equals_solo():
    jidx, X, _, q = _jax_index("l2", "int8")
    tidx = _convert(jidx)
    spec = query.Q.knn(k=10, n_probe=4)
    parts = executor.run_coalesced(tidx, [q[:3], q[3:4], q[4:9]], spec)
    for part, chunk in zip(parts, (q[:3], q[3:4], q[4:9])):
        solo = executor.run(tidx, chunk, spec)
        assert torch.equal(part.ids, solo.ids)
        assert torch.equal(part.scores, solo.scores)


@pytest.mark.parametrize("kind", ["ann", "exact", "prefilter"])
@pytest.mark.parametrize("tier", ["none", "int8"])
def test_search_shim_matches_jax(tier, kind):
    """executor.search, the kwarg shim, against the reference's: the same
    kwargs build the same spec and the same answers."""
    from repro.core.hybrid import compile_filter as jcompile
    from repro_torch.core.hybrid import compile_filter
    jidx, X, attrs, q = _jax_index("l2", tier)
    tidx = _convert(jidx)
    kw = dict(k=10, kind=kind, n_probe=4)
    jkw, tkw = dict(kw), dict(kw)
    if kind == "prefilter":
        jkw.update(cap=512, attr_filter=jcompile(JPred(0, "==", 2.0)))
        tkw.update(cap=512, attr_filter=compile_filter(Pred(0, "==", 2.0)))
    jres = jexecutor.search(jidx, jnp.asarray(q), **jkw)
    tres = executor.search(tidx, q, **tkw)
    _assert_same(jres, tres, q, X, "l2")
    assert tres.spec == executor.search(tidx, q, **tkw).spec
    with pytest.raises(ValueError):
        executor.search(tidx, q, k=10, kind="prefilter")


def test_index_scan_topk_and_running_topk_init_match_jax():
    """ops.index_scan_topk (K1 over each query's probes, flattened with
    duplicates, no delta) and topk.running_topk_init against the
    reference's (its Pallas kernel in interpret mode on the CPU)."""
    from repro.core import topk as jtopk
    from repro.kernels import ops as jops
    from repro_torch.core import topk
    from repro_torch.kernels import ops
    jidx, X, _, q = _jax_index("l2", "none")
    tidx = _convert(jidx)
    js, ji = jops.index_scan_topk(jidx, jnp.asarray(q[:4]), 10, 3,
                                  interpret=True)
    ts, ti = ops.index_scan_topk(tidx, torch.as_tensor(q[:4]), 10, 3)
    err, ok, bad = compare_topk(
        np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy(),
        score_tol(q[:4], float(np.sum(X * X, -1).max())))
    assert ok, f"{bad} rows differ (max score err {err:.3e})"
    for shape, k in (((3,), 5), ((2, 4), 7), ((), 3)):
        js, ji = jtopk.running_topk_init(shape, k)
        ts, ti = topk.running_topk_init(shape, k)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ts.dtype == torch.float32 and ti.dtype == torch.int32


def test_oversize_scan_k_is_refused_by_name(tmp_path):
    """A spec whose scan would keep more than executor.MAX_SCAN_K
    candidates per query raises the named ValueError before planning, on
    the CPU as on the card: k itself on the float32 tier, k *
    rerank_factor on the int8 tier, resident and paged."""
    limit = executor.MAX_SCAN_K
    f32 = _convert(_jax_index("l2", "none")[0])
    i8 = _convert(_jax_index("l2", "int8")[0])
    q = _data()[2][:2]
    msg = f"exceeds MAX_SCAN_K={limit}"
    with pytest.raises(ValueError, match=msg):
        executor.run(f32, q, query.Q.knn(k=limit + 1))
    with pytest.raises(ValueError, match=f"k_scan={limit + 1} " + msg):
        executor.run(f32, q, query.Q.exact(k=limit + 1))
    rf = i8.config.rerank_factor
    k = limit // rf + 1
    with pytest.raises(ValueError, match=f"k_scan={k * rf} " + msg):
        executor.run(i8, q, query.Q.knn(k=k))
    # the float32 tier of the same index keeps k candidates: not refused
    assert executor.run(i8, q, query.Q.knn(k=k).quantized(False)).k <= k
    X, attrs, _ = _data(n=400)
    eng = MicroNN(dim=DIM, path=str(tmp_path / "k.db"), device="cpu",
                  config=IVFConfig(quantize="int8", **CFG),
                  memory_budget_mb=0.2)
    eng.upsert(np.arange(len(X)), X)
    eng.build()
    with pytest.raises(ValueError, match=msg):
        eng.query(q, query.Q.knn(k=k))
    with pytest.raises(ValueError, match=msg):
        eng.query(q, query.Q.exact(k=k))
    eng.close()


def test_backend_names_follow_the_device():
    jidx, X, _, q = _jax_index("l2", "none")
    tidx = _convert(jidx)
    executor.run(tidx, q[:2], query.Q.knn(k=5).backend("torch"))
    with pytest.raises(ValueError):
        executor.run(tidx, q[:2], query.Q.knn(k=5).backend("cuda"))
    # an unresolved hybrid="auto" runs the fused post-filter, as in JAX
    _both(jidx, tidx, q[:2], jquery.Q.knn(k=5).where(JPred(0, "<", 2)),
          query.Q.knn(k=5).where(Pred(0, "<", 2)), X, "l2")


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_recover_jax_written_db(tmp_path, tier):
    X, attrs, q = _data(n=1500, seed=4)
    path = str(tmp_path / "jax.db")
    cfg = JConfig(quantize=tier, **CFG)
    jeng = JMicroNN(dim=DIM, n_attr=2, path=path, config=cfg)
    jeng.upsert(np.arange(1500), X, attrs)
    jeng.build()
    jeng.upsert(np.array([9000, 9001, 3]), q[:3] + 0.01, attrs[:3])
    jeng.delete(np.array([4, 9001]))
    teng = MicroNN(dim=DIM, n_attr=2, path=path, config=IVFConfig(
        quantize=tier, **CFG), device="cpu")
    teng.recover()
    for spec_j, spec_t in (
            (jquery.Q.knn(k=10, n_probe=4), query.Q.knn(k=10, n_probe=4)),
            (jquery.Q.exact(k=10), query.Q.exact(k=10))):
        jres = jeng.query(q[:8], spec_j)
        tres = teng.query(q[:8], spec_t)
        _assert_same(jres, tres, q[:8], np.concatenate([X, q[:3]]), "l2")
    assert teng.stats()["resident_bytes"] > 0
    # coalesced chunks come back split, each equal to its solo query, with
    # the result rows' attributes gathered from the durable tier
    spec = query.Q.knn(k=10, n_probe=4).with_attrs()
    expect = attrs.copy()
    expect[3] = attrs[2]                   # id 3 was upserted with attrs[2]
    parts = teng.query_batched([q[:3], q[3:8]], spec)
    for part, chunk in zip(parts, (q[:3], q[3:8])):
        solo = teng.query(chunk, spec)
        np.testing.assert_array_equal(part.to_numpy()[0], solo.to_numpy()[0])
        ids = part.to_numpy()[0]
        mine = (ids >= 0) & (ids < 1500)
        np.testing.assert_array_equal(part.attrs[mine], expect[ids[mine]])
    jeng.store.close()
    teng.close()


def test_sessions_and_flush_match_jax(tmp_path):
    # 40 session upserts into a 16-row delta force flushes mid-commit;
    # exact queries (independent of the clustering) must agree with the
    # JAX engine fed the same writes, and again after recover()
    X, attrs, q = _data(n=1000, seed=6)
    rng = np.random.default_rng(7)
    new_ids = np.arange(2000, 2040)
    new_vecs = (q[np.arange(40) % 16]
                + 0.2 * rng.normal(size=(40, DIM))).astype(np.float32)
    cfg = dict(CFG, delta_capacity=16)
    engines = []
    for make, conf, path in (
            (JMicroNN, JConfig(**cfg), tmp_path / "j.db"),
            (MicroNN, IVFConfig(**cfg), tmp_path / "t.db")):
        kw = {} if make is JMicroNN else {"device": "cpu"}
        eng = make(dim=DIM, n_attr=2, path=str(path), config=conf, **kw)
        eng.upsert(np.arange(1000), X, attrs)
        eng.build()
        with eng.session() as s:
            s.upsert(new_ids, new_vecs)
            s.delete(np.array([5, 6, 2001]))
            s.upsert(np.array([7]), q[:1] + 0.01)      # last write wins
        with pytest.raises(KeyError):
            with eng.session() as s:               # discarded: nothing lands
                s.upsert(np.array([3000]), q[:1])
                raise KeyError("abort")
        engines.append(eng)
    jeng, teng = engines
    # some session rows were flushed into the main partitions on the way
    assert np.isin(new_ids, teng.index.ids.numpy()).any()
    Xall = np.concatenate([X, new_vecs, q[:1] + 0.01])
    jres = jeng.query(q, jquery.Q.exact(k=10))
    tres = teng.query(q, query.Q.exact(k=10))
    _assert_same(jres, tres, q, Xall, "l2")
    got = tres.to_numpy()[0]
    assert not np.isin(got, [5, 6, 2001, 3000]).any()
    assert got[0, 0] == 7
    trec = MicroNN(dim=DIM, n_attr=2, path=str(tmp_path / "t.db"),
                   config=IVFConfig(**cfg), device="cpu")
    trec.recover()
    _assert_same(jres, trec.query(q, query.Q.exact(k=10)), q, Xall, "l2")
    trec.close()
    jeng.store.close()
    teng.close()


def _assignment(ids, valid):
    ids, valid = np.asarray(ids), np.asarray(valid)
    parts = np.broadcast_to(np.arange(ids.shape[0])[:, None], ids.shape)
    out = np.full(ids.max() + 1, -1)
    out[ids[valid]] = parts[valid]
    return out


def _recall(ids, gt):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                    for a, b in zip(ids, gt)])


def test_port_build_matches_jax_build_quality():
    X, attrs, _ = _data(n=2000, seed=9)
    rng = np.random.default_rng(10)
    q = (X[rng.integers(0, 2000, 40)]
         + 0.3 * rng.normal(size=(40, DIM))).astype(np.float32)
    cfg = dict(CFG, kmeans_iters=20)
    jidx = jivf.build_index(X, attrs=attrs, cfg=JConfig(**cfg))
    tidx = ivf.build_index(X, attrs=attrs, cfg=IVFConfig(**cfg),
                           device="cpu")
    assert tidx.k == jidx.k
    d2 = (X * X).sum(1)[None, :] - 2 * q @ X.T
    gt = np.argsort(d2, axis=1)[:, :10]
    rj = _recall(np.asarray(jexecutor.run(
        jidx, jnp.asarray(q), jquery.Q.knn(k=10, n_probe=4)).ids), gt)
    rt = _recall(executor.run(tidx, q, query.Q.knn(k=10, n_probe=4))
                 .to_numpy()[0], gt)
    assert abs(rj - rt) <= 0.02, (rj, rt)
    # same seed rows, same mini-batches: partitions are comparable by id.
    # The sequential balanced arg-min does not promise bitwise centroids
    # (one float flip reorders every later choice), so agreement is held
    # at a floor: 1.000 measured on this data (and on seeds 1 and 2, with
    # centroids within 4e-6), floor 0.99.
    agree = np.mean(_assignment(jidx.ids, jidx.valid)
                    == _assignment(tidx.ids.numpy(), tidx.valid.numpy()))
    assert agree >= 0.99, agree


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = {'repro_torch.obs.metrics', 'repro_torch.obs.trace', "
        "'repro_torch.obs.recorder', 'repro_torch.obs.http', "
        "'repro_torch.serving.frontdoor', 'repro_torch.fleet.manager', "
        "'repro_torch.distributed.sharded_index', "
        "'repro_torch.models.decode', 'repro_torch.core.rag', "
        "'repro_torch.serving.engine', 'repro_torch.launch.serve', "
        "'repro_torch.models.moe', 'repro_torch.models.recurrent', "
        "'repro_torch.models.xlstm', 'repro_torch.configs.inputs', "
        "'repro_torch.train.optim', 'repro_torch.train.trainer', "
        "'repro_torch.storage.checkpoint', 'repro_torch.launch.train'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_engine_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        MicroNN(dim=DIM)
    # paged mode needs the card like the resident mode, and runs on the
    # CPU when asked
    with pytest.raises(RuntimeError, match="CUDA"):
        MicroNN(dim=DIM, memory_budget_mb=4)
    assert MicroNN(dim=DIM, device="cpu", memory_budget_mb=4).paged
