"""The port's incremental maintenance (core/maintenance.py, core/monitor.py,
storage/scheduler.py, MicroNN.maintain / maintain_step) against the JAX
package, mirroring tests/test_maintenance.py and tests/test_updates.py.

The planners are host numpy copied from the reference, so they must give
the same plans bit for bit on the same rows; after the same maintenance
steps on the same database the port's durable state (partition of every
asset, centroids, csizes, drift) equals the JAX engine's, and the port's
resident and paged engines leave identical durable states. Scores that
cross a device product are compared with the usual tolerance.
"""
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import ivf as jivf
from repro.core import maintenance as jmaint
from repro.core import monitor as jmonitor
from repro.core.query import Q as JQ
from repro.core.types import IVFConfig as JConfig
from repro.storage.engine import MicroNN as JMicroNN
from repro_torch import convert
from repro_torch.core import delta, ivf, maintenance, monitor
from repro_torch.core.query import Q
from repro_torch.core.types import IVFConfig, pairwise_scores
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


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the host planners: bit for bit against the reference --------------------


@pytest.mark.parametrize("m", [5, 400])
def test_running_mean_update_matches_jax(m):
    rng = np.random.default_rng(m)
    k, d = 11, 24
    cent = rng.normal(size=(k, d)).astype(np.float32)
    csz = rng.integers(1, 200, k).astype(np.float32)
    dx = rng.normal(size=(m, d)).astype(np.float32)
    assign = rng.integers(0, k - 2, m)
    touched = np.unique(assign)
    out = []
    for mod in (maintenance, jmaint):
        c, s, dr = cent.copy(), csz.copy(), np.zeros(k, np.float32)
        mod.running_mean_update(c, s, dx, assign, touched, drift=dr)
        out.append((c, s, dr))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_two_means_and_neighborhood_match_jax():
    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.normal(size=(40, 8)),
                           rng.normal(size=(50, 8)) + 30.0]
                          ).astype(np.float32)
    (c, a), (jc, ja) = maintenance.two_means(rows), jmaint.two_means(rows)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(a, ja)
    assert len(np.unique(a[:40])) == 1 and a[0] != a[-1]
    ones = np.ones((16, 4), np.float32)
    assert (maintenance.two_means(ones)[1] == 0).all()
    cents = rng.normal(size=(30, 8)).astype(np.float32)
    counts = rng.integers(0, 60, 30)
    counts[[3, 9]] = 0
    for budget, extra in ((None, 4), (120, 6), (None, 0)):
        assert maintenance.neighborhood(cents, counts, [5], budget, extra) \
            == jmaint.neighborhood(cents, counts, [5], budget, extra)


def test_choose_merge_partner_best_fit_matches_jax():
    cents = np.zeros((4, 2), np.float32)
    cents[1], cents[2], cents[3] = (100, 0), (1, 0), (50, 0)
    cases = [(np.array([10, 80, 15, 0]), (), 1),
             (np.array([10, 80, 15, 0]), (1,), 2),
             (np.array([10, 15, 15, 0]), (), 2),
             (np.array([10, 95, 95, 0]), (), None)]
    for counts, excl, want in cases:
        got = maintenance.choose_merge_partner(cents, counts, 0, 100.0,
                                               exclude=excl)
        assert got == want
        assert got == jmaint.choose_merge_partner(cents, counts, 0, 100.0,
                                                  exclude=excl)
    # random sizes (many slack ties), duplicated centroids (distance ties)
    # and growing exclusion sets, as the monitor's merge loop passes them
    rng = np.random.default_rng(2)
    cents = rng.normal(size=(400, 8)).astype(np.float32)
    cents[200:260] = cents[100:160]
    counts = rng.integers(0, 90, 400)
    taken = set()
    for v in range(0, 400, 3):
        got = maintenance.choose_merge_partner(cents, counts, v, 100.0,
                                               exclude=taken)
        assert got == jmaint.choose_merge_partner(cents, counts, v, 100.0,
                                                  exclude=taken)
        if got is not None:
            taken.update((v, got, -1, 999))


def _fetcher(mod, layout):
    """A RowFetch of `mod` over a host layout {pid: (ids, vecs, attrs,
    codes)}, rows sorted by id."""
    def fetch(pids):
        out = {}
        for p in pids:
            ids, vecs, attrs, codes = layout[int(p)]
            o = np.argsort(ids, kind="stable")
            out[int(p)] = mod.RowBlock(ids=ids[o].astype(np.int32),
                                       vecs=vecs[o], attrs=attrs[o],
                                       codes=codes[o])
        return out
    return fetch


def _assert_plans_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.kind, a.new_pid, a.k_after) == (b.kind, b.new_pid, b.k_after)
    for name in ("pids", "row_ids", "row_vecs", "row_attrs", "row_codes",
                 "src", "assign", "centroids", "csizes"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def test_planners_match_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    k, d = 12, 8
    X = clustered(700, seed=4, dim=d)
    assign = rng.integers(0, k - 1, len(X))      # partition k-1 left empty
    layout = {p: (np.nonzero(assign == p)[0][::-1].copy(),
                  X[assign == p][::-1].copy(),
                  rng.random(((assign == p).sum(), 2)).astype(np.float32),
                  rng.integers(-128, 127, ((assign == p).sum(), d)
                               ).astype(np.int8)) for p in range(k)}
    counts = np.array([len(layout[p][0]) for p in range(k)])
    cents = np.stack([X[assign == p].mean(0) if counts[p] else
                      np.zeros(d, np.float32) for p in range(k)]
                     ).astype(np.float32)
    csz = counts.astype(np.float32)
    tf, jf = _fetcher(maintenance, layout), _fetcher(jmaint, layout)
    big = int(counts.argmax())
    for budget, n_local in ((None, 0), (None, 2), (150, 3)):
        _assert_plans_equal(
            maintenance.plan_split(cents, csz, counts, big, tf,
                                   row_budget=budget, n_local=n_local),
            jmaint.plan_split(cents, csz, counts, big, jf,
                              row_budget=budget, n_local=n_local))
        _assert_plans_equal(
            maintenance.plan_local_recluster(cents, csz, counts, 3, tf,
                                             row_budget=budget,
                                             n_local=n_local),
            jmaint.plan_local_recluster(cents, csz, counts, 3, jf,
                                        row_budget=budget, n_local=n_local))
    _assert_plans_equal(maintenance.plan_merge(cents, csz, counts, 2, 5, tf),
                        jmaint.plan_merge(cents, csz, counts, 2, 5, jf))
    plan = maintenance.plan_split(cents, csz, counts, big, tf)
    assert plan.new_pid == k - 1 and plan.pids[-1] == k - 1  # empty reused


# -- the monitor: work queue and blocked spacing ------------------------------


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


def _convert(jidx):
    import dataclasses
    return convert.index_from_arrays(
        _jax_arrays(jidx), dataclasses.asdict(jidx.config), "cpu")


def _churned_jax_index():
    """A JAX index with every work-queue signal: an overfull partition and
    a pending delta, a nearly emptied partition, tombstones and drift."""
    X = clustered(1200, seed=3)
    cfg = JConfig(dim=DIM, target_partition_size=40, kmeans_iters=15,
                  delta_capacity=128)
    idx = jivf.build_index(X, cfg=cfg)
    c0 = np.asarray(idx.centroids)[0]
    nv = (c0 + np.random.default_rng(0).normal(size=(60, DIM)) * 0.3
          ).astype(np.float32)
    idx = jdelta.upsert(idx, jnp.asarray(nv),
                        jnp.arange(9000, 9060, dtype=jnp.int32),
                        jnp.zeros((60, 0)))
    idx, _ = jmaint.flush_delta(idx, max_rows=50)
    counts = np.asarray(idx.counts)
    victim = int(np.argsort(counts)[len(counts) // 2])
    vids = np.asarray(idx.ids)[victim][np.asarray(idx.valid)[victim]]
    idx = jdelta.delete(idx, jnp.asarray(vids[:-4]))         # underfull
    p = int(np.argsort(counts)[-3])
    pv = np.asarray(idx.ids)[p][np.asarray(idx.valid)[p]]
    idx = jdelta.delete(idx, jnp.asarray(pv[: int(len(pv) * 0.45)]))
    drift = np.asarray(idx.drift).copy()
    drift[[4, 7]] = 1e6
    import dataclasses
    return dataclasses.replace(idx, drift=jnp.asarray(drift))


def test_work_queue_matches_jax():
    jidx = _churned_jax_index()
    tidx = _convert(jidx)
    jq = jmonitor.IndexMonitor().work_queue(jidx)
    tq = monitor.IndexMonitor().work_queue(tidx)
    assert {it.action for it in tq} == {"flush", "split", "merge",
                                        "recluster", "repack"}
    # same items in the same order; a recluster's priority divides by the
    # spacing, which agrees within float32 summation order
    assert [(it.action, it.pids, it.rows) for it in tq] == \
        [(it.action, it.pids, it.rows) for it in jq]
    for a, b in zip(tq, jq):
        assert a.priority == pytest.approx(b.priority, rel=1e-6)
    jh = jmonitor.IndexMonitor().check(jidx)
    th = monitor.IndexMonitor().check(tidx)
    assert (th.action, th.n_live) == (jh.action, jh.n_live)
    assert th.tombstone_fraction == pytest.approx(jh.tombstone_fraction)


@pytest.mark.parametrize("block_elems", [1 << 26, 3 * 7 * DIM])
def test_blocked_spacing_matches_reference(block_elems, monkeypatch):
    """The nearest-centroid spacing in row blocks (3 rows a block in the
    small case) equals the reference's [k, k, d] formula within 1e-6
    relative, and no block holds more than block_elems differences."""
    rng = np.random.default_rng(9)
    cents = (rng.normal(size=(40, DIM)) * 3).astype(np.float32)
    live = rng.random(40) < 0.8
    d2 = ((cents[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    d2[~live, :] = np.inf
    d2[:, ~live] = np.inf
    np.fill_diagonal(d2, np.inf)
    want = float(np.sqrt(d2.min(axis=1)[live]).mean())
    monkeypatch.setattr(monitor, "SPACING_BLOCK_ELEMS", block_elems)
    sizes = []
    real_sub = torch.Tensor.__sub__

    def sub(a, b):
        out = real_sub(a, b)
        sizes.append(out.numel())
        return out
    monkeypatch.setattr(torch.Tensor, "__sub__", sub)
    got = monitor.centroid_spacing(_t(cents), live)
    monkeypatch.undo()
    assert got == pytest.approx(want, rel=1e-6)
    assert max(sizes) <= max(block_elems, 40 * DIM)
    if block_elems < 40 * 40 * DIM:
        assert max(sizes) < 40 * 40 * DIM        # never [k, k, d]


# -- engines ---------------------------------------------------------------


def _engine(tmp_path, name="m.db", n=1200, quantize="none", n_attr=0,
            delta_cap=128, target=40, budget=None, max_rows=4096, mcfg=None):
    X = clustered(n, seed=3)
    cfg = IVFConfig(dim=DIM, target_partition_size=target, kmeans_iters=15,
                    delta_capacity=delta_cap, quantize=quantize)
    eng = MicroNN(dim=DIM, n_attr=n_attr, path=str(tmp_path / name),
                  config=cfg, memory_budget_mb=budget, device="cpu",
                  max_rows_per_step=max_rows, monitor=mcfg)
    attrs = np.ones((n, n_attr), np.float32) if n_attr else None
    eng.upsert(np.arange(n), X, attrs)
    eng.build()
    return eng, X


def _counts(eng):
    c = eng.index.counts
    return c.cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _cents(eng):
    return eng.index.centroids.cpu().numpy()


def test_work_queue_prioritizes_flush_then_split(tmp_path):
    eng, X = _engine(tmp_path, delta_cap=64)
    mon = eng.monitor
    assert all(it.action in ("split", "merge", "recluster")
               for it in mon.work_queue(eng.index))
    nv = (_cents(eng)[0] + np.random.default_rng(0).normal(size=(50, DIM))
          * 0.3).astype(np.float32)
    eng.upsert(np.arange(9000, 9050), nv)
    assert mon.work_queue(eng.index)[0].action == "flush"
    eng.maintain(force="flush")
    q = mon.work_queue(eng.index)
    big = int(_counts(eng).argmax())
    assert (q[0].action, q[0].pids, q[0].rows) == \
        ("split", (big,), int(_counts(eng)[big]))


def test_work_queue_merge_recluster_repack(tmp_path):
    import dataclasses
    eng, X = _engine(tmp_path)
    counts = _counts(eng)
    ids, valid = eng.index.ids.numpy(), eng.index.valid.numpy()
    p = int(np.argsort(counts)[-2])
    pv = ids[p][valid[p]]
    eng.delete(pv[: int(len(pv) * 0.45)])      # ~45 % tombstones
    drift = eng.index.drift.clone()
    drift[3] = 1e6
    eng.index = dataclasses.replace(eng.index, drift=drift)
    items = eng.monitor.work_queue(eng.index)
    assert any(i.action == "repack" and i.pids == (p,) for i in items)
    assert any(i.action == "recluster" and i.pids == (3,) for i in items)
    ia, pa, _ = eng.store.all_rows()
    reports = eng.maintain(until_idle=True)
    assert float(eng.index.drift[3]) == 0.0
    repacks = [r for r in reports if r.action == "repack"]
    assert repacks and all(r.bytes_written == 0 for r in repacks)
    if all(r.action == "repack" for r in reports):
        ib, pb, _ = eng.store.all_rows()        # no durable effect
        np.testing.assert_array_equal(pa, pb)
    ids, valid = eng.index.ids.numpy(), eng.index.valid.numpy()
    assert (((ids != -1) & ~valid).sum(-1) == 0).all()   # no tombstones
    live = ids[p][valid[p]]
    assert (np.diff(live) > 0).all()            # packed ascending by id
    assert eng.scheduler.pending() == []
    s = eng.stats()
    assert s["scheduler_depth"] == 0
    assert s["scheduler"]["steps"] == len(reports)
    assert s["scheduler"]["actions"]["repack"] == len(repacks)
    # a nearly emptied partition merges INTO a sibling under the split bar
    counts = _counts(eng)
    victim = int(counts.argmax())
    vids = ids[victim][valid[victim]]
    eng.delete(vids[: len(vids) - 5])
    it = next(i for i in eng.monitor.work_queue(eng.index)
              if i.action == "merge" and victim in i.pids)
    assert it.pids[1] == victim
    counts = _counts(eng)
    assert counts[it.pids[0]] + counts[it.pids[1]] <= \
        eng.monitor.cfg.split_threshold * eng.config.target_partition_size


def test_scheduler_respects_max_rows_per_step(tmp_path):
    eng, X = _engine(tmp_path, delta_cap=256, max_rows=64)
    rng = np.random.default_rng(7)
    nv = (_cents(eng)[0] + rng.normal(size=(200, DIM)) * 0.5
          ).astype(np.float32)
    eng.upsert(np.arange(9000, 9200), nv)
    reports = eng.maintain(until_idle=True)
    assert reports and all(r.rows <= 64 for r in reports)
    flushes = [r for r in reports if r.action == "flush"]
    assert len(flushes) >= 3 and sum(r.rows for r in flushes) == 200


@pytest.mark.parametrize("budget", [None, 0.05])
def test_queries_correct_between_steps(tmp_path, budget):
    eng, X = _engine(tmp_path, delta_cap=256, max_rows=120, budget=budget)
    rng = np.random.default_rng(11)
    nv = (X[rng.integers(0, len(X), 150)]
          + rng.normal(size=(150, DIM)).astype(np.float32) * 0.2)
    eng.upsert(np.arange(9000, 9150), nv)
    eng.delete(np.arange(0, 40))
    live = {**{i: X[i] for i in range(40, len(X))},
            **{9000 + j: nv[j] for j in range(150)}}
    ids_all = np.asarray(sorted(live))
    vecs_all = np.stack([live[i] for i in ids_all])
    steps = 0
    while True:
        q = np.stack([nv[steps % 150], X[500]])
        r = eng.query(q, Q.exact(k=3)).to_numpy()[0]
        d = pairwise_scores(_t(q), _t(vecs_all), "l2").numpy()
        gt = ids_all[np.argsort(d, axis=1)[:, :3]]
        np.testing.assert_array_equal(np.sort(r, 1), np.sort(gt, 1))
        rep = eng.maintain_step()
        if rep is None:
            break
        assert rep.rows <= 120
        steps += 1
        assert steps < 200, "scheduler failed to converge"
    assert steps > 0 and eng.scheduler.pending() == []
    assert _counts(eng).max() <= eng.monitor.cfg.split_threshold * 40


def test_split_reuses_empty_slot_before_appending(tmp_path):
    eng, X = _engine(tmp_path)
    counts = _counts(eng)
    victim = int(np.nonzero(counts > 0)[0][0])
    vids = eng.index.ids.numpy()[victim][eng.index.valid.numpy()[victim]]
    eng.delete(vids)
    assert _counts(eng)[victim] == 0
    c1 = _cents(eng)[int(_counts(eng).argmax())]
    nv = (c1 + np.random.default_rng(2).normal(size=(60, DIM)) * 0.3
          ).astype(np.float32)
    eng.upsert(np.arange(9000, 9060), nv)
    eng.maintain(force="flush")
    k0 = eng.index.k
    splits = [r for r in eng.maintain(until_idle=True)
              if r.action == "split"]
    assert splits and splits[0].pids[-1] == victim
    assert _counts(eng)[victim] > 0 and eng.index.k >= k0


# -- against the JAX engine: same steps, same durable state ------------------


def _durable(eng):
    ids, parts, _ = eng.store.all_rows()
    cents, csz = eng.store.centroids()
    base, drift = eng.store.maintenance_state()
    return ids, parts, cents, csz, drift


_WRITTEN = [("none", "l2"), ("int8", "l2"), ("none", "cosine"),
            ("int8", "cosine"), ("none", "ip"), ("int8", "ip")]


@pytest.fixture(params=_WRITTEN,
                ids=[t if m == "l2" else f"{t}-{m}" for t, m in _WRITTEN])
def jax_written(request, tmp_path):
    """The JAX resident engine and the port's resident and paged engines,
    each recovered from its own copy of one JAX-written database."""
    tier, metric = request.param
    X = clustered(1500, seed=8)
    kw = dict(dim=DIM, target_partition_size=50, kmeans_iters=15,
              delta_capacity=64, quantize=tier, rerank_factor=4,
              metric=metric)
    path = str(tmp_path / f"{tier}-{metric}.db")
    jeng = JMicroNN(dim=DIM, n_attr=1, path=path, config=JConfig(**kw))
    jeng.upsert(np.arange(len(X)), X, np.ones((len(X), 1), np.float32))
    jeng.build()
    jeng.store.db.commit()
    jeng.store.close()
    for suffix in (".jax", ".res", ".pag"):
        shutil.copy(path, path + suffix)
    jres = JMicroNN(dim=DIM, n_attr=1, path=path + ".jax",
                    config=JConfig(**kw))
    jres.recover()
    cfg = IVFConfig(**kw)
    res = MicroNN(dim=DIM, n_attr=1, path=path + ".res", config=cfg,
                  device="cpu")
    res.recover()
    pag = MicroNN(dim=DIM, n_attr=1, path=path + ".pag", config=cfg,
                  device="cpu", memory_budget_mb=0.05)
    pag.recover()
    yield jres, res, pag, X
    jres.store.close()
    res.close()
    pag.close()


def _close_rel(a, b, rtol=1e-6):
    """|a - b| <= rtol * max |b|: the cosine tolerance (normalisation
    reduces in torch's order, not XLA's, a last-bit difference)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= \
        rtol * max(np.abs(b).max(initial=0.0), 1e-30)


def test_maintenance_matches_jax_and_paged(jax_written):
    """Same churn on the JAX engine and the port's resident and paged ones:
    equal step lists, durable state and query ids. l2 and ip hold the
    centroids and drift bit for bit; cosine within 1e-6 relative."""
    jres, res, pag, X = jax_written
    metric = res.config.metric
    rng = np.random.default_rng(5)
    c0 = np.asarray(jres.index.centroids)[0]
    for wave in range(3):
        nv = (c0 + rng.normal(size=(60, DIM)) * 0.3).astype(np.float32)
        ids = np.arange(9000 + wave * 60, 9060 + wave * 60)
        dele = np.arange(wave * 100, wave * 100 + 60)
        for e in (jres, res, pag):
            e.upsert(ids, nv, np.ones((60, 1), np.float32))
            e.delete(dele)
        steps = [[(r.action, r.pids, r.rows) for r in e.maintain(
            until_idle=True)] for e in (jres, res, pag)]
        assert steps[1] == steps[0]                      # port == JAX
        assert [s for s in steps[1] if s[0] != "repack"] == steps[2]
    assert any(s.kind in ("split", "merge") for s in res.maintenance_log)
    want = _durable(jres)
    for eng in (res, pag):
        for i, (a, b) in enumerate(zip(_durable(eng), want)):
            if metric == "cosine" and i in (2, 4):      # centroids, drift
                _close_rel(a, b)
            else:
                np.testing.assert_array_equal(a, b)
    if metric == "cosine":
        _close_rel(_cents(res), np.asarray(jres.index.centroids))
        _close_rel(res.index.drift.numpy(), np.asarray(jres.index.drift))
    else:
        np.testing.assert_array_equal(_cents(res),
                                      np.asarray(jres.index.centroids))
    np.testing.assert_array_equal(_cents(res), _cents(pag))
    np.testing.assert_array_equal(_counts(res), _counts(pag))
    np.testing.assert_array_equal(res.index.drift.numpy(), pag.index.drift)
    # queries above the gather plan's batch size: bit for bit
    q = X[:16]
    a = res.query(q, Q.knn(k=10, n_probe=8)).to_numpy()
    b = pag.query(q, Q.knn(k=10, n_probe=8)).to_numpy()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    if metric != "l2":
        j = jres.query(q, JQ.knn(k=10, n_probe=8))
        np.testing.assert_array_equal(a[0], np.asarray(j.ids))


@pytest.mark.parametrize("budget", [None, 0.05])
def test_crash_between_codes_and_swap_serves_old_generation(tmp_path,
                                                           budget):
    X = clustered(900, seed=4)
    cfg = IVFConfig(dim=DIM, target_partition_size=40, kmeans_iters=10,
                    delta_capacity=64, quantize="int8")
    path = str(tmp_path / "crash.db")
    eng = MicroNN(dim=DIM, path=path, config=cfg, memory_budget_mb=budget,
                  device="cpu")
    eng.upsert(np.arange(len(X)), X)
    eng.build()
    nv = (_cents(eng)[0] + np.random.default_rng(1).normal(size=(50, DIM))
          * 0.3).astype(np.float32)
    eng.upsert(np.arange(9000, 9050), nv)
    eng.maintain(force="flush")
    assert eng.scheduler.pending()
    gen = eng.store.generation
    eng.store.db.execute("PRAGMA wal_checkpoint(TRUNCATE)")
    shutil.copy(path, path + ".pre")
    pre = MicroNN(dim=DIM, path=path + ".pre", config=cfg,
                  memory_budget_mb=budget, device="cpu")
    pre.recover()
    q = X[:16]
    r_pre = pre.query(q, Q.knn(k=10)).to_numpy()

    def power_loss(*a, **k):
        raise RuntimeError("power loss")
    eng.store.apply_repair = power_loss
    with pytest.raises(RuntimeError):
        eng.maintain_step()
    assert eng.store.generation == gen
    eng.store.db.commit()
    eng.store.close()
    eng2 = MicroNN(dim=DIM, path=path, config=cfg, memory_budget_mb=budget,
                   device="cpu")
    eng2.recover()
    r_post = eng2.query(q, Q.knn(k=10)).to_numpy()
    np.testing.assert_array_equal(r_pre[0], r_post[0])
    np.testing.assert_array_equal(r_pre[1], r_post[1])
    eng2.maintain(until_idle=True)
    assert eng2.scheduler.pending() == []
    assert _counts(eng2).max() <= eng2.monitor.cfg.split_threshold * 40
    r = eng2.query(nv[:4], Q.knn(k=1)).to_numpy()[0]
    assert list(r[:, 0]) == [9000, 9001, 9002, 9003]
    pre.close()
    eng2.close()


def test_recover_restores_maintenance_signals(tmp_path):
    eng, X = _engine(tmp_path, name="persist.db", delta_cap=64)
    nv = (_cents(eng)[0] + np.random.default_rng(1).normal(size=(50, DIM))
          * 0.5).astype(np.float32)
    eng.upsert(np.arange(9100, 9150), nv)
    r = eng.maintain_step()
    assert r is not None and r.action == "flush"
    assert int(eng.index.delta.valid.sum()) == 0
    drift0 = eng.index.drift.numpy().copy()
    assert drift0.max() > 0
    eng2 = MicroNN(dim=DIM, path=str(tmp_path / "persist.db"),
                   config=eng.config, device="cpu")
    eng2.recover()
    np.testing.assert_allclose(eng2.index.drift.numpy(), drift0, rtol=1e-6)
    assert eng2.index.base_mean_size == pytest.approx(
        eng.index.base_mean_size)
    q1 = [(i.action, i.pids) for i in eng.monitor.work_queue(eng.index)]
    q2 = [(i.action, i.pids) for i in eng2.monitor.work_queue(eng2.index)]
    assert q1 == q2
    eng2.maintain(until_idle=True)
    assert eng2.scheduler.pending() == []
    eng2.close()


# -- whole-index decisions: flush / rebuild, forced and automatic ------------


@pytest.mark.parametrize("budget", [None, 0.05])
def test_rebuild_forced_and_automatic(tmp_path, budget):
    from repro_torch.kernels import ops
    mcfg = monitor.MonitorConfig(growth_rebuild_threshold=0.3)
    eng, X = _engine(tmp_path, delta_cap=512, budget=budget, mcfg=mcfg)
    assert eng.maintain() is None                  # healthy: no action
    rng = np.random.default_rng(13)
    nv = (X[rng.integers(0, len(X), 500)]
          + rng.normal(size=(500, DIM)).astype(np.float32) * 0.1)
    eng.upsert(np.arange(20000, 20500), nv)
    assert eng.maintain() == "flush"               # delta pressure
    assert int(eng.index.delta.valid.sum()) == 0
    assert eng.maintain() == "rebuild"             # 42 % growth > 30 %
    assert [s.kind for s in eng.maintenance_log][-1] == "full"
    assert eng.index.num_live() == 1700
    assert eng.maintain() is None
    # forced, with the assignment through the kmeans_assign entry point
    calls = []
    real = ops.assign_nearest

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    import repro_torch.core.kmeans as km
    km_assign = km.ops.assign_nearest
    km.ops.assign_nearest = spy
    try:
        assert eng.maintain(force="rebuild") == "rebuild"
    finally:
        km.ops.assign_nearest = km_assign
    assert calls
    ids, parts, _ = eng.store.all_rows()
    assert len(ids) == 1700 and (parts >= 0).all()
    r = eng.query(nv[:8], Q.knn(k=1, n_probe=8)).to_numpy()[0]
    assert list(r[:, 0]) == list(range(20000, 20008))
    eng2 = MicroNN(dim=DIM, path=str(tmp_path / "m.db"), config=eng.config,
                   device="cpu", memory_budget_mb=budget)
    eng2.recover()
    np.testing.assert_array_equal(
        eng2.query(nv[:16], Q.knn(k=5)).to_numpy()[0],
        eng.query(nv[:16], Q.knn(k=5)).to_numpy()[0])
    with pytest.raises(ValueError):
        eng.maintain(force="compact")
    with pytest.raises(ValueError):
        eng.maintain(force="flush", until_idle=True)
    eng2.close()


def test_daemon_drains_under_the_write_lock(tmp_path):
    eng, X = _engine(tmp_path, delta_cap=256)
    nv = (_cents(eng)[0] + np.random.default_rng(3).normal(size=(120, DIM))
          * 0.4).astype(np.float32)
    eng.upsert(np.arange(9000, 9120), nv)
    busy = threading.Event()
    busy.set()
    eng.scheduler.start_daemon(idle=lambda: not busy.is_set(),
                               interval_s=0.001)
    assert eng.stats()["daemon_alive"]
    time.sleep(0.05)
    busy.clear()
    eng.scheduler.kick()
    deadline = time.time() + 60
    while eng.scheduler.queue_depth() and time.time() < deadline:
        q = eng.query(nv[:2], Q.knn(k=1, n_probe=8)).to_numpy()[0]
        assert list(q[:, 0]) == [9000, 9001]
        time.sleep(0.01)
    s = eng.stats()
    assert s["scheduler_depth"] == 0 and s["daemon_steps"] > 0
    assert s["scheduler"]["busy_backoffs"] > 0 and s["daemon_alive"]
    eng.close()                                     # stops the daemon
    assert not eng.scheduler.daemon_alive


# -- streaming updates (tests/test_updates.py) against the JAX package --------


def _mk(delta_cap=128):
    X = clustered(1500, seed=7, dim=32)
    jcfg = JConfig(dim=32, target_partition_size=50, kmeans_iters=30,
                   delta_capacity=delta_cap)
    jidx = jivf.build_index(X, cfg=jcfg)
    return jidx, _convert(jidx), X


def test_flush_matches_jax_and_stays_searchable():
    jidx, tidx, X = _mk()
    rng = np.random.default_rng(2)
    nv = (rng.normal(size=(20, 32)) + 40.0).astype(np.float32)
    new = np.arange(9100, 9120, dtype=np.int32)
    j2 = jdelta.upsert(jidx, jnp.asarray(nv), jnp.asarray(new),
                       jnp.zeros((20, 0)))
    t2 = delta.upsert(tidx, _t(nv), _t(new), torch.zeros((20, 0)))
    j3, jst = jmaint.flush_delta(j2, max_rows=15)
    t3, tst = maintenance.flush_delta(t2, max_rows=15)
    assert (tst.rows_moved, tst.partitions_touched, tst.bytes_written) == \
        (jst.rows_moved, jst.partitions_touched, jst.bytes_written)
    for name in ("centroids", "csizes", "counts", "drift", "ids", "valid"):
        np.testing.assert_array_equal(getattr(t3, name).numpy(),
                                      np.asarray(getattr(j3, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t3.vectors.numpy(), np.asarray(j3.vectors))
    assert t3.delta.count == 5 and int(t3.delta.valid.sum()) == 5
    t4, _ = maintenance.flush_delta(t3)
    r = Q.knn(k=1, n_probe=t4.k)
    from repro_torch.core import executor
    ids = executor.run(t4, nv[:5], r).to_numpy()[0]
    assert list(ids[:, 0]) == list(range(9100, 9105))
    _, full = maintenance.full_rebuild(t2)
    assert tst.bytes_written < 0.25 * full.bytes_written


def test_apply_plan_and_repack_match_jax():
    jidx, tidx, X = _mk()
    counts = np.asarray(jidx.counts)
    big = int(counts.argmax())

    def fetch_of(mod, idx):
        vid, val = np.asarray(idx.ids), np.asarray(idx.valid)
        vec, vat = np.asarray(idx.vectors), np.asarray(idx.attrs)

        def fetch(pids):
            out = {}
            for p in pids:
                sel = np.nonzero(val[p])[0]
                o = np.argsort(vid[p][sel], kind="stable")
                out[int(p)] = mod.RowBlock(ids=vid[p][sel][o],
                                           vecs=vec[p][sel][o],
                                           attrs=vat[p][sel][o])
            return out
        return fetch
    cents, csz = np.asarray(jidx.centroids), np.asarray(jidx.csizes)
    jplan = jmaint.plan_split(cents, csz, counts, big,
                              fetch_of(jmaint, jidx), n_local=2)
    tplan = maintenance.plan_split(cents, csz, counts, big,
                                   fetch_of(maintenance, jidx), n_local=2)
    _assert_plans_equal(tplan, jplan)
    j2 = jmaint.apply_plan(jidx, jplan)
    t2 = maintenance.apply_plan(tidx, tplan)
    assert t2.k == j2.k == jplan.k_after
    for name in ("centroids", "csizes", "counts", "drift", "ids", "valid",
                 "vectors", "attrs"):
        np.testing.assert_array_equal(getattr(t2, name).numpy(),
                                      np.asarray(getattr(j2, name)),
                                      err_msg=name)
    # tombstones, then the device-only repack
    victim = int(np.asarray(j2.ids)[big][np.asarray(j2.valid)[big]][0])
    j3 = jmaint.repack_partition(
        jdelta.delete(j2, jnp.asarray([victim], jnp.int32)), big)
    t3 = maintenance.repack_partition(
        delta.delete(t2, torch.tensor([victim], dtype=torch.int32)), big)
    for name in ("ids", "valid", "vectors", "counts"):
        np.testing.assert_array_equal(getattr(t3, name).numpy(),
                                      np.asarray(getattr(j3, name)),
                                      err_msg=name)


def test_monitor_triggers_match_jax():
    jidx, tidx, X = _mk(delta_cap=64)
    jbig, tbig, _ = _mk(delta_cap=256)
    tm, jm = monitor.IndexMonitor(), jmonitor.IndexMonitor()
    assert tm.check(tidx).action == jm.check(jidx).action == "none"
    nv = np.random.default_rng(4).normal(size=(60, 32)).astype(np.float32)
    new = np.arange(9300, 9360, dtype=np.int32)
    t2 = delta.upsert(tidx, _t(nv), _t(new), torch.zeros((60, 0)))
    j2 = jdelta.upsert(jidx, jnp.asarray(nv), jnp.asarray(new),
                       jnp.zeros((60, 0)))
    assert tm.check(t2).action == jm.check(j2).action == "flush"
    mcfg = dict(growth_rebuild_threshold=0.1)
    cur_t, cur_j = tbig, jbig
    for b in range(4):
        nb = clustered(200, seed=10 + b, dim=32)
        nid = np.arange(10000 + 200 * b, 10200 + 200 * b, dtype=np.int32)
        cur_t, _ = maintenance.flush_delta(delta.upsert(
            cur_t, _t(nb), _t(nid), torch.zeros((200, 0))))
        cur_j, _ = jmaint.flush_delta(jdelta.upsert(
            cur_j, jnp.asarray(nb), jnp.asarray(nid), jnp.zeros((200, 0))))
    th = monitor.IndexMonitor(monitor.MonitorConfig(**mcfg)).check(cur_t)
    jh = jmonitor.IndexMonitor(jmonitor.MonitorConfig(**mcfg)).check(cur_j)
    assert th.action == jh.action == "rebuild"
    assert th.growth == pytest.approx(jh.growth)
    rebuilt, _ = maintenance.full_rebuild(cur_t)
    assert rebuilt.num_live() == cur_t.num_live()
    assert monitor.IndexMonitor().check(rebuilt).growth < 0.1


@pytest.mark.parametrize("tier", ["none", "int8"])
@pytest.mark.parametrize("budget", [None, 0.05], ids=["resident", "paged"])
def test_jax_recovers_port_written_file(tmp_path, budget, tier):
    """The other direction of "either engine recovers the other's file":
    the port builds, writes and drains a file; the JAX engine recovers it
    and answers with the port's ids, scores within 1e-5 * (||q||^2 +
    max ||v||^2)."""
    X = clustered(1500, seed=11)
    attrs = np.ones((len(X), 1), np.float32)
    kw = dict(dim=DIM, target_partition_size=50, kmeans_iters=15,
              delta_capacity=64, quantize=tier, rerank_factor=4)
    path = str(tmp_path / f"port-{tier}.db")
    eng = MicroNN(dim=DIM, n_attr=1, path=path, config=IVFConfig(**kw),
                  device="cpu", memory_budget_mb=budget)
    eng.upsert(np.arange(len(X)), X, attrs)
    eng.build()
    rng = np.random.default_rng(12)
    c0 = _cents(eng)[0]
    nv = (c0 + rng.normal(size=(120, DIM)) * 0.3).astype(np.float32)
    eng.upsert(np.arange(9000, 9120), nv, np.ones((120, 1), np.float32))
    eng.delete(np.arange(0, 90))
    assert eng.maintain(until_idle=True)
    assert eng.scheduler.pending() == []
    q = np.concatenate([X[200:208], nv[:8]]) + 0.01
    got = eng.query(q, Q.knn(k=10, n_probe=8))
    eng.close()
    jeng = JMicroNN(dim=DIM, n_attr=1, path=path, config=JConfig(**kw))
    jeng.recover()
    ref = jeng.query(q, JQ.knn(k=10, n_probe=8))
    allx = np.concatenate([X, nv])
    err, ok, bad = compare_topk(
        np.asarray(ref.scores), np.asarray(ref.ids), got.to_numpy()[1],
        got.to_numpy()[0], score_tol(q, float(np.sum(allx * allx, -1).max())))
    assert ok, f"{bad} rows differ (max score err {err:.3e})"
    np.testing.assert_array_equal(np.asarray(ref.ids), got.to_numpy()[0])
    jeng.store.close()
