"""The port's disk-resident (paged) mode: the store's batched readers, the
frame pool's contracts (budget, CLOCK order, pins, the scan ring, deferred
release, staging, thread interleaving, in-place fault writes), and the
paged engine against the JAX paged engine on a JAX-written database,
against the port's own resident engine on the same file, and through
flush, upsert and delete.

Paged == resident is exact on the CPU (ids and scores bit for bit): the
probe union, the chunked scans and the rerank go through the same ops in
the same order. Against the JAX package the usual tolerance holds: scores
within 1e-5 * (||q||^2 + max ||v||^2), ids row by row except inside runs
of scores tied within it (repro_torch.testing).
"""
import threading

import numpy as np
import pytest
import torch

from repro.core.types import IVFConfig as JConfig
from repro.storage.engine import MicroNN as JMicroNN
from repro_torch.core import executor, quantize
from repro_torch.core.hybrid import Pred
from repro_torch.core.query import Q
from repro_torch.core.types import IVFConfig
from repro_torch.fleet.pool import FramePool, compute_frame_bytes
from repro_torch.storage.engine import MicroNN
from repro_torch.storage.pager import PartitionCache
from repro_torch.storage.store import VectorStore
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


def _mk_store(tmp_path, name="p.db", n=200, d=8, k=10, n_attr=0, seed=0):
    """A store with a hand-made clustering: n rows over k partitions."""
    rng = np.random.default_rng(seed)
    st = VectorStore(str(tmp_path / name), dim=d, n_attr=n_attr)
    X = rng.normal(size=(n, d)).astype(np.float32)
    attrs = rng.integers(0, 4, (n, n_attr)).astype(np.float32) \
        if n_attr else None
    st.upsert(list(range(n)), X, attrs)
    assign = rng.integers(0, k, n)
    st.set_partitions(np.arange(n), assign,
                      rng.normal(size=(k, d)).astype(np.float32),
                      np.zeros(k))
    return st, X, assign


def _mk_cache(st, assign, n_frames, **kw):
    p_max = int(np.bincount(assign).max())
    fb = compute_frame_bytes(p_max, st.dim)
    return PartitionCache(st, p_max=p_max, budget_bytes=n_frames * fb,
                          device="cpu", **kw)


# -- batched store reads ------------------------------------------------------


def test_scan_partitions_matches_per_pid_scan(tmp_path):
    st, X, assign = _mk_store(tmp_path, n_attr=2)
    p_max = int(np.bincount(assign).max())
    pids = [3, 0, 7]
    blocks = st.scan_partitions(pids, p_max, with_attrs=True)
    for j, pid in enumerate(pids):
        ids, vecs = st.scan_partition(pid)
        m = len(ids)
        assert blocks.valid[j].sum() == m
        np.testing.assert_array_equal(blocks.ids[j, :m], ids)
        np.testing.assert_array_equal(blocks.vecs[j, :m], vecs)
        assert (blocks.ids[j, m:] == -1).all()
        np.testing.assert_array_equal(blocks.attrs[j, :m],
                                      st.attributes_for(ids))
    with pytest.raises(ValueError, match="overflows"):
        st.scan_partitions([int(np.bincount(assign).argmax())], p_max - 1)


def test_scan_partitions_codes_ride_along(tmp_path):
    st, X, assign = _mk_store(tmp_path)
    codes = np.clip(X * 10, -128, 127).astype(np.int8)
    # leave one asset without a durable code
    st.set_code_tier(np.arange(1, len(X)), codes[1:],
                     np.zeros(8, np.float32), np.ones(8, np.float32))
    p_max = int(np.bincount(assign).max())
    blocks = st.scan_partitions([int(assign[0])], p_max, with_codes=True,
                                with_vecs=False)
    assert blocks.vecs is None
    row = np.nonzero(blocks.ids[0] == 0)[0][0]
    assert not blocks.code_ok[0, row]           # missing code flagged
    for r in np.nonzero(blocks.valid[0] & blocks.code_ok[0])[0]:
        np.testing.assert_array_equal(blocks.codes[0, r],
                                      codes[blocks.ids[0, r]])
    with pytest.raises(ValueError, match="duplicate"):
        st.scan_partitions([1, 1], p_max)


def test_store_gathers_counts_and_streams(tmp_path):
    st, X, assign = _mk_store(tmp_path, n_attr=2)
    got = st.attributes_for(np.array([5, 3, 5, 9999]))   # dup + missing
    np.testing.assert_array_equal(got[0], got[2])
    np.testing.assert_array_equal(got[3], np.zeros(2))
    out, found = st.vectors_for([7, 3, 12345, 7])
    np.testing.assert_array_equal(found, [True, True, False, True])
    np.testing.assert_array_equal(out[[0, 1, 3]], X[[7, 3, 7]])
    np.testing.assert_array_equal(st.partitions_for([7, 12345, 3]),
                                  [assign[7], -2, assign[3]])
    np.testing.assert_array_equal(st.partition_counts(10),
                                  np.bincount(assign, minlength=10))
    assert st.count() == 200
    ids = st.iter_asset_ids()
    streamed = np.concatenate(list(st.iter_batches(64)))
    np.testing.assert_array_equal(streamed, X[ids])
    order = np.lexsort((np.arange(200), assign))
    np.testing.assert_array_equal(ids, order)
    sample = st.sample(50, np.random.default_rng(0))
    idx = sorted(np.random.default_rng(0).integers(0, 200, 50))
    np.testing.assert_array_equal(sample, X[ids[idx]])


def test_reassign_and_apply_repair_move_rows(tmp_path):
    st, X, assign = _mk_store(tmp_path)
    gen = st.generation
    new = (assign + 1) % 10
    cents = np.arange(80, dtype=np.float32).reshape(10, 8)
    st.reassign_partitions(np.arange(200), new, cents, np.ones(10))
    assert st.generation == gen + 1
    np.testing.assert_array_equal(st.partitions_for(np.arange(200)), new)
    np.testing.assert_array_equal(st.centroids()[0], cents)
    st.apply_repair([0, 1], [9, 9], [9], cents[9:] + 1, np.array([5.0]))
    assert st.generation == gen + 1
    assert list(st.partitions_for([0, 1])) == [9, 9]
    c, s = st.centroids()
    np.testing.assert_array_equal(c[9], cents[9] + 1)
    np.testing.assert_array_equal(c[:9], cents[:9])
    assert s[9] == 5.0


# -- frame pool: budget, clock eviction, pins ---------------------------------


def test_budget_too_small_for_one_frame_raises(tmp_path):
    st, _, assign = _mk_store(tmp_path)
    with pytest.raises(ValueError):
        PartitionCache(st, p_max=int(np.bincount(assign).max()),
                       budget_bytes=8, device="cpu")


def test_frame_bytes_count_the_int8_norms():
    assert compute_frame_bytes(568, 128, "int8", 2) == 568 * (128 + 4 + 1
                                                              + 8 + 4)
    assert compute_frame_bytes(568, 128, "f32", 2) == 568 * (512 + 4 + 1
                                                             + 8)


def test_hit_miss_counters_and_frame_content(tmp_path):
    st, X, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 4)
    f = cache.fault([2, 5])
    cache.unpin(f)
    assert (cache.hits, cache.misses) == (0, 2)
    f2 = cache.fault([5, 2, 6])
    cache.unpin(f2)
    assert (cache.hits, cache.misses) == (2, 3)
    ids, vecs = st.scan_partition(5)
    j, m = int(f2[0]), len(ids)
    np.testing.assert_array_equal(cache.ids_pool[j, :m].numpy(), ids)
    np.testing.assert_array_equal(cache.payload_pool[j, :m].numpy(), vecs)
    assert not cache.valid_pool[j, m:].any()


def test_int8_frames_carry_the_resident_norms(tmp_path):
    st, X, assign = _mk_store(tmp_path)
    stats = quantize.train(torch.from_numpy(X))
    codes = quantize.encode(stats, torch.from_numpy(X)).numpy()
    st.set_code_tier(np.arange(1, 200), codes[1:],
                     *quantize.stats_to_arrays(stats))   # asset 0: no code
    p_max = int(np.bincount(assign).max())
    cache = PartitionCache(
        st, p_max=p_max, payload="int8", qstats=stats, device="cpu",
        budget_bytes=3 * compute_frame_bytes(p_max, 8, "int8"))
    assert cache.norms_pool.shape == (3, p_max)
    p0 = int(assign[0])
    f = cache.fault([p0, (p0 + 1) % 10])
    for j, pid in zip(f, (p0, (p0 + 1) % 10)):
        ids, _ = st.scan_partition(pid)
        m = len(ids)
        # asset 0 was backfilled with the build's encode
        np.testing.assert_array_equal(cache.payload_pool[j, :m].numpy(),
                                      codes[ids])
        want = quantize.row_norms(stats, torch.from_numpy(codes[ids]))
        assert torch.equal(cache.norms_pool[j, :m], want)
    cache.unpin(f)
    assert cache.resident_bytes <= cache.budget_bytes


def test_int8_norms_scratch_stays_under_the_budget(tmp_path, monkeypatch):
    """A fault that fills the whole pool decodes its rows in chunks whose
    float32 scratch (the decode, its squares, the sum's first half) stays
    under the pool's budget, and the norms are the unchunked ones bit for
    bit."""
    st, X, assign = _mk_store(tmp_path, n=600, k=4)
    stats = quantize.train(torch.from_numpy(X))
    codes = quantize.encode(stats, torch.from_numpy(X)).numpy()
    st.set_code_tier(np.arange(600), codes, *quantize.stats_to_arrays(stats))
    p_max = int(np.bincount(assign).max())
    cache = PartitionCache(
        st, p_max=p_max, payload="int8", qstats=stats, device="cpu",
        budget_bytes=4 * compute_frame_bytes(p_max, 8, "int8"))
    decoded = []
    real = quantize.decode

    def decode(s, c):
        decoded.append(c.reshape(-1, c.shape[-1]).shape[0])
        return real(s, c)

    monkeypatch.setattr(quantize, "decode", decode)
    f = cache.fault([0, 1, 2, 3])
    assert len(decoded) > 1
    assert 10 * 8 * max(decoded) <= cache.budget_bytes
    monkeypatch.undo()
    whole = quantize.row_norms(stats, cache.payload_pool[f])
    assert torch.equal(cache.norms_pool[f], whole)
    cache.unpin(f)


def test_clock_eviction_order_second_chance(tmp_path):
    st, _, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 3)
    cache.unpin(cache.fault([0, 1, 2]))     # fill: frames 0,1,2 all ref'd
    # cold fault: the sweep clears every ref bit, wraps, and reclaims the
    # first frame past the hand -- pid 0
    cache.unpin(cache.fault([3]))
    assert cache.evictions == 1
    assert set(cache._pid_frame) == {1, 2, 3}
    cache.unpin(cache.fault([1]))           # re-reference pid 1 ...
    cache.unpin(cache.fault([4]))
    resident = set(cache._pid_frame)
    # ... so its ref bit buys it a second chance: the cold pid 2 goes
    assert 1 in resident and 4 in resident and 2 not in resident
    assert cache.evictions == 2


def test_pin_semantics_block_eviction(tmp_path):
    st, _, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 2)
    pinned = cache.fault([3, 4])                # both frames pinned
    with pytest.raises(RuntimeError):
        cache.fault([5])                        # no victim available
    with pytest.raises(ValueError):
        cache.fault([1, 2, 3])                  # probe set > pool
    cache.unpin(pinned[:1])
    f = cache.fault([5])                        # now a victim exists
    cache.unpin(f)
    assert 5 in cache._pid_frame
    cache.unpin(pinned[1:])
    with pytest.raises(RuntimeError, match="not pinned"):
        cache.unpin(pinned[1:])


def test_budget_never_exceeded_randomized_workload(tmp_path):
    st, _, assign = _mk_store(tmp_path, n=400, k=20, seed=3)
    cache = _mk_cache(st, assign, 3)
    budget = cache.budget_bytes
    rng = np.random.default_rng(0)
    for _ in range(50):
        pids = rng.choice(20, size=rng.integers(1, 4), replace=False)
        f = cache.fault(list(pids))
        assert cache.resident_bytes <= budget
        cache.unpin(f)
    assert cache.evictions > 0 and cache.hits > 0
    s = cache.stats()
    assert s["resident_bytes"] == cache.resident_bytes <= budget
    assert s["capacity_frames"] == 3


def test_fault_failure_rolls_back_registrations(tmp_path, monkeypatch):
    """A failed fetch leaves no pinned frames and no pid -> frame mapping
    for data that never arrived."""
    st, _, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 4)
    cache.unpin(cache.fault([0]))

    def boom(*a, **k):
        raise RuntimeError("database is locked")
    monkeypatch.setattr(st, "scan_partitions", boom)
    with pytest.raises(RuntimeError):
        cache.fault([0, 1])         # hit(0) + miss(1): the fetch fails
    assert (cache._pins == 0).all()
    assert 1 not in cache._pid_frame
    assert 0 in cache._pid_frame
    monkeypatch.undo()
    f = cache.fault([0, 1])
    ids, _ = st.scan_partition(1)
    assert int(cache.valid_pool[int(f[1])].sum()) == len(ids)
    cache.unpin(f)


def test_resize_failure_keeps_old_geometry(tmp_path):
    st, _, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 2)
    geom = (cache.p_max, cache.frame_bytes, cache.capacity)
    with pytest.raises(ValueError):
        cache.resize(cache.p_max * 1000)        # budget cannot seat it
    assert (cache.p_max, cache.frame_bytes, cache.capacity) == geom
    cache.unpin(cache.fault([0]))


def test_invalidate_forces_refetch(tmp_path):
    st, X, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 4)
    cache.unpin(cache.fault([1]))
    victim = int(np.nonzero(assign == 1)[0][0])
    newv = np.full((1, 8), 42.0, np.float32)
    st.upsert([victim], newv, partition_id=1)
    cache.invalidate([1])
    f = cache.fault([1])
    j = int(f[0])
    row = np.nonzero(cache.ids_pool[j].numpy() == victim)[0][0]
    np.testing.assert_array_equal(cache.payload_pool[j, row].numpy(),
                                  newv[0])
    cache.unpin(f)
    assert cache.misses == 2


def test_fault_writes_frames_in_place(tmp_path):
    """The port's counterpart of the donated scatter: a fault copies into
    the preallocated pool tensors, never a second pool."""
    st, _, assign = _mk_store(tmp_path, n_attr=2)
    cache = _mk_cache(st, assign, 6, with_attrs=True)
    pools = (cache.payload_pool, cache.ids_pool, cache.valid_pool,
             cache.attrs_pool)
    ptrs = [p.data_ptr() for p in pools]
    pinned = cache.fault([3])
    cache.unpin(cache.fault([4, 5, 6]))     # evicts with a pin held
    cache.unpin(pinned)
    assert [p.data_ptr() for p in (cache.payload_pool, cache.ids_pool,
                                   cache.valid_pool, cache.attrs_pool)] \
        == ptrs


# -- admission policy: scan-resistant faults ---------------------------------


def test_scan_resistant_fault_preserves_hot_set(tmp_path):
    st, _, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 8)
    assert cache.scan_frames == 2
    hot = [0, 1, 2, 3, 4, 5]
    cache.unpin(cache.fault(hot))
    for s in range(0, 10, cache.scan_frames):   # one-off full scan
        pids = list(range(s, min(s + cache.scan_frames, 10)))
        cache.unpin(cache.fault(pids, admit=False))
    h0, m0 = cache.hits, cache.misses
    cache.unpin(cache.fault(hot))               # hot set still resident
    assert (cache.hits, cache.misses) == (h0 + len(hot), m0)
    assert cache._transient.sum() <= cache.scan_frames


def test_scan_ring_promotion_and_reclaim(tmp_path):
    st, _, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 8)
    f = cache.fault([7], admit=False)           # lands in the scan ring
    cache.unpin(f)
    fr = int(f[0])
    assert cache._transient[fr] and fr in cache._ring
    f2 = cache.fault([7])                       # admitted hit -> promote
    cache.unpin(f2)
    assert int(f2[0]) == fr
    assert not cache._transient[fr] and fr not in cache._ring
    cache.unpin(cache.fault([0, 1, 2, 3]))      # hot admitted frames
    ring = cache.fault([8], admit=False)
    cache.unpin(ring)
    f_new = cache.fault([9])                    # admitted miss
    cache.unpin(f_new)
    # the transient frame is the preferred victim -- hot frames intact
    assert int(f_new[0]) == int(ring[0])
    assert {0, 1, 2, 3, 7} <= set(cache._pid_frame)


# -- deferred invalidation, threads, staging ---------------------------------


def test_invalidate_pinned_frame_defers_release(tmp_path):
    st, _, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 4)
    f = cache.fault([2])                  # pinned by an in-flight scan
    cache.invalidate([2])
    assert 2 not in cache._pid_frame      # next fault refetches
    assert cache._stale[int(f[0])]
    f2 = cache.fault([2])
    assert int(f2[0]) != int(f[0])
    cache.unpin(f)                        # scan ends -> deferred release
    assert not cache._stale[int(f[0])]
    assert cache._frame_pid[int(f[0])] == -1
    cache.unpin(f2)


def test_partition_cache_thread_safe_interleaving(tmp_path):
    """Hammer one cache from more threads than the pool has spare frames
    for, with a short switch interval: pins, counters and the frame table
    stay consistent."""
    import sys
    st, _, assign = _mk_store(tmp_path, n=400, k=20, seed=3)
    cache = _mk_cache(st, assign, 18)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in range(40):
                pids = rng.choice(20, size=int(rng.integers(1, 4)),
                                  replace=False)
                f = cache.fault(list(pids))
                cache.payload_pool[torch.from_numpy(f).long()].sum()
                cache.unpin(f)
                if i % 7 == 0:
                    cache.invalidate([int(rng.integers(0, 20))])
        except Exception as e:               # pragma: no cover
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert (cache._pins == 0).all()
    for p, f in cache._pid_frame.items():
        assert cache._frame_pid[f] == p
    assert cache.hits + cache.misses >= 6 * 40


def test_stage_then_fault_consumes_staged_blocks(tmp_path, monkeypatch):
    st, _, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 4)
    cache.unpin(cache.fault([1]))
    cache.stage([2, 5, 1])                   # 1 is already resident
    assert set(cache._staged) == {2, 5}

    def boom(*a, **k):                       # pragma: no cover
        raise AssertionError("staged fault re-fetched from the store")
    monkeypatch.setattr(st, "scan_partitions", boom)
    f = cache.fault([2, 5])
    assert not cache._staged                 # consumed
    assert (cache.hits, cache.misses, cache.staged_consumed) == (0, 3, 2)
    monkeypatch.undo()
    for j, pid in zip(f, (2, 5)):
        ids, vecs = st.scan_partition(pid)
        m = len(ids)
        np.testing.assert_array_equal(cache.ids_pool[int(j), :m].numpy(),
                                      ids)
        np.testing.assert_array_equal(
            cache.payload_pool[int(j), :m].numpy(), vecs)
    cache.unpin(f)


def test_invalidate_drops_staged_blocks(tmp_path):
    st, X, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 4)
    cache.stage([1])
    victim = int(np.nonzero(assign == 1)[0][0])
    newv = np.full((1, 8), 42.0, np.float32)
    st.upsert([victim], newv, partition_id=1)
    cache.invalidate([1])
    assert 1 not in cache._staged
    f = cache.fault([1])
    j = int(f[0])
    row = np.nonzero(cache.ids_pool[j].numpy() == victim)[0][0]
    np.testing.assert_array_equal(cache.payload_pool[j, row].numpy(),
                                  newv[0])
    cache.unpin(f)


def test_invalidate_mid_fetch_discards_whole_stage_batch(tmp_path):
    st, _, assign = _mk_store(tmp_path)
    cache = _mk_cache(st, assign, 4)
    real = st.scan_partitions

    def racing(*a, **k):
        blocks = real(*a, **k)
        cache.invalidate([9])        # a writer commits mid-fetch
        return blocks

    st.scan_partitions = racing
    try:
        cache.stage([3, 4])
    finally:
        st.scan_partitions = real
    assert not cache._staged
    cache.unpin(cache.fault([3, 4]))
    assert cache.misses == 2


def test_shared_pool_tenants_answer_as_solo(tmp_path):
    """Two caches over one FramePool (tenants) compete for its frames and
    still read their own partitions."""
    st_a, _, assign_a = _mk_store(tmp_path, "a.db", seed=1)
    st_b, _, assign_b = _mk_store(tmp_path, "b.db", seed=2)
    p_max = int(max(np.bincount(assign_a).max(),
                    np.bincount(assign_b).max()))
    pool = FramePool(dim=8, p_max=p_max, device="cpu",
                     budget_bytes=3 * compute_frame_bytes(p_max, 8))
    a = PartitionCache(st_a, p_max=p_max, budget_bytes=0, pool=pool,
                       tenant="a")
    b = PartitionCache(st_b, p_max=p_max, budget_bytes=0, pool=pool,
                       tenant="b")
    with pytest.raises(ValueError, match="tenant"):
        PartitionCache(st_a, p_max=p_max, budget_bytes=0, pool=pool)
    for cache, st in ((a, st_a), (b, st_b), (a, st_a)):
        f = cache.fault([0, 1])
        for j, pid in zip(f, (0, 1)):
            ids, vecs = st.scan_partition(pid)
            np.testing.assert_array_equal(
                pool.payload_pool[int(j), :len(ids)].numpy(), vecs)
        cache.unpin(f)
    assert pool.resident_bytes <= pool.budget_bytes
    assert sum(pool.eviction_matrix().get("a", {}).values()) >= 1
    assert pool.stats()["tenants"]["b"]["resident_frames"] >= 1


# -- the paged engine ---------------------------------------------------------

CFG = dict(dim=DIM, target_partition_size=50, kmeans_iters=15,
           delta_capacity=64, rerank_factor=4)
BUDGET_MB = 0.05


@pytest.fixture(scope="module", params=["none", "int8"])
def jax_written(request, tmp_path_factory):
    """A database the JAX engine wrote (with pending delta rows), the JAX
    paged engine over it, and the port's resident and paged engines
    recovered from it."""
    tier = request.param
    X = clustered(1500, seed=8)
    attrs = (np.arange(1500) % 4).astype(np.float32)[:, None]
    path = str(tmp_path_factory.mktemp("paged") / f"{tier}.db")
    jcfg = JConfig(quantize=tier, **CFG)
    jeng = JMicroNN(dim=DIM, n_attr=1, path=path, config=jcfg)
    jeng.upsert(np.arange(1500), X, attrs)
    jeng.build()
    jeng.upsert(np.arange(5000, 5010), X[:10] + 0.05, attrs[:10])
    jeng.delete(np.array([3, 5004]))
    jpag = JMicroNN(dim=DIM, n_attr=1, path=path, config=jcfg,
                    memory_budget_mb=BUDGET_MB)
    jpag.recover()
    tcfg = IVFConfig(quantize=tier, **CFG)
    tres = MicroNN(dim=DIM, n_attr=1, path=path, config=tcfg, device="cpu")
    tres.recover()
    tpag = MicroNN(dim=DIM, n_attr=1, path=path, config=tcfg, device="cpu",
                   memory_budget_mb=BUDGET_MB)
    tpag.recover()
    Xall = np.concatenate([X, X[:10] + 0.05])
    yield jpag, tres, tpag, Xall, attrs
    for e in (jeng, jpag):
        e.store.close()
    tres.close()
    tpag.close()


def _assert_close(ref, got, q, X):
    v2 = float(np.sum(X * X, -1).max())
    err, ok, bad = compare_topk(np.asarray(ref.scores), np.asarray(ref.ids),
                                got.to_numpy()[1], got.to_numpy()[0],
                                score_tol(q, v2))
    assert ok, f"{bad} query rows differ (max score err {err:.3e})"


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a.to_numpy()[0], b.to_numpy()[0])
    np.testing.assert_array_equal(a.to_numpy()[1], b.to_numpy()[1])


@pytest.mark.parametrize("n_q", [1, 16])
def test_paged_on_jax_db_matches_jax_paged(jax_written, n_q):
    jpag, _, tpag, X, _ = jax_written
    assert tpag.index.cache.capacity < tpag.index.k   # the budget pages
    q = X[100:100 + n_q] + 0.1
    _assert_close(jpag.query(q, Q.knn(k=10, n_probe=8)),
                  tpag.query(q, Q.knn(k=10, n_probe=8)), q, X)
    assert (tpag.query(q, Q.knn(k=10, n_probe=8)).to_numpy()[0]
            == np.asarray(jpag.query(q, Q.knn(k=10, n_probe=8)).ids)).all()


@pytest.mark.parametrize("n_q", [1, 16])
def test_paged_matches_resident_bitwise(jax_written, n_q):
    _, tres, tpag, X, _ = jax_written
    q = X[200:200 + n_q] + 0.1
    for spec in (Q.knn(k=10, n_probe=8), Q.knn(k=30, n_probe=3)):
        _assert_bitwise(tres.query(q, spec), tpag.query(q, spec))
    spec = Q.knn(k=10, n_probe=8).where(Pred(0, "==", 2)).postfilter()
    _assert_bitwise(tres.query(q, spec), tpag.query(q, spec))


@pytest.mark.parametrize("metric", ["cosine", "ip"])
@pytest.mark.parametrize("tier", ["none", "int8"])
def test_paged_matches_resident_bitwise_other_metrics(tmp_path, metric,
                                                      tier):
    """Cosine rows are normalised on the host by recover()'s op in both
    engines (frames and the store rerank alike), so paged == resident
    holds bit for bit beyond l2."""
    X = clustered(1500, seed=31)
    path = str(tmp_path / "m.db")
    cfg = IVFConfig(metric=metric, quantize=tier, **CFG)
    eng = MicroNN(dim=DIM, path=path, config=cfg, device="cpu")
    eng.upsert(np.arange(1500), X)
    eng.build()
    eng.upsert(np.arange(5000, 5005), X[:5] + 0.1)
    eng.close()
    res = MicroNN(dim=DIM, path=path, config=cfg, device="cpu")
    res.recover()
    pag = MicroNN(dim=DIM, path=path, config=cfg, device="cpu",
                  memory_budget_mb=BUDGET_MB)
    pag.recover()
    assert pag.index.cache.capacity < pag.index.k
    q = X[:16] + 0.05
    _assert_bitwise(res.query(q, Q.knn(k=10, n_probe=6)),
                    pag.query(q, Q.knn(k=10, n_probe=6)))
    res.close()
    pag.close()


def test_paged_exact_streams_whole_collection(jax_written):
    jpag, tres, tpag, X, _ = jax_written
    q = X[:4] + 0.1
    r_res = tres.query(q, Q.exact(k=10))
    r_pag = tpag.query(q, Q.exact(k=10))
    _assert_close(jpag.query(q, Q.exact(k=10)), r_pag, q, X)
    if tpag.index.quantized:
        # int8 pool: a full-probe code scan + rerank, a near-oracle
        a, b = r_res.to_numpy()[0], r_pag.to_numpy()[0]
        hits = sum(len(set(x) & set(y)) for x, y in zip(a, b))
        assert hits / a.size >= 0.95
    else:
        _assert_bitwise(r_res, r_pag)
    # the read-ahead never changes what a scan computes
    before = executor.PAGED_PREFETCH
    try:
        executor.PAGED_PREFETCH = False
        r_off = tpag.query(q, Q.exact(k=10))
    finally:
        executor.PAGED_PREFETCH = before
    _assert_bitwise(r_off, r_pag)


def test_paged_budget_held_stats_and_refusals(jax_written):
    _, _, tpag, X, _ = jax_written
    budget = int(BUDGET_MB * 2 ** 20)
    for i in range(4):
        tpag.query(X[i * 8:(i + 1) * 8], Q.knn(k=10, n_probe=8))
        assert tpag.index.cache.resident_bytes <= budget
    s = tpag.stats()
    assert s["paged"] and s["misses"] > 0 and s["evictions"] > 0
    assert s["resident_bytes"] <= budget == s["budget_bytes"]
    assert s["bytes_read"] > 0
    with pytest.raises(ValueError, match="pre-filter"):
        tpag.query(X[:2], Q.knn(k=5).where(Pred(0, "==", 1)).prefilter(64))
    with pytest.raises(ValueError, match="union_cap"):
        tpag.query(X[:2], Q.knn(k=5).union_cap(4))
    with pytest.raises(ValueError, match="force"):
        tpag.maintain(force="compact")
    # "auto" in paged mode skips the optimizer: a post-filter
    auto = tpag.query(X[:4], Q.knn(k=10).where(Pred(0, "==", 1)))
    post = tpag.query(X[:4], Q.knn(k=10).where(Pred(0, "==", 1))
                      .postfilter())
    _assert_bitwise(auto, post)
    parts = tpag.query_batched([X[:3], X[3:8]], Q.knn(k=10))
    for part, chunk in zip(parts, (X[:3], X[3:8])):
        _assert_bitwise(part, tpag.query(chunk, Q.knn(k=10)))


def test_paged_predicate_on_cold_cache(tmp_path):
    """Every frame is faulted inside the search itself; the predicate reads
    the attrs frames written by those faults."""
    rng = np.random.default_rng(4)
    n = 2000
    X = (rng.normal(size=(n, DIM)) * 3).astype(np.float32)
    attrs = rng.integers(0, 4, (n, 1)).astype(np.float32)
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=10,
                    quantize="int8")
    eng = MicroNN(dim=DIM, n_attr=1, path=str(tmp_path / "pred.db"),
                  config=cfg, memory_budget_mb=0.05, device="cpu")
    eng.upsert(np.arange(n), X, attrs)
    eng.build()
    for qs, v in ((X[:8], 3.0), (X[8:16], 1.0)):
        ids = eng.search(qs, k=10, predicate=Pred(0, "eq", v)) \
            .to_numpy()[0]
        real = ids[ids >= 0]
        assert len(real) > 0 and (attrs[real, 0] == v).all()
    eng.close()


def test_paged_flush_upsert_delete_invalidate(tmp_path):
    X = clustered(800, seed=9)
    cfg = IVFConfig(dim=DIM, target_partition_size=40, kmeans_iters=10,
                    delta_capacity=32, quantize="int8")
    path = str(tmp_path / "f.db")
    eng = MicroNN(dim=DIM, path=path, config=cfg, memory_budget_mb=0.05,
                  device="cpu")
    eng.upsert(np.arange(800), X)
    eng.build()
    counts0 = int(eng.index.counts.sum())
    nv = np.random.default_rng(3).normal(size=(8, DIM)).astype(np.float32)
    eng.upsert(np.arange(9000, 9008), nv)
    eng.search(nv, k=1)                     # warm the touched partitions
    misses0 = eng.index.cache.misses
    assert eng.maintain(force="flush") == "flush"
    assert int(eng.index.delta.valid.sum()) == 0
    assert int(eng.index.counts.sum()) == counts0 + 8
    r = eng.search(nv[:4], k=1)             # now served from main frames
    assert list(r.to_numpy()[0][:, 0]) == [9000, 9001, 9002, 9003]
    assert eng.index.cache.misses > misses0     # frames were invalidated
    assert len(eng.store.scan_partition(-1)[0]) == 0   # moved durably
    # move row 0 far away: its old main-tier copy must stop matching
    assert int(eng.search(X[:1], k=1).to_numpy()[0][0, 0]) == 0
    eng.upsert(np.asarray([0]), np.full((1, DIM), 50.0, np.float32))
    assert int(eng.search(X[:1], k=1).to_numpy()[0][0, 0]) != 0
    assert int(eng.index.counts.sum()) == counts0 + 7
    far = np.full((1, DIM), 50.0, np.float32)
    assert int(eng.search(far, k=1).to_numpy()[0][0, 0]) == 0
    eng.delete(np.asarray([1]))
    assert 1 not in eng.search(X[1:2], k=5).to_numpy()[0][0]
    assert int(eng.index.counts.sum()) == counts0 + 6
    # a recovered paged engine and a recovered resident one agree
    eng.close()
    pag = MicroNN(dim=DIM, path=path, config=cfg, memory_budget_mb=0.05,
                  device="cpu")
    pag.recover()
    res = MicroNN(dim=DIM, path=path, config=cfg, device="cpu")
    res.recover()
    q = np.concatenate([X[:8], nv[:4], far])
    _assert_bitwise(res.query(q, Q.knn(k=10, n_probe=8)),
                    pag.query(q, Q.knn(k=10, n_probe=8)))
    pag.close()
    res.close()


def test_paged_sessions_match_sequential_ops(tmp_path):
    X = clustered(600, seed=14)
    cfg = IVFConfig(dim=DIM, target_partition_size=40, kmeans_iters=10,
                    delta_capacity=16)
    engines = []
    for name in ("seq", "ses"):
        e = MicroNN(dim=DIM, path=str(tmp_path / f"{name}.db"), config=cfg,
                    memory_budget_mb=0.05, device="cpu")
        e.upsert(np.arange(600), X)
        e.build()
        engines.append(e)
    seq, ses = engines
    nv = X[:20] + 0.01
    seq.upsert(np.arange(1000, 1020), nv)
    seq.delete(np.array([5, 1003]))
    seq.upsert(np.array([7]), X[:1] + 0.02)
    with ses.session() as s:
        s.upsert(np.arange(1000, 1020), nv)
        s.delete(np.array([5, 1003]))
        s.upsert(np.array([7]), X[:1] + 0.02)
    q = X[:12]
    a = seq.query(q, Q.exact(k=10)).to_numpy()
    b = ses.query(q, Q.exact(k=10)).to_numpy()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.isin(b[0], [5, 1003]).any()
    # the same live rows (where they sit differs: the sequential run
    # flushed 1003 into a partition before deleting it)
    assert seq.index.num_live() == ses.index.num_live() == 600 + 20 - 2
    for e in engines:
        e.close()


def test_paged_build_then_resident_recover_agree(tmp_path):
    """The port's streamed paged build (int8 codes, k-means from SQLite
    samples, the final assignment through kmeans_assign) leaves a database
    that a resident engine recovers to the same answers, with recall near
    the JAX paged build's on the same rows."""
    X = clustered(1200, seed=21)
    rng = np.random.default_rng(22)
    q = (X[rng.integers(0, 1200, 16)]
         + 0.3 * rng.normal(size=(16, DIM))).astype(np.float32)
    d2 = (X * X).sum(1)[None, :] - 2 * q @ X.T
    gt = np.argsort(d2, axis=1)[:, :10]
    cfg = dict(dim=DIM, target_partition_size=50, kmeans_iters=10,
               quantize="int8")

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])

    pag = MicroNN(dim=DIM, path=str(tmp_path / "t.db"),
                  config=IVFConfig(**cfg), memory_budget_mb=0.05,
                  device="cpu")
    pag.upsert(np.arange(1200), X)
    pag.build()
    jpag = JMicroNN(dim=DIM, path=str(tmp_path / "j.db"),
                    config=JConfig(**cfg), memory_budget_mb=0.05)
    jpag.upsert(np.arange(1200), X)
    jpag.build()
    assert pag.index.k == jpag.index.k
    r_t = pag.query(q, Q.knn(k=10, n_probe=4))
    r_j = jpag.query(q, Q.knn(k=10, n_probe=4))
    assert abs(recall(r_t.to_numpy()[0]) - recall(np.asarray(r_j.ids))) \
        <= 0.02
    res = MicroNN(dim=DIM, path=str(tmp_path / "t.db"),
                  config=IVFConfig(**cfg), device="cpu")
    res.recover()
    _assert_bitwise(res.query(q, Q.knn(k=10, n_probe=4)), r_t)
    jpag.store.close()
    pag.close()
    res.close()


def test_paged_exact_stream_keeps_hot_frames(tmp_path):
    X = clustered(1500, seed=15)
    cfg = IVFConfig(dim=DIM, target_partition_size=50, kmeans_iters=10)
    eng = MicroNN(dim=DIM, path=str(tmp_path / "adm.db"), config=cfg,
                  memory_budget_mb=0.08, device="cpu")
    eng.upsert(np.arange(len(X)), X)
    eng.build()
    cache = eng.index.cache
    assert cache.capacity < eng.index.k
    for i in range(4):                      # warm an ANN working set
        eng.query(X[i * 8:(i + 1) * 8], Q.knn(k=10, n_probe=4))
    hot = {p for p, f in cache._pid_frame.items() if not cache._transient[f]}
    assert hot
    r_exact = eng.query(X[:4], Q.exact(k=10))
    survivors = hot & set(cache._pid_frame)
    assert len(hot) - len(survivors) <= cache.scan_frames
    res = MicroNN(dim=DIM, path=str(tmp_path / "adm.db"), config=cfg,
                  device="cpu")
    res.recover()
    _assert_bitwise(res.query(X[:4], Q.exact(k=10)), r_exact)
    eng.close()
    res.close()
