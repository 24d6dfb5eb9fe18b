"""The port's SQLite store writes in key order: the partition swap
(`set_partitions`) and the code tier (`set_code_tier`,
`set_code_tier_streaming`) against the JAX package's store, which writes
the same rows in the order it is handed them, on the same upserts,
deletes, ids and chunks; the schema the swap leaves (the same
`sqlite_master` as before it and as the JAX package's store writes), the
asset-id index still serving lookups, and the swap's rollback, standalone
and nested in an outer transaction."""
import numpy as np
import pytest

from repro.storage.store import VectorStore as JVectorStore
from repro_torch.storage.store import VectorStore

N = 300
DIMS = [8, 256]


def _rows(dim, n=N, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim)) \
        .astype(np.float32)


def _store(tmp_path, name, dim, n=N, cls=VectorStore):
    st = cls(str(tmp_path / name), dim=dim)
    st.upsert(np.arange(n), _rows(dim, n))
    return st


def _clustering(dim, k, n=N, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, k, n), rng.standard_normal((k, dim))
            .astype(np.float32), rng.integers(1, 9, k).astype(np.float32))


def _master(st):
    return st.db.execute("SELECT type, name, tbl_name, sql FROM sqlite_master"
                         " ORDER BY name").fetchall()


def _state(st, k):
    """Everything a swap decides, as plain Python values."""
    ids, parts, vecs = st.all_rows()
    cents, csz = st.centroids()
    return dict(ids=ids.tolist(), parts=parts.tolist(), vecs=vecs.tobytes(),
                cents=cents.tobytes(), csz=csz.tolist(),
                generation=st.generation,
                counts=st.partition_counts(k).tolist(),
                scan_order=st.iter_asset_ids().tolist())


def _lookup_plan(st):
    """The query plan of partitions_for's batched asset-id lookup."""
    return " ".join(r[-1] for r in st.db.execute(
        "EXPLAIN QUERY PLAN SELECT asset_id, partition_id FROM vectors"
        " WHERE asset_id IN (?, ?, ?)", (1, 2, 3)))


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("step", ["from_delta", "rebuild"])
def test_swap_matches_jax_store(tmp_path, dim, step):
    got = _store(tmp_path, "got.db", dim)
    ref = _store(tmp_path, "ref.db", dim, cls=JVectorStore)
    assign, cents, csz = _clustering(dim, k=7)
    ids = np.arange(N)
    k = 7
    if step == "rebuild":
        # a clustering in place, then deletes and fresh delta rows before
        # the second swap over every live row
        for st in (got, ref):
            st.set_partitions(ids, assign, cents, csz)
            st.delete(np.arange(0, N, 10))
            st.upsert(np.arange(N, N + 40), _rows(dim, 40, seed=5))
        assert _state(got, k) == _state(ref, k)
        ids = np.random.default_rng(2).permutation(
            np.setdiff1d(np.arange(N + 40), np.arange(0, N, 10)))
        k = 11
        assign, cents, csz = _clustering(dim, k, n=len(ids), seed=3)
    got.set_partitions(ids, assign, cents, csz)
    ref.set_partitions(ids, assign, cents, csz)
    assert _state(got, k) == _state(ref, k)
    assert got.generation == (2 if step == "rebuild" else 1)
    np.testing.assert_array_equal(got.partitions_for(ids),
                                  ref.partitions_for(ids))
    np.testing.assert_array_equal(got.partitions_for(ids), assign)


@pytest.mark.parametrize("dim", DIMS)
def test_swap_keeps_the_schema(tmp_path, dim):
    st = _store(tmp_path, "v.db", dim)
    jst = JVectorStore(str(tmp_path / "j.db"), dim=dim)
    before = _master(st)
    assert before == _master(jst)
    assign, cents, csz = _clustering(dim, k=5)
    st.set_partitions(np.arange(N), assign, cents, csz)
    assert _master(st) == before
    st.set_partitions(np.arange(N), assign[::-1], cents, csz)
    assert _master(st) == before


@pytest.mark.parametrize("dim", DIMS)
def test_asset_lookup_uses_the_index_after_swap(tmp_path, dim):
    st = _store(tmp_path, "v.db", dim)
    assert "vectors_by_asset" in _lookup_plan(st)
    assign, cents, csz = _clustering(dim, k=5)
    st.set_partitions(np.arange(N), assign, cents, csz)
    assert "vectors_by_asset" in _lookup_plan(st)
    np.testing.assert_array_equal(st.partitions_for([3, 1, N + 7]),
                                  [assign[3], assign[1], -2])


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("nested", [False, True], ids=["standalone",
                                                       "nested"])
def test_failed_swap_leaves_previous_generation(tmp_path, dim, nested):
    st = _store(tmp_path, "v.db", dim)
    assign, cents, csz = _clustering(dim, k=5)
    st.set_partitions(np.arange(N), assign, cents, csz)
    ref = _store(tmp_path, "ref.db", dim, cls=JVectorStore)
    ref.set_partitions(np.arange(N), assign, cents, csz)
    before, master = _state(st, 5), _master(st)
    assert before == _state(ref, 5)
    # an asset id the store does not hold, in the middle of the key order:
    # the swap fails after it has dropped the index and emptied the table
    ids = np.arange(N + 1)
    ids[N // 2] = 10 * N
    new_assign, new_cents, new_csz = _clustering(dim, k=5, n=N + 1, seed=4)
    new_assign[N // 2] = 2
    ran = []
    st.db.set_trace_callback(ran.append)
    with pytest.raises(KeyError):
        if nested:
            with st.transaction():
                st.upsert([N + 1], _rows(dim, 1, seed=6))
                st.set_partitions(ids, new_assign, new_cents, new_csz)
        else:
            st.set_partitions(ids, new_assign, new_cents, new_csz)
    st.db.set_trace_callback(None)
    assert any(s.startswith("DROP INDEX") for s in ran)
    assert any(s.startswith("DELETE FROM vectors") for s in ran)
    assert _state(st, 5) == before
    assert _master(st) == master
    assert "vectors_by_asset" in _lookup_plan(st)
    assert st._txn_depth == 0
    # the store stays writable: the next swap goes through
    st.set_partitions(np.arange(N), new_assign[:N], new_cents, new_csz)
    assert st.generation == 2 and _master(st) == master


@pytest.mark.parametrize("dim", DIMS)
def test_unsorted_codes_match_jax_store(tmp_path, dim):
    rng = np.random.default_rng(7)
    ids = np.arange(N)
    codes = rng.integers(-128, 128, (N, dim)).astype(np.int8)
    lo = rng.standard_normal(dim).astype(np.float32)
    scale = rng.random(dim).astype(np.float32) + 0.5
    perm = rng.permutation(N)
    cut = N // 3

    def chunks():
        # the same pairs in two unsorted chunks
        return iter([(ids[perm[:cut]], codes[perm[:cut]]),
                     (ids[perm[cut:]], codes[perm[cut:]])])

    pairs = []
    for name, cls in (("port", VectorStore), ("jax", JVectorStore)):
        whole = _store(tmp_path, f"{name}-whole.db", dim, cls=cls)
        whole.set_code_tier(ids[perm], codes[perm], lo, scale)
        chk = _store(tmp_path, f"{name}-chunks.db", dim, cls=cls)
        chk.set_code_tier_streaming(chunks(), lo, scale)
        pairs.append((whole, chk))
    srt = _store(tmp_path, "port-sorted.db", dim)
    srt.set_code_tier(ids, codes, lo, scale)
    want = np.random.default_rng(8).permutation(N + 5)
    ref_codes, ref_found = pairs[1][0].codes_for(want)
    assert ref_found.sum() == N
    for st in (*pairs[0], pairs[1][1], srt):
        got_codes, got_found = st.codes_for(want)
        np.testing.assert_array_equal(got_codes, ref_codes)
        np.testing.assert_array_equal(got_found, ref_found)
        for a, b in zip(st.qstats(), pairs[1][0].qstats()):
            np.testing.assert_array_equal(a, b)
    # a repeated id in one chunk keeps the code written last, as the JAX
    # package's store keeps it
    for st in (pairs[0][0], pairs[1][0]):
        st.set_code_tier([9, 4, 9], codes[:3], lo, scale)
    got, _ = pairs[0][0].codes_for([9, 4])
    ref, _ = pairs[1][0].codes_for([9, 4])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, codes[[2, 1]])
