"""The generator and the traffic are functions of the seed: the same seed
gives the same rows, pool, calls and writes; another seed other ones."""
import numpy as np
import pytest
import torch

from perfbench import datagen, harness, loadgen

SPEC = {"generator": "mixture", "rows": 2000, "dim": 16, "clusters": 8,
        "pool": 100, "attrs": [{"kind": "int", "low": 0, "high": 10},
                               {"kind": "uniform"}]}
MIX = {"loop": "closed", "callers": 1,
       "calls": [{"weight": 2, "batch": 16, "spec": {"k": 5}},
                 {"weight": 1, "batch": 8, "spec": {"k": 5},
                  "predicate": {"col": 1, "op": "lt",
                                "value": {"uniform": [0.1, 0.5]}}}],
       "writes": {"period_ms": 100, "upsert_new": 4, "upsert_overwrite": 3,
                  "delete": 2}}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 17, 2 ** 33 + 5])
def test_same_seed_same_data(seed):
    a = datagen.make(SPEC, seed, "cpu")
    b = datagen.make(SPEC, seed, "cpu")
    for x, y in ((a.X, b.X), (a.attrs, b.attrs), (a.pool, b.pool)):
        assert torch.equal(x, y)
    assert a.X.dtype == torch.float32 and a.X.shape == (2000, 16)
    assert set(a.attrs[:, 0].unique().tolist()) <= set(range(10))
    assert float(a.attrs[:, 1].min()) >= 0 and float(a.attrs[:, 1].max()) < 1
    wa, _ = datagen.extra_rows(a, 50, seed)
    wb, _ = datagen.extra_rows(b, 50, seed)
    assert torch.equal(wa, wb)


def test_other_seed_other_data():
    a = datagen.make(SPEC, 2 ** 31 + 1, "cpu")
    b = datagen.make(SPEC, 2 ** 31 + 2, "cpu")
    assert not torch.equal(a.X, b.X) and not torch.equal(a.pool, b.pool)


def _trace(seed):
    t = loadgen.Traffic(MIX, seed, pool_size=100, n_rows=2000)
    calls = [t.next_call() for _ in range(50)]
    writes = [t.next_write() for _ in range(20)]
    return calls, writes, t.warmup_calls()


def test_traffic_is_a_function_of_the_seed():
    (c1, w1, u1), (c2, w2, u2) = _trace(2 ** 31 + 9), _trace(2 ** 31 + 9)
    for a, b in zip(c1 + u1, c2 + u2):
        assert a.cls == b.cls and np.array_equal(a.qidx, b.qidx)
        assert a.predicate == b.predicate
    for a, b in zip(w1, w2):
        assert np.array_equal(a.upsert_ids, b.upsert_ids)
        assert np.array_equal(a.delete_ids, b.delete_ids)
    c3, _, _ = _trace(2 ** 31 + 10)
    assert any(not np.array_equal(a.qidx, b.qidx) for a, b in zip(c1, c3))


def test_calls_and_writes_keep_their_shape():
    calls, writes, warm = _trace(3)
    assert {c.cls for c in warm} == {0, 1}
    for c in calls:
        assert len(c.qidx) == (16, 8)[c.cls]
        assert len(np.unique(c.qidx)) == len(c.qidx)
        if c.cls == 1:
            col, op, v = c.predicate
            assert (col, op) == (1, "lt") and 0.1 <= v <= 0.5
    live = set(range(2000))
    for i, w in enumerate(writes, 1):
        assert w.version == i and len(w.upsert_ids) == 7
        assert set(w.upsert_ids[:3]) <= live          # overwrites
        assert not set(w.upsert_ids[3:]) & live       # new ids
        live |= set(w.upsert_ids.tolist())
        assert set(w.delete_ids) <= live
        assert not set(w.delete_ids) & set(w.upsert_ids)
        live -= set(w.delete_ids.tolist())


def test_window_calls_are_drawn_ahead_in_order():
    """The harness draws the window's calls with their query vectors and
    specs in set-up, in next_call's order."""
    pool = np.arange(100 * 4, dtype=np.float32).reshape(100, 4)
    t = loadgen.Traffic(MIX, 2 ** 31 + 5, pool_size=100, n_rows=2000)
    got = harness._draw_ahead(t, pool, lambda c: ("spec", c.cls), 6)
    want = _trace(2 ** 31 + 5)[0][:6]
    assert len(got) == 6
    for (c, q, spec), w in zip(got, want):
        assert np.array_equal(c.qidx, w.qidx) and c.cls == w.cls
        assert spec == ("spec", c.cls)
        assert np.array_equal(q, pool[c.qidx])


def test_writes_until_stops_at_the_window():
    t = loadgen.Traffic(MIX, 11, pool_size=100, n_rows=2000)
    ws = t.writes_until(1.05)
    assert [w.version for w in ws] == list(range(1, 11))
    assert ws[-1].due_s <= 1.05
    quiet = dict(MIX, writes=None)
    assert loadgen.Traffic(quiet, 11, 100, 2000).writes_until(5.0) == []
