"""The disk-resident cell (sift1m-int8-paged10mb.knn-b64) and the
filtered-search-under-writes cell (sift1m-int8-resident.hybrid-writes) at a
small size on the CPU, through harness.run_cell with the cells' own mixes
and overrides of scale only:

- paged: a pool of a few frames, so every call's union streams through it
  with evictions; every answer correct and the pool's resident bytes never
  above its budget;
- hybrid: both of the planner's plans taken (the planner's own counter),
  inline delta flushes, the read-back of every acknowledged write;
- two faults that must come out not correct: the paged rerank skipped (the
  scan's int8 scores reported: the score gap catches it), and the attr1
  class at n_probe 8 on a table whose Eq. 2 factor (n_probe / partitions,
  0.0008 as at 1M rows of 100) sends most calls to the post-filter (recall
  catches it), where n_probe 64 pre-filters every call and is correct.

The hybrid cell is held out of BENCHMARK.json until perfbench/control.py
takes mixes that write; these tests run it from an in-memory copy of the
benchmark with its workload entry added, and read its three readers
(planner.prefilter_share, store.write_ms, delta.flush_ms) directly.
"""
import copy
from pathlib import Path

import pytest
import torch

from perfbench import bench, counters, harness

PAGED = "sift1m-int8-paged10mb.knn-b64"
HYBRID = "sift1m-int8-resident.hybrid-writes"
HYBRID_CELL = {"name": HYBRID, "config": "sift1m-int8-resident",
               "traffic": "hybrid-writes", "chips": 1,
               "why": "filtered search under writes"}
SEED = 2 ** 31 + 2701
METRICS = Path(__file__).resolve().parent / "metrics"


def _bench():
    """The benchmark with the hybrid cell's workload entry (a fresh copy:
    the cached default stays as the file has it)."""
    b = bench.Bench(bench.default_bench().path)
    if HYBRID not in [w["name"] for w in b.data["workloads"]]:
        b.data["workloads"].append(dict(HYBRID_CELL))
    return b


def _read(metric):
    """A counter reader's value (these readers do not look at the run)."""
    return bench.load_module(METRICS / f"{metric}.py", "metric").read(None)


def _mix(cell, **call):
    """The cell's own mix with each call class's fields replaced by
    `call` (a smaller batch or k for the CPU)."""
    b = _bench()
    mix = copy.deepcopy(b.traffic(b.workload(cell)["traffic"]))
    for c in mix["calls"]:
        for key, v in call.items():
            if key == "spec":
                c["spec"].update(v)
            else:
                c[key] = v
    return mix


def _run(cell, overrides, tmp_path, monkeypatch, seconds=1.5):
    """One run of the cell on the CPU; returns (result, the engine)."""
    got = {}
    real = harness._engine

    def keep(cfg, path, device):
        got["eng"] = real(cfg, path, device)
        return got["eng"]

    monkeypatch.setattr(harness, "_engine", keep)
    r = harness.run_cell(_bench(), cell, seed=SEED,
                         seconds=seconds, trace=False, device="cpu",
                         overrides=overrides, workdir=tmp_path)
    return r, got["eng"]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# 6,000 rows in 60 partitions; 0.04 MiB seats a handful of frames
PAGED_SMALL = {"data": {"rows": 6000, "pool": 200, "clusters": 12,
                        "dim": 32},
               "engine": {"memory_budget_mb": 0.04}}


def _paged_overrides():
    return dict(PAGED_SMALL, mix=_mix(PAGED, batch=16, warmup_calls=2))


def test_paged_cell_streams_through_a_small_pool(tmp_path, monkeypatch):
    from repro_torch.storage.pager import PartitionCache
    worst = {"over": 0, "faults": 0}
    real = PartitionCache.fault

    def fault(self, pids, admit=True):
        frames = real(self, pids, admit)
        worst["faults"] += 1
        worst["over"] = max(worst["over"],
                            self.resident_bytes - self.budget_bytes)
        return frames

    monkeypatch.setattr(PartitionCache, "fault", fault)
    r, eng = _run(PAGED, _paged_overrides(), tmp_path, monkeypatch)
    assert r["correct"], r["checks"]
    cache = eng.index.cache
    assert cache.capacity < 20 and cache.evictions > 0
    assert worst["faults"] > r["attempted"]       # chunked: several a call
    assert worst["over"] <= 0
    assert cache.resident_bytes <= cache.budget_bytes
    assert counters.counter("rows_read", component="store") > 0
    # no predicate and no writes: the hybrid cell's readers read nothing
    assert _read("planner.prefilter_share") is None
    assert _read("delta.flush_ms") is None
    assert _read("store.write_ms") is None


def test_paged_rerank_skipped_is_not_correct(tmp_path, monkeypatch):
    """The int8 scan's own top-k and scores stand in for the float32
    rerank from SQLite."""
    from repro_torch.core import executor
    scan = {}
    real_merge = executor.merge_topk

    def merge(*a, **kw):
        scan["s"], scan["i"] = real_merge(*a, **kw)
        return scan["s"], scan["i"]

    def no_rerank(store, q, cand_ids, k_out, metric):
        return scan["s"][:, :k_out], cand_ids[:, :k_out]

    monkeypatch.setattr(executor, "merge_topk", merge)
    monkeypatch.setattr(executor, "_rerank_from_store", no_rerank)
    r, _ = _run(PAGED, _paged_overrides(), tmp_path, monkeypatch)
    assert not r["correct"]
    gap = r["checks"]["score_gap"]
    assert gap["value"] > gap["at_most"]


# 40,000 rows of width 16 (the mixture's clusters of 500 rows)
HYBRID_DATA = {"rows": 40000, "pool": 300, "clusters": 80, "dim": 16}


def test_hybrid_cell_takes_both_plans_and_reads_back_writes(
        tmp_path, monkeypatch, capsys):
    """Partitions of 20 rows: the mix's n_probe 64 gives Eq. 2's factor
    0.032, above every attr1 threshold (pre) and below attr0's 0.1
    (post). A delta of 64 rows fills every second write batch."""
    over = {"data": HYBRID_DATA,
            "engine": {"ivf": {"target_partition_size": 20,
                               "delta_capacity": 64}},
            "mix": _mix(HYBRID, batch=16, spec={"k": 10},
                        warmup_calls=4)}
    r, _ = _run(HYBRID, over, tmp_path, monkeypatch, seconds=2.0)
    assert r["correct"], r["checks"]
    pre = counters.counter("plans", component="planner", plan="pre")
    post = counters.counter("plans", component="planner", plan="post")
    assert pre > 0 and post > 0
    assert counters.write_stage_ms("commit") is not None
    assert counters.write_stage_ms("flush") is not None
    h = counters.histogram("stage_s", component="engine", action="write",
                           stage="flush")
    assert h["count"] >= 1
    assert 0 < _read("planner.prefilter_share") < 100
    assert _read("store.write_ms") > 0 and _read("delta.flush_ms") > 0
    readback = [ln for ln in capsys.readouterr().err.splitlines()
                if "readback=" in ln]
    assert int(readback[-1].split("readback=")[1]) > 0


@pytest.mark.parametrize("n_probe,correct", [(8, False), (64, True)])
def test_attr1_class_needs_n_probe_64(tmp_path, monkeypatch, n_probe,
                                      correct):
    """10,000 partitions of 4 rows: n_probe 8 gives the factor 0.0008 of
    the cell's 1M rows at n_probe 8, so thresholds below it go to the
    post-filter, which finds almost none of their rows; n_probe 64 (0.0064)
    pre-filters every call."""
    mix = _mix(HYBRID, batch=16, spec={"n_probe": n_probe},
               warmup_calls=2)
    mix["calls"] = [c for c in mix["calls"] if c["predicate"]["col"] == 1]
    mix["writes"] = None
    over = {"data": HYBRID_DATA,
            "engine": {"ivf": {"target_partition_size": 4}}, "mix": mix}
    r, _ = _run(HYBRID, over, tmp_path, monkeypatch)
    post = counters.counter("plans", component="planner", plan="post")
    assert r["correct"] is correct, r["checks"]
    if correct:
        assert post == 0
    else:
        assert post > 0
        rec = r["checks"]["recall"]
        assert rec["value"] < rec["at_least"]


@pytest.mark.parametrize("snapshot", [None, {"counters": {},
                                             "histograms": {}}],
                         ids=["no_registry", "no_series"])
def test_counter_readers_read_nothing_without_the_series(monkeypatch,
                                                         snapshot):
    """A program without the counters (the parent of the PR that added
    them) gives every counter reader nothing, and none raises."""
    monkeypatch.setattr(counters, "_snapshot", lambda: snapshot)
    for metric in ("pager.hit_share", "planner.prefilter_share",
                   "store.write_ms", "delta.flush_ms"):
        assert _read(metric) is None
    run = harness.Run(workload=PAGED, config={}, mix={}, setup={},
                      device_kind="cpu")
    run.call_ms, run.queries = [1.0], 64
    reader = bench.load_module(METRICS / "store.read_kb_per_query.py",
                               "metric")
    assert reader.read(run) is None
