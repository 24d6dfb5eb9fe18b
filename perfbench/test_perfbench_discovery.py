"""A later PR adds a configuration, a traffic mix and a per-layer metric as
new files and new entries, and the harness runs them without an edit to
any file that is there. The mix here also writes (upserts of new ids,
overwrites, deletes) and filters, so the check covers the delta merge,
deletes and the read-back of acknowledged writes."""
import filecmp
import json
import shutil
from pathlib import Path

import pytest

from perfbench import bench, harness

ROOT = Path(__file__).resolve().parents[1]
CELL = "tiny-writes.filtered-writes"

CONFIG = {
    "name": "tiny-writes",
    "data": {"generator": "mixture", "rows": 2500, "dim": 16,
             "metric": "l2", "clusters": 5, "pool": 120,
             "attrs": [{"kind": "int", "low": 0, "high": 4},
                       {"kind": "uniform"}]},
    "engine": {"quantize": "int8", "rerank_factor": 4,
               "ivf": {"target_partition_size": 100, "delta_capacity": 64}},
    "ingest_rows": 1000,
    "reference": "exact_knn",
    "limits": {"recall_at_least": 0.8, "score_gap_at_most": 1e-05},
}
MIX = {
    "loop": "closed", "callers": 1,
    "calls": [
        {"weight": 1, "batch": 16, "spec": {"kind": "ann", "k": 10,
                                            "n_probe": 8}},
        {"weight": 1, "batch": 8,
         "spec": {"kind": "ann", "k": 10, "n_probe": 25, "hybrid": "post"},
         "predicate": {"col": 0, "op": "eq", "value": {"int": [0, 3]}}},
    ],
    "writes": {"period_ms": 40, "upsert_new": 4, "upsert_overwrite": 3,
               "delete": 2},
    "warmup_calls": 2, "profile_seconds": 0.3,
}
METRIC = '''"""client.call_p50_ms: the median call of the window."""
from perfbench import yardstick


def read(run):
    return yardstick.percentile(run.call_ms, 50) if run.call_ms else None
'''


@pytest.fixture
def later_bench(tmp_path):
    """The benchmark as a later PR leaves it: every existing file copied
    unchanged, and new files and entries added."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "perfbench"
    (new / "configs" / "tiny-writes.json").write_text(json.dumps(CONFIG))
    (new / "traffic" / "filtered-writes.json").write_text(json.dumps(MIX))
    (new / "metrics" / "client.call_p50_ms.py").write_text(METRIC)
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "tiny-writes", "source": "a test",
                            "file": "perfbench/configs/tiny-writes.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": CELL, "config": "tiny-writes",
                              "traffic": "filtered-writes", "chips": 1,
                              "why": "a test"})
    for m in data["end_to_end"]:
        if m["name"] == "queries_per_s":
            m["workloads"].append(CELL)
    data["per_layer"].append({"name": "client.call_p50_ms", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "client", "moves": "queries_per_s",
                              "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    yield bench.Bench(tmp_path / "BENCHMARK.json")
    cmp = filecmp.dircmp(ROOT / "perfbench", new,
                         ignore=["__pycache__"])
    assert not cmp.diff_files


def _run(b, tmp_path, trace=False):
    return harness.run_cell(b, CELL, seed=2 ** 31 + 21, seconds=1.2,
                            trace=trace, device="cpu",
                            workdir=tmp_path / "work")


def test_added_files_run_without_an_edit(later_bench, tmp_path):
    r = _run(later_bench, tmp_path, trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["client.call_p50_ms"]["unit"] == "ms"
    assert r["attempted"] >= 1


@pytest.mark.parametrize("fault", ["deletes_ignored", "upserts_lost"])
def test_a_dropped_write_is_not_correct(later_bench, tmp_path, monkeypatch,
                                        fault):
    from repro_torch.storage import engine
    if fault == "deletes_ignored":
        monkeypatch.setattr(engine.WriteSession, "delete",
                            lambda self, ids: None)
    else:
        real = engine.WriteSession.upsert

        def first_half(self, ids, vecs, attrs=None):
            h = max(1, len(ids) // 2)
            return real(self, ids[:h], vecs[:h],
                        None if attrs is None else attrs[:h])
        monkeypatch.setattr(engine.WriteSession, "upsert", first_half)
    r = _run(later_bench, tmp_path)
    assert not r["correct"]
