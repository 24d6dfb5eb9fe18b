"""A whole run of each cell at a tiny size on the CPU: the result line's
keys and metrics, run.py's refusals, and that nothing a run loads is JAX
or the JAX package (top-level names compared whole, in a fresh process)."""
import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from perfbench import bench, harness, run, tiny

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in bench.default_bench().data["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_and_is_correct(cell, trace, tmp_path):
    b = bench.default_bench()
    r = tiny.run(cell, trace=trace, workdir=tmp_path)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = b.metrics(cell, trace)
    assert {m["name"] for m in want} - set(r["metrics"]) <= \
        {"sq_scan_topk_roofline", "ivf_scan_topk_roofline"}   # card only
    for m in want:
        if m["name"] in r["metrics"]:
            assert r["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        assert "busy_s" in r["device"] and r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    assert list(r)[-1] == "checks"
    assert not list(tmp_path.glob("*.sqlite*"))


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core.query",
                                  "numpy", "jax_like", "flaxen"]) == []
    assert run.forbidden_modules(["repro.core.ivf", "jaxlib.xla_client",
                                  "flax", "jax"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_no_jax():
    """A fresh process drives a whole tiny run and lists the top-level
    modules it holds once the window has closed."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench import tiny, run\n"
        "r = tiny.run('sift1m-int8-resident.knn-b512', trace=True)\n"
        "print(json.dumps({'correct': r['correct'],\n"
        "                  'bad': run.forbidden_modules(),\n"
        "                  'torch': 'repro_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": [], "torch": True}


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would measure it")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_run_py_last_line(monkeypatch):
    """run.main end to end with the card's look stubbed and the cell shrunk:
    the last stdout line is the result with `checks` last, and the last
    stderr lines are the checks."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "unset")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = harness.run_cell

    def on_cpu(b, workload, seed, seconds, trace, device, t_start):
        return real(b, workload, seed, seconds, trace, "cpu", t_start,
                    overrides=tiny.OVERRIDES)

    monkeypatch.setattr(harness, "run_cell", on_cpu)
    monkeypatch.setattr(run, "_power_limit", lambda: None)
    # a test worker may hold JAX from other test files; the import check
    # itself runs in a fresh process in test_a_run_loads_no_jax
    monkeypatch.setattr(run, "forbidden_modules", lambda names=None: [])
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", CELLS[1], "--seed", str(2 ** 31 + 3),
                       "--seconds", "0.5", "--trace", "0"])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    # the NYTimes cell reads its rate per layer (BENCHMARK.json)
    assert set(line["metrics"]) == {"recall_at_100", "setup_s"}
    tail = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == \
        [f"check {k}" for k in line["checks"]]
