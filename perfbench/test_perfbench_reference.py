"""The plain reference against a NumPy brute force at a tiny size, and its
imports: nothing of the program, nothing of JAX."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import bench, checker

ROOT = Path(__file__).resolve().parents[1]
REF = bench.load_module(ROOT / "perfbench" / "references" / "exact_knn.py",
                        "test")


def _np_topk(X, Q, ok, k, metric):
    X, Q = X.astype(np.float64), Q.astype(np.float64)
    if metric == "cosine":
        X = X / np.linalg.norm(X, axis=1, keepdims=True)
        Q = Q / np.linalg.norm(Q, axis=1, keepdims=True)
        d = -(Q @ X.T)
    else:
        d = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    d[:, ~ok] = np.inf
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(d, order, 1)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_exact_topk_matches_numpy(metric):
    g = np.random.default_rng(0)
    X = (g.normal(size=(700, 24)) * 3).astype(np.float32)
    Q = (X[g.integers(0, 700, 40)] + g.normal(size=(40, 24))
         ).astype(np.float32)
    ok = g.random(700) < 0.8
    s, rows = REF.exact_topk(torch.from_numpy(X), torch.from_numpy(ok),
                             torch.from_numpy(Q), 15, metric, row_chunk=256,
                             query_block=16)
    want, want_d = _np_topk(X, Q, ok, 15, metric)
    assert np.array_equal(rows.numpy(), want)
    d, scale = REF.true_dist(torch.from_numpy(Q),
                             torch.from_numpy(X)[rows], metric)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-12, atol=1e-12)
    assert float(((s.double() - d).abs() / scale).max()) < 1e-6


def test_fewer_rows_than_k_pad_with_minus_one():
    X = torch.randn(30, 8)
    ok = torch.zeros(30, dtype=torch.bool)
    ok[:4] = True
    s, rows = REF.exact_topk(X, ok, torch.randn(3, 8), 6, "l2")
    assert (rows[:, 4:] == -1).all() and torch.isinf(s[:, 4:]).all()
    assert set(rows[:, :4].flatten().tolist()) == {0, 1, 2, 3}


def test_predicate_mask_in_float32():
    attrs = torch.tensor([[3.0, 0.1], [4.0, 0.30000001], [3.0, 0.3]])
    assert REF.pred_mask(attrs, (0, "eq", 3.0)).tolist() == [1, 0, 1]
    assert REF.pred_mask(attrs, (1, "lt", 0.3)).tolist() == [1, 0, 0]
    assert REF.pred_mask(attrs, None).all()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10000) * 100
    r = REF._tf32_round(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11


def test_checker_counts_ties_and_faults():
    """recall counts a tied swap as a hit; a repeated id, an id not live
    and scores out of order are bad answers."""
    X = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [3.0, 3.0]])
    pool = torch.tensor([[0.0, 0.0]])
    table = checker.Table(X, torch.zeros(4, 0))
    good = checker.Answer(qidx=np.array([0]), version=0, kind="exact", k=2,
                          predicate=None, ids=np.array([[0, 2]], np.int32),
                          scores=np.array([[0.0, 1.0]], np.float32))
    v = checker.judge(REF, table, pool, [good], "l2")
    assert (v.recall, v.bad_answers, v.exact_misses) == (1.0, 0, 0)
    assert v.score_gap == 0.0
    faults = [np.array([[0, 0]]), np.array([[0, 7]]), np.array([[2, 0]])]
    for ids in faults:
        a = checker.Answer(qidx=np.array([0]), version=0, kind="exact",
                           k=2, predicate=None, ids=ids.astype(np.int32),
                           scores=np.array([[1.0, 0.0]], np.float32))
        v = checker.judge(REF, checker.Table(X, torch.zeros(4, 0)), pool,
                          [a], "l2")
        assert v.bad_answers == 1


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys, json, importlib.util\n"
        f"p = {str(ROOT / 'perfbench' / 'references' / 'exact_knn.py')!r}\n"
        "spec = importlib.util.spec_from_file_location('ref', p)\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                       "perfbench"}
