"""Each CUDA kernel against its plain PyTorch version on the card, and the
engine on the card against the same engine on the CPU.

Marked `gpu`: every test takes the `cuda` fixture, which skips when no
CUDA device is present (decided at run time, never at import, so every
test worker collects the same tests). On a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_gpu.py

Tolerance: as in tests/test_torch_kernels.py -- scores within 1e-5 *
(||q||^2 + max ||v||^2), ids equal outside runs of tied scores. The int8
scan's accumulators are exact, so its scores over the precomputed norms
must match the plain version bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import executor, ivf, quantize, query
from repro_torch.core.hybrid import And, Or, Pred, compile_filter
from repro_torch.core.types import IVFConfig
from repro_torch.kernels import common, ivf_scan, kmeans_assign, ops, sq_scan
from repro_torch.storage.engine import MicroNN
from repro_torch.testing import compare_topk, score_tol

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, seed=0, kp=200, p_max=72, d=64, n_q=16, n_probe=6,
            p_valid=0.9):
    g = torch.Generator().manual_seed(seed)
    vec = torch.randn((kp, p_max, d), generator=g) * 3
    valid = torch.rand((kp, p_max), generator=g) < p_valid
    ids = torch.arange(kp * p_max, dtype=torch.int32).reshape(kp, p_max)
    attrs = torch.randint(0, 4, (kp, p_max, 2), generator=g).float()
    q = vec[torch.randint(0, kp, (n_q,), generator=g), 0] \
        + 0.1 * torch.randn((n_q, d), generator=g)
    parts = torch.stack([torch.randperm(kp, generator=g)[:n_probe]
                         for _ in range(n_q)])
    union = torch.unique(parts).to(torch.int32)
    qsel = (parts[:, :, None] == union[None, None, :].long()).any(1)
    out = dict(vec=vec, valid=valid, ids=ids, attrs=attrs, q=q,
               union=union, qsel=qsel)
    return {k: v.to(dev) for k, v in out.items()}


def _tol(x):
    v2 = float(torch.sum(x["vec"] ** 2, -1).max())
    return score_tol(x["q"].cpu().numpy(), v2)


def _same(ref, got, tol):
    torch.cuda.synchronize()
    err, ok, bad = compare_topk(ref[0].cpu().numpy(), ref[1].cpu().numpy(),
                                got[0].cpu().numpy(), got[1].cpu().numpy(),
                                tol)
    assert ok, f"{bad} rows differ (max err {err:.3e})"
    return err


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("with_qsel", [False, True])
@pytest.mark.parametrize("with_keep", [False, True])
def test_ivf_scan_kernel_matches_plain(cuda, metric, with_qsel, with_keep):
    x = _inputs(cuda)
    keep = compile_filter(Pred(0, ">=", 2))(x["attrs"]) if with_keep \
        else None
    qsel = x["qsel"] if with_qsel else None
    args = (x["q"], x["vec"], x["valid"], x["ids"], x["union"], 50, metric,
            qsel, keep)
    before = ivf_scan.LAUNCHES
    got = ivf_scan.ivf_scan_topk(*args[:6], metric=metric, qsel=qsel,
                                 keep=keep)
    assert ivf_scan.LAUNCHES == before + 1
    _same(ivf_scan.ivf_scan_plain(*args), got, _tol(x))


@pytest.mark.parametrize("p_valid", [0.0, 0.02])
def test_ivf_scan_kernel_exhausted_buffer(cuda, p_valid):
    # all rows masked / fewer rows than k_out: (MASKED, -1), no repeats
    x = _inputs(cuda, seed=1, p_valid=p_valid)
    args = (x["q"], x["vec"], x["valid"], x["ids"], x["union"], 300, "l2",
            x["qsel"], None)
    got = ivf_scan.ivf_scan_topk(*args[:6], qsel=x["qsel"])
    _same(ivf_scan.ivf_scan_plain(*args), got, _tol(x))
    ids = got[1].cpu().numpy()
    for row in ids:
        r = row[row >= 0]
        assert len(set(r.tolist())) == len(r)


def test_ivf_scan_kernel_wide_partitions_and_k(cuda):
    # p_max above the 1024-row tile and k_out above the block size
    x = _inputs(cuda, seed=2, kp=12, p_max=1500, d=36, n_q=5, n_probe=3)
    args = (x["q"], x["vec"], x["valid"], x["ids"], x["union"], 700, "l2",
            x["qsel"], None)
    got = ivf_scan.ivf_scan_topk(*args[:6], qsel=x["qsel"])
    _same(ivf_scan.ivf_scan_plain(*args), got, _tol(x))


def test_scan_kernels_width_not_multiple_of_4(cuda):
    # d % 4 != 0 takes the kernels' scalar load paths (no float4 / packed
    # int8 words)
    x = _inputs(cuda, seed=7, d=30)
    args = (x["q"], x["vec"], x["valid"], x["ids"], x["union"], 60, "l2",
            x["qsel"], None)
    got = ivf_scan.ivf_scan_topk(*args[:6], qsel=x["qsel"])
    _same(ivf_scan.ivf_scan_plain(*args), got, _tol(x))
    st = quantize.train(x["vec"].reshape(-1, 30))
    codes = quantize.encode(st, x["vec"])
    q_i8, alpha, beta = quantize.fold_queries(st, x["q"])
    for norms in (quantize.row_norms(st, codes), None):
        sq = (q_i8, alpha, beta, st.lo, st.scale, codes, x["valid"], None,
              x["union"], 90, "l2", x["qsel"], None, norms)
        got = sq_scan.sq_scan_folded(*sq[:10], qsel=x["qsel"], norms=norms)
        err = _same(sq_scan.sq_scan_plain(*sq), got, _tol(x))
        if norms is not None:
            assert err == 0.0      # byte loads: still exact accumulators


@pytest.mark.parametrize("metric,with_norms",
                         [("l2", True), ("l2", False), ("ip", False)])
def test_sq_scan_kernel_matches_plain(cuda, metric, with_norms):
    x = _inputs(cuda, seed=3)
    st = quantize.train(x["vec"].reshape(-1, x["vec"].shape[-1]))
    codes = quantize.encode(st, x["vec"])
    norms = quantize.row_norms(st, codes) if with_norms else None
    q_i8, alpha, beta = quantize.fold_queries(st, x["q"])
    args = (q_i8, alpha, beta, st.lo, st.scale, codes, x["valid"], None,
            x["union"], 120, metric, x["qsel"], None, norms)
    before = sq_scan.LAUNCHES
    got = sq_scan.sq_scan_folded(*args[:10], metric=metric, qsel=x["qsel"],
                                 norms=norms)
    assert sq_scan.LAUNCHES == before + 1
    err = _same(sq_scan.sq_scan_plain(*args), got, _tol(x))
    if with_norms:
        assert err == 0.0      # exact accumulators, same epilogue order


def _check_assign(batch, cents, pen, a_k, c_k, agree=0.999):
    """Costs within the tolerance of the plain version's, and a different
    arg-min only where the two centroids' exact (float64) costs tie."""
    a_r, c_r = kmeans_assign.kmeans_assign_plain(batch, cents, pen)
    torch.cuda.synchronize()
    tol = 1e-5 * (torch.sum(batch ** 2, -1)
                  + float(torch.sum(cents ** 2, -1).max()))
    assert bool(((c_r - c_k).abs() <= tol).all())
    x64, c64 = batch.double(), cents.double()

    def exact(a):
        return ((x64 - c64[a.long()]) ** 2).sum(-1) + pen.double()[a.long()]
    assert bool(((exact(a_r) - exact(a_k)).abs() <= tol).all())
    assert float((a_r == a_k).float().mean()) >= agree


# (s, k, d): ragged rows and centroids (3000, 1000), the build's ragged
# last batch of 1M rows (576), k not a multiple of the 128 tile (10,000
# and 97), and widths 30 and 40 (4-byte / 16-byte copies), 128 (resident
# row tile) and 960 (rows streamed beside the centroids)
@pytest.mark.parametrize("s,k,d", [(3000, 1000, 40), (576, 10000, 128),
                                   (4096, 97, 128), (300, 1000, 30),
                                   (520, 700, 960)])
@pytest.mark.parametrize("balance_weight", [0.0, 1.0])
def test_kmeans_assign_kernel_matches_plain(cuda, s, k, d, balance_weight):
    g = torch.Generator().manual_seed(s + k + d)
    cents = (torch.randn((k, d), generator=g) * 3).to(cuda)
    batch = (cents[torch.randint(0, k, (s,), generator=g).to(cuda)]
             + torch.randn((s, d), generator=g).to(cuda))
    counts = (torch.rand((k,), generator=g) * 80).to(cuda)
    pen = kmeans_assign.balance_penalty(counts, balance_weight, 50, 2.0)
    before = kmeans_assign.LAUNCHES
    a_k, c_k = kmeans_assign.kmeans_assign(batch, cents, counts,
                                           balance_weight=balance_weight,
                                           target_size=50, scale=2.0)
    assert kmeans_assign.LAUNCHES == before + 1
    _check_assign(batch, cents, pen, a_k, c_k)


def test_kmeans_assign_kernel_duplicate_centroids_first_index(cuda):
    # exact duplicates give bit-equal costs: the first index must win,
    # within one thread's columns (9 / 25), across the threads of a tile
    # (7 / 60), across tiles (3 / 700) and across the centroid groups of
    # blockIdx.y (5 / 9000)
    g = torch.Generator().manual_seed(8)
    cents = torch.randn((10000, 128), generator=g) * 3
    for first, dup in ((9, 25), (7, 60), (3, 700), (5, 9000)):
        cents[dup] = cents[first]
    cents = cents.to(cuda)
    firsts = torch.tensor([9, 7, 3, 5] * 100, device=cuda)
    batch = cents[firsts] + 0.01 * torch.randn(
        (400, 128), generator=g).to(cuda)
    zero = torch.zeros((10000,), device=cuda)
    a_k, c_k = kmeans_assign.kmeans_assign(batch, cents, zero)
    torch.cuda.synchronize()
    assert torch.equal(a_k.long(), firsts)
    # the plain version's own tie order is torch.min's: not compared
    _check_assign(batch, cents, zero, a_k, c_k, agree=0.0)


def _assert_no_repeats(ids):
    """No id twice in a row, and -1 only in the tail."""
    for row in ids:
        r = row[row >= 0]
        assert len(set(r.tolist())) == len(r)
        assert (row[len(r):] == -1).all()


def _scan_case(dev, case):
    """Inputs of one scan edge case -> (x, k_out, qsel, keep)."""
    kw = {}
    if case == "k400_pmax568":
        kw = dict(kp=300, p_max=568, d=128, n_q=32, n_probe=8, p_valid=0.25)
    elif case.startswith("d960"):
        kw = dict(kp=40, p_max=96, d=960, n_q=12, n_probe=4)
    x = _inputs(dev, seed=11, **kw)
    qsel, keep, k_out = x["qsel"], None, 120
    if case == "holes":
        # valid rows are not a prefix, and every 7th partition is empty
        g = torch.Generator().manual_seed(12)
        x["valid"] = (torch.rand(x["valid"].shape, generator=g) < 0.4
                      ).to(dev)
        x["valid"][::7] = False
    elif case == "empty_qsel_row":
        qsel = qsel.clone()
        qsel[0] = False
        qsel[5, :] = False
    elif case == "k_above_rows":
        g = torch.Generator().manual_seed(13)
        x["valid"] &= (torch.rand(x["valid"].shape, generator=g) < 0.02
                       ).to(dev)
        k_out = 700
    elif case in ("exact", "d960_exact"):
        qsel = None
    elif case == "keep":
        keep = compile_filter(Pred(0, ">=", 2))(x["attrs"])
    elif case == "k400_pmax568":
        k_out = 400
    return x, k_out, qsel, keep


@pytest.mark.parametrize("case", ["holes", "empty_qsel_row", "k_above_rows",
                                  "exact", "keep", "k400_pmax568"])
def test_sq_scan_kernel_cases(cuda, case):
    # each case on both routes: precomputed norms (bit for bit) and the
    # in-scan decode (within tolerance)
    x, k_out, qsel, keep = _scan_case(cuda, case)
    d = x["vec"].shape[-1]
    st = quantize.train(x["vec"].reshape(-1, d))
    codes = quantize.encode(st, x["vec"])
    q_i8, alpha, beta = quantize.fold_queries(st, x["q"])
    for norms in (quantize.row_norms(st, codes), None):
        args = (q_i8, alpha, beta, st.lo, st.scale, codes, x["valid"], None,
                x["union"], k_out, "l2", qsel, keep, norms)
        got = sq_scan.sq_scan_folded(*args[:10], qsel=qsel, keep=keep,
                                     norms=norms)
        err = _same(sq_scan.sq_scan_plain(*args), got, _tol(x))
        if norms is not None:
            assert err == 0.0
        ids = got[1].cpu().numpy()
        _assert_no_repeats(ids)
        if case == "empty_qsel_row":
            assert (ids[0] == -1).all() and (ids[5] == -1).all()


# K2's case set, plus the paper's GIST width (960) with and without qsel
@pytest.mark.parametrize("case", ["holes", "empty_qsel_row", "k_above_rows",
                                  "exact", "keep", "k400_pmax568", "d960",
                                  "d960_exact"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ivf_scan_kernel_cases(cuda, case, metric):
    x, k_out, qsel, keep = _scan_case(cuda, case)
    args = (x["q"], x["vec"], x["valid"], x["ids"], x["union"], k_out,
            metric, qsel, keep)
    got = ivf_scan.ivf_scan_topk(*args[:6], metric=metric, qsel=qsel,
                                 keep=keep)
    _same(ivf_scan.ivf_scan_plain(*args), got, _tol(x))
    ids = got[1].cpu().numpy()
    _assert_no_repeats(ids)
    if case == "empty_qsel_row":
        assert (ids[0] == -1).all() and (ids[5] == -1).all()


@pytest.mark.parametrize("route", ["ann", "exact"])
def test_ivf_scan_kernel_solo_equals_batched_bitwise(cuda, route,
                                                     monkeypatch):
    # the port contract "coalesced == solo bitwise": a row's score does not
    # depend on the batch, the chunking or the query group, so a query's
    # scores and ids are bit-identical alone, inside a batch of 32, and
    # under plans with other chunk counts (and, exact, with query groups of
    # 1, 2 and 4 instead of 8)
    x = _inputs(cuda, seed=21, n_q=32, n_probe=8)
    qsel = x["qsel"] if route == "ann" else None

    def scan(rows):
        sel = None if qsel is None else qsel[rows]
        return ivf_scan.ivf_scan_topk(x["q"][rows], x["vec"], x["valid"],
                                      x["ids"], x["union"], 60, qsel=sel)
    whole = scan(slice(0, 32))
    torch.cuda.synchronize()
    for i in (0, 7, 31):
        solo = scan(slice(i, i + 1))
        assert torch.equal(solo[0], whole[0][i:i + 1])
        assert torch.equal(solo[1], whole[1][i:i + 1])
    variants = [("scan_plan", common, lambda *a, **k: 1),
                ("scan_plan", common, lambda *a, **k: 5)]
    if route == "exact":
        variants += [("MAX_GROUP", ivf_scan, g) for g in (1, 2, 4)]
    for attr, owner, value in variants:
        with monkeypatch.context() as mp:
            mp.setattr(owner, attr, value)
            got = scan(slice(0, 32))
        assert torch.equal(got[0], whole[0]), (attr, value)
        assert torch.equal(got[1], whole[1]), (attr, value)


@pytest.mark.parametrize("route", ["norms", "decode", "program"])
def test_sq_scan_kernel_solo_equals_batched_bitwise(cuda, route,
                                                    monkeypatch):
    # K2's side of "coalesced == solo bitwise": a query's approximate
    # scores and ids are bit-identical alone, inside a batch of 32 and
    # under plans with other chunk counts -- over precomputed norms,
    # decoding in the kernel, and with a predicate program
    x = _inputs(cuda, seed=22, n_q=32, n_probe=8)
    d = x["vec"].shape[-1]
    st = quantize.train(x["vec"].reshape(-1, d))
    codes = quantize.encode(st, x["vec"])
    norms = quantize.row_norms(st, codes) if route != "decode" else None
    prog = compile_filter(Pred(0, "<", 3)) if route == "program" else None

    def scan(rows):
        q_i8, alpha, beta = quantize.fold_queries(st, x["q"][rows])
        return sq_scan.sq_scan_folded(
            q_i8, alpha, beta, st.lo, st.scale, codes, x["valid"], None,
            x["union"], 120, qsel=x["qsel"][rows], norms=norms,
            attrs=x["attrs"] if prog is not None else None,
            program=None if prog is None else prog.program)
    whole = scan(slice(0, 32))
    torch.cuda.synchronize()
    for i in (0, 7, 31):
        solo = scan(slice(i, i + 1))
        assert torch.equal(solo[0], whole[0][i:i + 1])
        assert torch.equal(solo[1], whole[1][i:i + 1])
    for chunks in (1, 5):
        with monkeypatch.context() as mp:
            mp.setattr(common, "scan_plan", lambda *a, **k: chunks)
            got = scan(slice(0, 32))
        assert torch.equal(got[0], whole[0]), chunks
        assert torch.equal(got[1], whole[1]), chunks


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_executor_slices_batches_above_the_grid_limit(cuda, tier):
    # Q = 40,000 pads to a bucket of 65,536, above pass 1's 65,535 grid
    # rows: the wrappers launch it as two slices of 32,768, and the answer
    # equals the two slices' own runs bit for bit (K1 on f32, K2 on int8)
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(30, 32)).astype(np.float32) * 5
    X = (centers[rng.integers(0, 30, 4000)]
         + rng.normal(size=(4000, 32))).astype(np.float32)
    cfg = IVFConfig(dim=32, target_partition_size=50, kmeans_iters=10,
                    quantize=tier)
    idx = _to(ivf.build_index(X, cfg=cfg, device="cpu"), cuda)
    q = X[rng.integers(0, 4000, 40000)] + 0.2 * rng.normal(size=(40000, 32))
    q = q.astype(np.float32)
    spec = query.Q.knn(k=10, n_probe=4)
    mod = sq_scan if tier == "int8" else ivf_scan
    before = mod.LAUNCHES
    whole = executor.run(idx, q, spec).to_numpy()
    assert mod.LAUNCHES == before + 2
    cut = common.MAX_QUERIES_PER_LAUNCH
    head = executor.run(idx, q[:cut], spec).to_numpy()
    tail = executor.run(idx, q[cut:], spec).to_numpy()
    for a, b in ((whole[0], np.concatenate([head[0], tail[0]])),
                 (whole[1], np.concatenate([head[1], tail[1]]))):
        np.testing.assert_array_equal(a, b)
    assert (whole[0][:, 0] >= 0).all()


# the last: a 33-value IN-list, whose Or folds its results every 8 leaves
PROGRAM_PREDS = [Pred(1, "<", 0.3), Pred(0, "==", 3),
                 And((Pred(0, "!=", 2),
                      Or((Pred(1, ">=", 0.5), Pred(0, "<", 1))))),
                 Or(tuple(Pred(0, "==", v)
                          for v in [1.0, 3.0] + [10.0 + i for i in range(31)]))]


@pytest.mark.parametrize("route", ["ann", "exact", "frames"])
@pytest.mark.parametrize("pred", PROGRAM_PREDS,
                         ids=["lt", "eq", "tree", "in-list"])
def test_scan_kernels_program_route_equals_mask_route(cuda, route, pred):
    """The predicate program evaluated inside K1 and K2 returns what the
    mask route returns, bit for bit, and agrees with the plain version:
    on the ANN route (qsel), K1's exact route (16 queries: row sharing in
    groups of 8) and a frame-pool route (asset ids, K2 over norms)."""
    x = _inputs(cuda, seed=31, n_q=16, n_probe=6)
    g = torch.Generator().manual_seed(32)
    x["attrs"][..., 1] = torch.rand(x["attrs"].shape[:2], generator=g
                                    ).to(cuda)
    qsel = None if route == "exact" else x["qsel"]
    ids = x["ids"]
    if route == "frames":
        ids = (torch.randperm(ids.numel(), generator=g).to(torch.int32)
               .reshape(ids.shape) + 1000).to(cuda)
    f = compile_filter(pred)
    keep = f(x["attrs"])
    tol = _tol(x)
    k1 = (x["q"], x["vec"], x["valid"], ids, x["union"], 50)
    before = ivf_scan.LAUNCHES
    prog = ivf_scan.ivf_scan_topk(*k1, qsel=qsel, attrs=x["attrs"],
                                  program=f.program)
    assert ivf_scan.LAUNCHES == before + 1
    mask = ivf_scan.ivf_scan_topk(*k1, qsel=qsel, keep=keep)
    torch.cuda.synchronize()
    assert torch.equal(prog[0], mask[0]) and torch.equal(prog[1], mask[1])
    _same(ivf_scan.ivf_scan_plain(*k1, qsel=qsel, attrs=x["attrs"],
                                  program=f.program), prog, tol)
    d = x["vec"].shape[-1]
    st = quantize.train(x["vec"].reshape(-1, d))
    codes = quantize.encode(st, x["vec"])
    norms = quantize.row_norms(st, codes)
    q_i8, alpha, beta = quantize.fold_queries(st, x["q"])
    k2 = (q_i8, alpha, beta, st.lo, st.scale, codes, x["valid"],
          ids if route == "frames" else None, x["union"], 120)
    before = sq_scan.LAUNCHES
    prog = sq_scan.sq_scan_folded(*k2, qsel=qsel, norms=norms,
                                  attrs=x["attrs"], program=f.program)
    assert sq_scan.LAUNCHES == before + 1
    mask = sq_scan.sq_scan_folded(*k2, qsel=qsel, norms=norms, keep=keep)
    torch.cuda.synchronize()
    assert torch.equal(prog[0], mask[0]) and torch.equal(prog[1], mask[1])
    err = _same(sq_scan.sq_scan_plain(*k2, qsel=qsel, norms=norms,
                                      attrs=x["attrs"], program=f.program),
                prog, tol)
    assert err == 0.0           # exact accumulators over the norms


def test_scan_kernels_program_edge_values(cuda):
    """Values the kernel must compare exactly as the plain version does:
    the float32 nearest 0.1 (not 0.1 itself), ties at the bound, match
    bits, and a program that keeps nothing."""
    x = _inputs(cuda, seed=33, n_q=8)
    g = torch.Generator().manual_seed(34)
    pool = torch.tensor([0.1, 0.3, 0.5, 0.25, 7.0])
    x["attrs"] = pool[torch.randint(0, 5, x["attrs"].shape, generator=g)
                      ].to(cuda)
    for pred in (Pred(0, "==", 0.1), Pred(1, "<=", 0.3),
                 Pred(0, "match", 3), Or((Pred(0, "!=", 0.1),
                                          Pred(1, "==", 7.0))),
                 Pred(0, ">", 100.0)):
        f = compile_filter(pred)
        k1 = (x["q"], x["vec"], x["valid"], x["ids"], x["union"], 80)
        prog = ivf_scan.ivf_scan_topk(*k1, qsel=x["qsel"], attrs=x["attrs"],
                                      program=f.program)
        mask = ivf_scan.ivf_scan_topk(*k1, qsel=x["qsel"],
                                      keep=f(x["attrs"]))
        torch.cuda.synchronize()
        assert torch.equal(prog[0], mask[0]), pred
        assert torch.equal(prog[1], mask[1]), pred


def _to(index, dev):
    """A copy of an IVFIndex with every tensor on `dev`."""
    def mv(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if dataclasses.is_dataclass(v) and not isinstance(v, IVFConfig):
            return dataclasses.replace(v, **{f.name: mv(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        return v
    return mv(index)


@pytest.mark.parametrize("tier", ["none", "int8"])
def test_executor_on_cuda_matches_cpu(cuda, tier):
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(30, 32)).astype(np.float32) * 5
    X = (centers[rng.integers(0, 30, 4000)]
         + rng.normal(size=(4000, 32))).astype(np.float32)
    attrs = rng.integers(0, 4, (4000, 2)).astype(np.float32)
    cfg = IVFConfig(dim=32, target_partition_size=50, kmeans_iters=10,
                    quantize=tier)
    cpu_idx = ivf.build_index(X, attrs=attrs, cfg=cfg, device="cpu")
    gpu_idx = _to(cpu_idx, cuda)
    q = X[rng.integers(0, 4000, 24)] + 0.2 * rng.normal(size=(24, 32))
    tol = score_tol(q, float((X * X).sum(1).max()))
    for spec in (query.Q.knn(k=20, n_probe=6), query.Q.exact(k=20),
                 query.Q.knn(k=20, n_probe=6).where(Pred(0, "==", 1))
                 .postfilter()):
        a = executor.run(cpu_idx, q, spec)
        b = executor.run(gpu_idx, q, spec)
        err, ok, bad = compare_topk(a.to_numpy()[1], a.to_numpy()[0],
                                    b.to_numpy()[1], b.to_numpy()[0], tol)
        assert ok, (spec, bad, err)


def test_engine_end_to_end_on_cuda(cuda, tmp_path):
    rng = np.random.default_rng(6)
    X = (rng.normal(size=(3000, 32)) * 4).astype(np.float32)
    ops.reset_launch_counts()
    eng = MicroNN(dim=32, n_attr=1, path=str(tmp_path / "e.db"),
                  quantize="int8",
                  config=IVFConfig(dim=32, target_partition_size=40,
                                   kmeans_iters=8))
    assert eng.device.type == "cuda"
    eng.upsert(np.arange(3000), X, np.zeros((3000, 1), np.float32))
    eng.build()
    rs = eng.query(X[:10], query.Q.knn(k=5, n_probe=8))
    assert (rs.to_numpy()[0][:, 0] == np.arange(10)).all()
    eng.query(X[:4], query.Q.knn(k=5).quantized(False))
    counts = ops.launch_counts()
    assert all(c > 0 for c in counts.values()), counts
    eng2 = MicroNN(dim=32, n_attr=1, path=str(tmp_path / "e.db"),
                   quantize="int8",
                   config=IVFConfig(dim=32, target_partition_size=40,
                                    kmeans_iters=8))
    eng2.recover()
    rs2 = eng2.query(X[:10], query.Q.knn(k=5, n_probe=8))
    np.testing.assert_array_equal(rs.to_numpy()[0], rs2.to_numpy()[0])
    eng.close()
    eng2.close()
