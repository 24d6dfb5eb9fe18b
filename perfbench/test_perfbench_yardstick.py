"""The frozen arithmetic: percentiles, the kernels' work counts by hand, and
the reduction of a profiler trace (busy and idle time, a wrapper's device
time by launch correlation, idle gaps by the innermost host range)."""
import numpy as np
import pytest
import torch

from perfbench import devtrace, yardstick


def test_percentile_is_numpys_linear():
    g = np.random.default_rng(1)
    xs = list(g.random(101) * 7)
    for q in (0, 50, 95, 99, 100):
        assert yardstick.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)


def test_work_counts_by_hand():
    valid = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 0], [1, 0, 0, 0]],
                         dtype=torch.bool)                 # 2, 3, 1 rows
    part_ids = torch.tensor([0, 1, 2], dtype=torch.int32)
    qsel = torch.tensor([[1, 1, 0], [0, 1, 0]], dtype=torch.bool)
    q = torch.zeros(2, 8)
    w = yardstick.sq_scan_work(q, valid, part_ids, 5, "l2", qsel)
    # partitions 0 and 1 selected: 5 rows of codes (8 B) and norms (4 B);
    # valid bytes 2 x 4; probe list 3 x 4; queries 2 x 8 x 4; lo and
    # scale 2 x 8 x 4; selection 2 x 3; outputs 2 x 5 x 8
    assert w["bytes"] == 5 * 12 + 8 + 12 + 64 + 64 + 6 + 80
    assert w["ops"] == 2 * 16 * (5 + 3)          # pairs: 2+3, then 3
    f = yardstick.ivf_scan_work(q, valid, part_ids, 5, "cosine", None)
    # no selection: all 3 partitions, 6 rows, every query every row
    assert f["bytes"] == 6 * 32 + 12 + 12 + 64 + 2 * 5 * 12
    assert f["ops"] == 2 * 8 * 2 * 6
    peaks = yardstick.peaks_for("NVIDIA H100 80GB HBM3")
    assert yardstick.bound_seconds(w, peaks) == pytest.approx(
        w["bytes"] / 3.35e12)
    assert yardstick.peaks_for("some other card") is None


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_reduction():
    ev = [
        _ev("user_annotation", devtrace.WINDOW, 0, 100),
        _ev("user_annotation", "outer", 10, 60),
        _ev("user_annotation", "perfbench.kernel:k", 20, 10),
        _ev("user_annotation", "perfbench.kernel:k", 50, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 52, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 65, 1, correlation=3),
        _ev("kernel", "void (anonymous namespace)::scan<1>(int)", 30, 5,
            tid=7, correlation=1),
        _ev("kernel", "void (anonymous namespace)::scan<1>(int)", 55, 8,
            tid=7, correlation=2),
        _ev("kernel", "other(int)", 70, 10, tid=7, correlation=3),
    ]
    t = devtrace.DeviceTrace(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(23e-6)
    assert t.idle_share == pytest.approx(77.0)
    assert t.range_device_s("perfbench.kernel:k") == pytest.approx(
        [5e-6, 8e-6])
    assert t.device_ops()[0][0] == "scan"
    gaps = dict(t.idle_gaps())
    # idle 0-30, 35-55, 63-70, 80-100; innermost ranges: outer 10-20,
    # 30-50, 60-70; the kernel range 20-30, 50-60
    assert gaps["host.other"] == pytest.approx((10 + 20) * 1e-6)
    assert gaps["outer"] == pytest.approx((10 + 15 + 7) * 1e-6)
    assert gaps["perfbench.kernel:k"] == pytest.approx((10 + 5) * 1e-6)


def test_range_with_no_tied_launch_reads_nothing():
    """A range whose device operations carry no launch correlation on the
    range's thread is not timed: the roofline reader then leaves its
    metric out."""
    ev = [
        _ev("user_annotation", devtrace.WINDOW, 0, 100),
        _ev("user_annotation", "perfbench.kernel:k", 20, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 22, 1, tid=2, correlation=1),
        _ev("kernel", "scan(int)", 30, 5, tid=7, correlation=1),
        _ev("kernel", "other(int)", 40, 5, tid=7),
    ]
    t = devtrace.DeviceTrace(ev)
    assert t.range_device_s("perfbench.kernel:k") is None
    assert t.range_device_s("perfbench.kernel:absent") is None
    assert t.busy_s == pytest.approx(10e-6)
