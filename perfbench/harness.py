"""One run of one cell: set-up, warm-up, the measured window, the check.

    result = harness.run_cell(bench, "sift1m-int8-resident.knn-b512",
                              seed=7, seconds=30, trace=False)

Set-up draws the configuration's data on the device from the seed, moves
it to the host (the program takes numpy rows, as an application hands
them over), ingests it into the program in upserts of `ingest_rows`, builds
the index, warms up the mix's call shapes, and draws from the seed
AHEAD_CALLS of the mix's calls (their query vectors gathered, their specs
made) and the window's writes. The window then drives `MicroNN.query`
with those calls in turn, from the first again after the last, for
`seconds` (closed loop, one caller), timing each call until its ids and
scores are in host memory; between calls it applies the writes that have
fallen due. The window thus times the program and no work of the client.
Once it has closed, the device's peak memory is read, the program's state
is freed, and every answer is judged by checker.judge against the
configuration's plain reference.

A traced run (`trace=True`) spends the first `profile_seconds` of its
window under the device profiler with untraced calls (device busy time,
kernel ranges, idle gaps), and the rest of `seconds`, once the trace is
reduced, with `query(..., trace=True)`, whose spans the per-layer readers
average per call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import itertools
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import bench as bench_mod
from . import checker, datagen, devtrace, loadgen, yardstick


# calls of the mix drawn in set-up, which the window takes in turn: enough
# distinct batches that their union is a mix's typical one, few enough that
# gathering their query vectors costs set-up a second or two (512 rows of
# 256 float32 a call: 1 GiB)
AHEAD_CALLS = 2048


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def _draw_ahead(traffic: loadgen.Traffic, pool: np.ndarray,
                spec_of: Callable, n: int) -> List[tuple]:
    """The mix's next `n` calls from the seed, in order, each as (call, its
    query vectors gathered from the pool, its spec)."""
    return [(c, pool[c.qidx], spec_of(c))
            for c in (traffic.next_call() for _ in range(n))]


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""

    workload: str
    config: Dict
    mix: Dict
    device_kind: str
    setup: Dict[str, float]
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: int = 0
    queries: int = 0
    call_ms: List[float] = dataclasses.field(default_factory=list)
    profiled_calls: int = 0          # calls made under the device profiler
    spans_s: float = 0.0             # seconds of a traced window's spans part
    spans_queries: int = 0           # query vectors answered in that part
    verdict: Optional[checker.Verdict] = None
    spans: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    trace: Optional[devtrace.DeviceTrace] = None
    kept: Dict[str, list] = dataclasses.field(default_factory=dict)
    originals: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    readers: Dict[str, object] = dataclasses.field(default_factory=dict)

    def span_mean_ms(self, name: str) -> Optional[float]:
        """Mean milliseconds of the span `name` a traced call, over the
        traced calls (None when no call recorded it)."""
        got = [s[name] for s in self.spans if name in s]
        if not got:
            return None
        return sum(got) / len(self.spans)

    def roofline(self, metric: str) -> Optional[float]:
        """Percent of the roofline bound in the device time of the calls to
        the metric reader's WRAP target in the profiled part of the window:
        the sum of each call's least time (its reader's `work`, against
        the card's published peaks) over the sum of their device time."""
        label = f"perfbench.kernel:{metric}"
        kept = self.kept.get(label)
        peaks = yardstick.peaks_for(self.device_kind)
        if not kept or self.trace is None or peaks is None:
            return None
        times = self.trace.range_device_s(label)
        if times is None or len(times) != len(kept) or sum(times) <= 0:
            return None
        sig = inspect.signature(self.originals[label])
        reader = self.readers[metric]
        bound = 0.0
        for args, kwargs in kept:
            b = sig.bind(*args, **kwargs)
            b.apply_defaults()
            bound += yardstick.bound_seconds(reader.work(b.arguments), peaks)
        return 100.0 * bound / sum(times)


def _merge(base: Dict, over: Optional[Dict]) -> Dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def _rm_db(path: Path) -> None:
    for suffix in ("", "-wal", "-shm"):
        p = Path(str(path) + suffix)
        if p.exists():
            p.unlink()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _specs(mix_classes: List[Dict]):
    """A function Call -> QuerySpec of the program."""
    from repro_torch.core.hybrid import Pred
    from repro_torch.core.query import QuerySpec

    base = {}
    for i, c in enumerate(mix_classes):
        s = c.get("spec", {})
        base[i] = QuerySpec(kind=s.get("kind", "ann"), k=int(s.get("k", 10)),
                            n_probe=int(s.get("n_probe", 8)),
                            hybrid=s.get("hybrid", "auto"))

    def spec_of(call: loadgen.Call):
        spec = base[call.cls]
        if call.predicate is not None:
            col, op, value = call.predicate
            spec = spec.where(Pred(col, op, value))
        return spec
    return spec_of


def _engine(cfg: Dict, path: Path, device: torch.device):
    from repro_torch.core.types import IVFConfig
    from repro_torch.storage.engine import MicroNN
    d = cfg["data"]
    eng_kw = dict(cfg.get("engine", {}))
    ivf_kw = eng_kw.pop("ivf", {})
    ivf = IVFConfig(dim=int(d["dim"]), metric=d["metric"], **ivf_kw)
    return MicroNN(dim=int(d["dim"]), n_attr=len(d.get("attrs", [])),
                   path=str(path), config=ivf, device=device, **eng_kw)


def run_cell(bench: bench_mod.Bench, workload: str, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None,
             overrides: Optional[Dict] = None,
             workdir: Optional[Path] = None) -> Dict:
    """One run of the cell; returns the result line's object.
    `overrides` ({"data": ..., "engine": ..., "mix": ...}) shrink a cell
    for the CPU tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    cfg = _merge(cfg, {k: v for k, v in overrides.items()
                       if k in ("data", "engine", "limits")})
    mix = _merge(bench.traffic(cell["traffic"]), overrides.get("mix"))
    ref = bench.reference(cfg)
    metrics = bench.metrics(workload, trace)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    setup: Dict[str, float] = {}

    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        from repro_torch.kernels import build
        build.build_all()
    setup["kernels_s"] = time.perf_counter() - t

    # -- data, drawn on the device, handed over as host rows ---------------
    t = time.perf_counter()
    dspec = cfg["data"]
    data = datagen.make(dspec, seed, dev)
    traffic = loadgen.Traffic(mix, seed, int(dspec["pool"]),
                              int(dspec["rows"]))
    n_w = traffic.max_written_rows(seconds)
    w_vecs, w_attrs = datagen.extra_rows(data, n_w, seed)
    X = data.X.cpu().numpy()
    A = data.attrs.cpu().numpy()
    pool = data.pool.cpu().numpy()
    W, WA = w_vecs.cpu().numpy(), w_attrs.cpu().numpy()
    del data, w_vecs, w_attrs
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    setup["data_s"] = time.perf_counter() - t

    # -- the program: ingest and build -------------------------------------
    workdir = Path(tempfile.gettempdir()) / "perfbench" if workdir is None \
        else Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    db = workdir / f"{cfg['name']}.sqlite"
    _rm_db(db)
    t = time.perf_counter()
    eng = _engine(cfg, db, dev)
    n = X.shape[0]
    step = int(cfg.get("ingest_rows", 100_000))
    ids = np.arange(n, dtype=np.int64)
    for s in range(0, n, step):
        eng.upsert(ids[s:s + step], X[s:s + step], A[s:s + step])
    setup["ingest_s"] = time.perf_counter() - t
    t = time.perf_counter()
    eng.build()
    _sync(dev)
    setup["build_s"] = time.perf_counter() - t

    # -- warm-up: the mix's own call shapes ----------------------------------
    spec_of = _specs(traffic.classes)
    t = time.perf_counter()
    warm = traffic.warmup_calls()
    for call in warm:
        eng.query(pool[call.qidx], spec_of(call)).to_numpy()
    if trace:
        for call in warm[:2]:
            eng.query(pool[call.qidx], spec_of(call), trace=True).to_numpy()
        prof_path = str(workdir / f"{cfg['name']}.trace.json")
        with devtrace.profiled(prof_path, cuda):
            for call in warm[:2]:
                eng.query(pool[call.qidx], spec_of(call)).to_numpy()
    _sync(dev)
    setup["warmup_s"] = time.perf_counter() - t

    # -- the window's calls and writes, drawn before it opens ----------------
    t = time.perf_counter()
    calls = itertools.cycle(_draw_ahead(traffic, pool, spec_of, AHEAD_CALLS))
    writes = traffic.writes_until(float(seconds))
    setup["draw_s"] = time.perf_counter() - t
    gc.collect()
    run = Run(workload=workload, config=cfg, mix=mix, setup=setup,
              device_kind=torch.cuda.get_device_name(dev) if cuda else "cpu")
    run.setup_s = time.perf_counter() - t_start
    log("setup " + " ".join(f"{k}={v:.3f}" for k, v in setup.items())
        + f" setup_s={run.setup_s:.3f}")

    # -- the window ----------------------------------------------------------
    answers: List[checker.Answer] = []
    state = {"version": 0, "failed": 0, "next_write": 0, "writes": []}

    def apply_writes(now_s: float):
        i = state["next_write"]
        while i < len(writes) and now_s >= writes[i].due_s:
            w = writes[i]
            with eng.session() as s:
                if len(w.upsert_ids):
                    s.upsert(w.upsert_ids, W[w.upsert_rows],
                             WA[w.upsert_rows])
                if len(w.delete_ids):
                    s.delete(w.delete_ids)
            state["writes"].append(w)
            state["version"] = w.version
            i += 1
        state["next_write"] = i

    def drive(t0: float, until: float, traced: bool, client_range):
        while True:
            now = time.perf_counter()
            if now >= until:
                return
            with client_range():
                apply_writes(now - t0)
                call, q, spec = next(calls)
            c0 = time.perf_counter()
            try:
                rs = eng.query(q, spec, trace=traced)
                got_ids, got_s = rs.to_numpy()
            except Exception:
                state["failed"] += 1
                if state["failed"] == 1:
                    log("a call failed:\n" + traceback.format_exc())
                continue
            run.call_ms.append((time.perf_counter() - c0) * 1e3)
            run.queries += len(call.qidx)
            answers.append(checker.Answer(
                qidx=call.qidx, version=state["version"], kind=call.kind,
                k=call.k, predicate=call.predicate, ids=got_ids,
                scores=got_s))
            if traced and rs.trace is not None:
                run.spans.append({k: s.dur_ms
                                  for k, s in rs.trace.spans.items()})

    w0 = time.perf_counter()
    end = w0 + float(seconds)
    if trace:
        from torch.profiler import record_function
        ranges = devtrace.Ranges()
        for target in devtrace.HOST_RANGES:
            ranges.add(target)
        for label, target in bench_mod.wraps_of(metrics).items():
            ranges.add(target, label=label, keep_args=True)
        prof_end = w0 + min(float(mix.get("profile_seconds", 2.0)),
                            float(seconds) / 2)
        try:
            with devtrace.profiled(prof_path, cuda) as holder:
                drive(w0, prof_end, False,
                      lambda: record_function(devtrace.CLIENT))
        finally:
            ranges.remove()
        run.trace = holder.trace
        run.kept, run.originals = ranges.kept, ranges.originals
        run.profiled_calls = len(run.call_ms)
        # the spans' part keeps its own length after the trace's reduction,
        # and the write schedule's clock stops while the trace is reduced
        resume = time.perf_counter()
        before = run.queries
        drive(resume - (prof_end - w0), resume + (end - prof_end), True,
              contextlib.nullcontext)
        run.spans_s = time.perf_counter() - resume
        run.spans_queries = run.queries - before
    else:
        drive(w0, end, False, contextlib.nullcontext)
    run.window_s = time.perf_counter() - w0
    run.calls = len(run.call_ms) + state["failed"]
    log(f"window calls={run.calls} failed={state['failed']} "
        f"queries={run.queries} seconds={run.window_s:.3f}")

    # -- read-back of acknowledged writes ------------------------------------
    readback: List[checker.Answer] = []
    if state["writes"]:
        from repro_torch.core.query import QuerySpec
        # id written in the window -> the table row holding it, or -1 - that
        # row once deleted (the read-back queries both)
        row_of = {}
        for w in state["writes"]:
            for i, r in zip(w.upsert_ids, w.upsert_rows):
                row_of[int(i)] = n + int(r)
            for i in w.delete_ids:
                row_of[int(i)] = -1 - row_of.get(int(i), int(i))
        # every written row still live, and the last row of every deleted
        # id: an exact query of its own vector finds it, or not the id
        rows = np.asarray(sorted({r if r >= 0 else -1 - r
                                  for r in row_of.values()}), np.int64)
        for a in range(0, len(rows), 256):
            r = rows[a:a + 256]
            vecs = np.where((r < n)[:, None], X[np.minimum(r, n - 1)],
                            W[np.maximum(r - n, 0)])
            qi = r + pool.shape[0]
            got_ids, got_s = eng.query(vecs, QuerySpec(kind="exact", k=1)
                                       ).to_numpy()
            readback.append(checker.Answer(
                qidx=qi, version=state["version"], kind="exact", k=1,
                predicate=None, ids=got_ids, scores=got_s))

    # -- after the window: peak, free the program, judge ---------------------
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    eng.close()
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    _rm_db(db)
    t = time.perf_counter()
    ref.no_tf32()      # after the program: its settings are its own
    table = checker.Table(
        torch.from_numpy(X).to(dev), torch.from_numpy(A).to(dev),
        torch.from_numpy(W).to(dev), torch.from_numpy(WA).to(dev),
        state["writes"])
    pool_d = torch.from_numpy(pool).to(dev)
    metric = dspec["metric"]
    run.verdict = checker.judge(ref, table, pool_d, answers, metric,
                                failed_calls=state["failed"])
    if readback:
        # judged apart, so that recall stays the window's own
        rb = checker.judge(ref, table, pool_d, readback, metric)
        run.verdict.bad_answers += rb.bad_answers
        run.verdict.exact_misses += rb.exact_misses
        run.verdict.score_gap = max(run.verdict.score_gap, rb.score_gap)
    _sync(dev)
    log(f"check_s={time.perf_counter() - t:.3f} answers="
        f"{run.verdict.answers} readback={sum(len(a.qidx) for a in readback)}")

    # -- the result line -----------------------------------------------------
    checks = run.verdict.checks(cfg["limits"])
    values = {}
    run.readers = {m["name"]: m["_reader"] for m in metrics}
    for m in metrics:
        v = m["_reader"].read(run)
        if v is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # the run drives one card
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": run.device_kind, "count": 1 if cuda else 0,
                   "memory_peak_bytes": peak}
    out = {"correct": checker.passes(checks), "attempted": run.calls,
           "failed": state["failed"], "metrics": values,
           "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(10),
                            "idle_gaps": run.trace.idle_gaps(10)}
    out["checks"] = checks
    return out
