"""The control of the check: the plain reference put in the program's place
one precision lower (TF32 products for the configuration's float32), on
the same data and the same calls as a run of the cell, judged by the same
comparison. It has to come out not correct.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \
        --calls 6000

runs on the card at the cell's own size (no program set-up: the control
answers from the reference's TF32 top-k of every pool query) and prints
one JSON line per seed with its checks. The benchmark's own runs never run
it; test_perfbench_control.py holds it at a size a CPU test can.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch


def readings(bench, workload: str, seed: int, calls: int, device: str,
             overrides: Optional[Dict] = None) -> Dict:
    """The control's checks on `calls` calls of the cell's traffic."""
    from . import checker, datagen, harness, loadgen
    overrides = overrides or {}
    cell = bench.workload(workload)
    cfg = harness._merge(bench.config(cell["config"]),
                         {k: v for k, v in overrides.items()
                          if k in ("data", "limits")})
    mix = harness._merge(bench.traffic(cell["traffic"]), overrides.get("mix"))
    if mix.get("writes"):
        raise ValueError("the control covers mixes without writes")
    ref = bench.reference(cfg)
    ref.no_tf32()
    dev = torch.device(device)
    dspec = cfg["data"]
    data = datagen.make(dspec, seed, dev)
    traffic = loadgen.Traffic(mix, seed, int(dspec["pool"]),
                              int(dspec["rows"]))
    drawn = [traffic.next_call() for _ in range(calls)]
    ok = torch.ones(data.X.shape[0], dtype=torch.bool, device=dev)
    K = max(c.k for c in drawn)
    ids, scores = ref.control_answers(data.X, ok, data.pool, K,
                                      dspec["metric"])
    ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
    answers = [checker.Answer(qidx=c.qidx, version=0, kind=c.kind, k=c.k,
                              predicate=c.predicate,
                              ids=ids[c.qidx, :c.k],
                              scores=scores[c.qidx, :c.k])
               for c in drawn]
    table = checker.Table(data.X, data.attrs)
    verdict = checker.judge(ref, table, data.pool, answers, dspec["metric"])
    checks = verdict.checks(cfg["limits"])
    return {"workload": workload, "seed": seed, "calls": calls,
            "correct": checker.passes(checks), "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the check's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    from . import bench
    b = bench.Bench(Path(__file__).resolve().parents[1] / "BENCHMARK.json")
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(b, args.workload, int(s), args.calls, "cuda")
        r["seconds"] = time.perf_counter() - t
        r["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
