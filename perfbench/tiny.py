"""A cell shrunk for the CPU tests: the same harness, reference and check at
a few thousand rows, on the plain PyTorch versions of the kernels."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

from . import bench as bench_mod
from . import harness

OVERRIDES = {
    "data": {"rows": 3000, "pool": 200, "clusters": 6},
    "limits": {"recall_at_least": 0.8},
    "mix": {"calls": [{"weight": 1, "batch": 32,
                       "spec": {"kind": "ann", "k": 10, "n_probe": 8}}],
            "warmup_calls": 2, "profile_seconds": 0.5},
}


def run(workload: str, trace: bool = False, seed: int = 2 ** 31 + 11,
        seconds: float = 1.0, workdir: Optional[Path] = None,
        bench: Optional[bench_mod.Bench] = None,
        overrides: Optional[Dict] = None) -> Dict:
    """One tiny run of the cell on the CPU (the recall limit is lowered to
    what eight probes of 30 partitions reach)."""
    return harness.run_cell(bench or bench_mod.default_bench(), workload,
                            seed=seed, seconds=seconds, trace=trace,
                            device="cpu",
                            overrides=harness._merge(OVERRIDES, overrides),
                            workdir=workdir)
