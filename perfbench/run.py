"""Run one cell of the port's benchmark once, on the card it is started on:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last `checks`: each number the check
compared beside its limit); the last lines of standard error repeat the
checks. Without a CUDA card, with fewer cards than the cell asks for, or
with JAX or the JAX package (`repro`) loaded once the run is over, it
exits with a code other than 0 and prints no result.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that must not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None):
    """The forbidden top-level names among `names` (default: the modules
    loaded now), each name's part before the first dot compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _power_limit():
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (subprocess.SubprocessError, OSError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _limit_text(c):
    return f"at most {c['at_most']!r}" if "at_most" in c \
        else f"at least {c['at_least']!r}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the script's own folder first on the path would let its files shadow
    # modules by name: import the benchmark as a package from the root
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark measures the card "
              "only", file=sys.stderr)
        return 2
    from perfbench import bench, harness
    b = bench.Bench(ROOT / "BENCHMARK.json")
    cell = b.workload(args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(b, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start=_T0)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    power = _power_limit()
    if power:
        result["device"]["power_limit"] = power
    checks = result.pop("checks")
    result["checks"] = checks
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} ({_limit_text(c)})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
