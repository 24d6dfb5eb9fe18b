"""BENCHMARK.json and the files it names, found by name.

- a cell (`workloads` entry) names its configuration and its traffic mix;
- a configuration's file is the `file` of its `configs` entry (JSON), and
  its plain reference is `references/<reference>.py` in the same folder of
  `paths` as the file;
- a traffic mix is `traffic/<name>.json` in a folder of `paths`;
- a metric, end-to-end or per-layer, is read by `metrics/<name>.py` in a
  folder of `paths`: a module with `read(run) -> float | None`, and
  optionally `WRAP` ("module:qualname" of a program function whose calls
  it needs a profiler range around) and `work(bound_args, metric)`.

A later PR adds a configuration, a mix or a metric as new files and new
entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

_SAFE = re.compile(r"[^A-Za-z0-9_]")


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import a file by path (file names may hold dots and dashes)."""
    name = f"perfbench_{prefix}_{_SAFE.sub('_', path.stem)}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    def __init__(self, path: Path):
        self.path = Path(path)
        self.root = self.path.parent
        with open(self.path) as f:
            self.data = json.load(f)
        self.dirs = [self.root / p for p in self.data["paths"]]

    def _find(self, sub: str, name: str, ext: str) -> Path:
        for d in self.dirs:
            p = d / sub / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{name}{ext} under "
                                f"{[str(d) for d in self.dirs]}")

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> Dict:
        """The configuration's file, loaded, with `_dir`: its folder."""
        for c in self.data["configs"]:
            if c["name"] == name:
                p = self.root / c["file"]
                with open(p) as f:
                    cfg = json.load(f)
                cfg["_dir"] = p.parent
                return cfg
        raise KeyError(f"no configuration {name!r} in {self.path}")

    def reference(self, cfg: Dict) -> ModuleType:
        name = cfg["reference"]
        for d in [cfg["_dir"].parent] + self.dirs:
            p = d / "references" / f"{name}.py"
            if p.is_file():
                return load_module(p, "ref")
        raise FileNotFoundError(f"no references/{name}.py")

    def traffic(self, name: str) -> Dict:
        with open(self._find("traffic", name, ".json")) as f:
            return json.load(f)

    def metrics(self, workload: str, trace: bool) -> List[Dict]:
        """The cell's metrics of the run's kind (end-to-end untraced,
        per-layer traced), each entry with `_reader`, its module."""
        kind = "per_layer" if trace else "end_to_end"
        out = []
        for m in self.data[kind]:
            cells = m.get("workloads")
            if cells is not None and workload not in cells:
                continue
            entry = dict(m)
            entry["_reader"] = load_module(
                self._find("metrics", m["name"], ".py"), "metric")
            out.append(entry)
        return out


def default_bench() -> Bench:
    return Bench(Path(__file__).resolve().parents[1] / "BENCHMARK.json")


def wraps_of(metrics: List[Dict]) -> Dict[str, str]:
    """{range label: "module:qualname"} the per-layer readers ask for."""
    out: Dict[str, str] = {}
    for m in metrics:
        target: Optional[str] = getattr(m["_reader"], "WRAP", None)
        if target:
            out[f"perfbench.kernel:{m['name']}"] = target
    return out
