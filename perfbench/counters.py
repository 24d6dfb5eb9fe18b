"""The program's cumulative counters and write stages as the process
registry (repro_torch.obs.metrics) holds them, read for the newest engine
instance, as buildstages.py reads the build's stages: a run is one process
with one engine, and the engine's pager, store and planner register under
its `inst` label.

- counters: `hits` / `misses{component="pager"}`, `rows_read` /
  `bytes_read{component="store"}`, `plans{component="planner",plan=...}`,
  `queries{component="engine"}` (query calls answered);
- histograms: `stage_s{component="engine",action="write",stage=...}`
  ("commit", "flush").

Each reader gives None where the program has no such series, so a program
without them yields nothing, and raises nothing.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

_KEY = re.compile(r"^([^{]+)\{(.*)\}$")
_LABEL = re.compile(r'(\w+)="([^"]*)"')


def _snapshot() -> Optional[Dict]:
    try:
        from repro_torch.obs import metrics
    except ImportError:
        return None
    return metrics.default_registry().snapshot()


def _series(snap: Dict, kind: str):
    """(name, labels, value) of every labelled series of a kind."""
    for key, v in snap[kind].items():
        m = _KEY.match(key)
        if m:
            yield m.group(1), dict(_LABEL.findall(m.group(2))), v


def _newest_engine(snap: Dict) -> Optional[str]:
    insts = [int(lab["inst"]) for name, lab, _ in _series(snap, "counters")
             if name == "queries" and lab.get("component") == "engine"
             and lab.get("inst", "").isdigit()]
    return str(max(insts)) if insts else None


def _find(kind: str, name: str, **labels) -> Optional[object]:
    snap = _snapshot()
    if snap is None:
        return None
    inst = _newest_engine(snap)
    if inst is None:
        return None
    want = dict(labels, inst=inst)
    for n, lab, v in _series(snap, kind):
        if n == name and all(lab.get(k) == w for k, w in want.items()):
            return v
    return None


def counter(name: str, **labels) -> Optional[int]:
    """The newest engine's counter `name` with these labels, or None."""
    v = _find("counters", name, **labels)
    return None if v is None else int(v)


def histogram(name: str, **labels) -> Optional[Dict]:
    """The newest engine's histogram snapshot (`count`, `sum`, ...), or
    None."""
    return _find("histograms", name, **labels)


def write_stage_ms(stage: str) -> Optional[float]:
    """Mean milliseconds of the newest engine's write stage `stage`; None
    where it recorded none."""
    h = histogram("stage_s", component="engine", action="write",
                  stage=stage)
    if h is None or not h["count"]:
        return None
    return 1e3 * float(h["sum"]) / int(h["count"])
