"""The build's stages as the program records them: seconds of each stage of
MicroNN.build() in the process registry's `stage_s{action="build",
stage=...}` histograms (repro_torch.obs.metrics), read for the newest engine
instance (a run is one process with one engine, built once)."""
from __future__ import annotations

import re
from typing import Dict, Optional

_LABEL = re.compile(r'(\w+)="([^"]*)"')


def stage_seconds() -> Dict[str, float]:
    """{stage: seconds} of the newest engine's builds; empty where the
    program records no build stages."""
    try:
        from repro_torch.obs import metrics
    except ImportError:
        return {}
    newest, out = -1, {}
    for key, h in metrics.default_registry().snapshot()["histograms"].items():
        if not key.startswith("stage_s{"):
            continue
        labels = dict(_LABEL.findall(key))
        inst = labels.get("inst", "")
        if labels.get("action") != "build" or not inst.isdigit():
            continue
        if int(inst) > newest:
            newest, out = int(inst), {}
        if int(inst) == newest:
            out[labels.get("stage", "")] = float(h["sum"])
    return out


def sum_of(*stages: str) -> Optional[float]:
    """The seconds of those of `stages` the build recorded, summed; None
    where it recorded none of them."""
    got = stage_seconds()
    found = [got[s] for s in stages if s in got]
    return sum(found) if found else None
