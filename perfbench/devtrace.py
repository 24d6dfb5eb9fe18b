"""The device profiler's window and its reduction: busy and idle time, the
device operations that took most time, the idle gaps by what the host was
doing, and the device time of a wrapper's launches.

While the profiler runs, the benchmark opens a named range (a
torch.profiler.record_function) around calls into each layer of the
program, by replacing the module or class attribute for the time of the
window; `HOST_RANGES` lists them and a missing one is skipped. A per-layer
metric reader may ask for a range of its own around a kernel wrapper
(`WRAP`), whose arguments are kept for its work count.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "perfbench.window"
CLIENT = "perfbench.client"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# calls into each layer of the program, as "module:qualname"
HOST_RANGES = (
    "repro_torch.storage.engine:MicroNN.query",
    "repro_torch.storage.engine:MicroNN._resolve_spec",
    "repro_torch.core.executor:run",
    "repro_torch.core.executor:execute_plan",
    "repro_torch.core.executor:_probe_union",
    "repro_torch.core.executor:_rerank_float32",
    "repro_torch.core.executor:_merge_epilogue",
    "repro_torch.core.executor:_delta_candidates_from",
    "repro_torch.kernels.ops:sq_scan_topk",
    "repro_torch.kernels.ops:scan_topk_mqo",
    "repro_torch.core.query:ResultSet.to_numpy",
)


def _resolve(target: str):
    """'module:Class.attr' -> (owner object, attribute name, value), or
    None when the program has no such attribute."""
    mod_name, _, qual = target.partition(":")
    try:
        owner = importlib.import_module(mod_name)
    except ImportError:
        return None
    parts = qual.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p, None)
        if owner is None:
            return None
    fn = owner.__dict__.get(parts[-1]) if isinstance(owner, type) \
        else getattr(owner, parts[-1], None)
    if fn is None or not callable(fn):
        return None
    return owner, parts[-1], fn


def label_of(target: str) -> str:
    mod_name, _, qual = target.partition(":")
    return f"{mod_name}.{qual}"


class Ranges:
    """Named ranges around program calls for the time of a `with` block;
    `kept[label]` holds each call's (args, kwargs) where asked."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object]] = []
        self.kept: Dict[str, List[Tuple[tuple, dict]]] = {}
        self.originals: Dict[str, Callable] = {}

    def add(self, target: str, label: Optional[str] = None,
            keep_args: bool = False) -> bool:
        from torch.profiler import record_function
        found = _resolve(target)
        if found is None:
            return False
        owner, name, fn = found
        label = label or label_of(target)
        kept = self.kept.setdefault(label, []) if keep_args else None
        self.originals[label] = fn

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with record_function(label):
                out = fn(*args, **kwargs)
            if kept is not None:
                kept.append((args, kwargs))
            return out

        setattr(owner, name, wrapper)
        self._undo.append((owner, name, fn))
        return True

    def remove(self) -> None:
        while self._undo:
            owner, name, fn = self._undo.pop()
            setattr(owner, name, fn)


@contextlib.contextmanager
def profiled(path: str, cuda: bool):
    """Run the block under torch.profiler inside the WINDOW range; the
    reduced trace is set on the yielded holder's `trace` afterwards."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    holder = _Holder()
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        with record_function(WINDOW):
            yield holder
            if cuda:
                import torch
                torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    holder.trace = DeviceTrace(events)


class _Holder:
    trace: Optional["DeviceTrace"] = None


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template and call arguments."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name or "unnamed"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """One profiled window's chrome trace, reduced (times in seconds)."""

    def __init__(self, events: List[Dict]):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise ValueError("the trace holds no benchmark window")
        w = win[0]
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.tid = w.get("tid")
        self.window_s = (self.w1 - self.w0) * 1e-6
        dev = []
        for e in events:
            if e.get("cat") in _DEVICE_CATS and "dur" in e:
                a = max(float(e["ts"]), self.w0)
                b = min(float(e["ts"]) + float(e["dur"]), self.w1)
                if b > a:
                    dev.append((a, b, e))
        self._dev = dev
        self.busy = _union([(a, b) for a, b, _ in dev])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        self._ranges = [e for e in events
                        if e.get("cat") == "user_annotation"
                        and e.get("tid") == self.tid
                        and e.get("name") != WINDOW]
        self._launch = {}
        for e in events:
            if e.get("cat") in _LAUNCH_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    self._launch[c] = (e.get("tid"), float(e["ts"]))

    @property
    def idle_share(self) -> float:
        """Percent of the window with no kernel or copy on the device."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for a, b, e in self._dev:
            k = short_name(e.get("name", ""))
            tot[k] = tot.get(k, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                ][:n]

    def _host_segments(self) -> List[Tuple[float, float, str]]:
        """The innermost benchmark range at each instant of the window."""
        evs = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in self._ranges),
                     key=lambda x: (x[0], -x[1]))
        segs: List[Tuple[float, float, str]] = []
        stack: List[Tuple[float, float, str]] = []
        t = self.w0

        def emit(upto):
            nonlocal t
            if upto > t:
                segs.append((t, upto, stack[-1][2] if stack else "host.other"))
                t = upto

        for a, b, name in evs:
            while stack and stack[-1][1] <= a:
                emit(stack[-1][1])
                stack.pop()
            emit(a)
            stack.append((a, b, name))
        while stack:
            emit(stack[-1][1])
            stack.pop()
        emit(self.w1)
        return segs

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Device idle time of the window by the innermost host range open
        at the time (seconds summed per range)."""
        gaps, t = [], self.w0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            gaps.append((t, self.w1))
        segs = self._host_segments()
        starts = [s[0] for s in segs]
        tot: Dict[str, float] = {}
        for a, b in gaps:
            i = max(0, bisect.bisect_right(starts, a) - 1)
            while i < len(segs) and segs[i][0] < b:
                s0, s1, name = segs[i]
                ov = min(b, s1) - max(a, s0)
                if ov > 0:
                    tot[name] = tot.get(name, 0.0) + ov * 1e-6
                i += 1
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                ][:n]

    def range_device_s(self, label: str) -> Optional[List[float]]:
        """Device seconds of the operations launched inside each occurrence
        of the range `label`, in order, tied to it by their launches'
        correlation ids; None where no operation is tied to it."""
        occ = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in self._ranges if e["name"] == label)
        if not occ:
            return None
        starts = [o[0] for o in occ]
        out = [0.0] * len(occ)
        tied = False
        for a, b, e in self._dev:
            c = (e.get("args") or {}).get("correlation")
            launch = self._launch.get(c)
            if launch is None or launch[0] != self.tid:
                continue
            i = bisect.bisect_right(starts, launch[1]) - 1
            if i >= 0 and launch[1] <= occ[i][1]:
                out[i] += (b - a) * 1e-6
                tied = True
        return out if tied else None
