"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use with nvcc into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so

The library name carries a hash of the sources, so an edited kernel is
rebuilt and a stale one is never loaded. Outputs go to `build/kernels/`
at the repository root (listed in .gitignore). Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("ivf_scan", "sq_scan", "kmeans_assign")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the launch entry points: every pointer and the stream
# are c_void_p (a bare int would be cut to 32 bits), every size c_int.
SIGNATURES = {
    "ivf_scan": ("ivf_scan_launch",
                 [_P] * 9 + [_I] * 9 + [_P] * 8),
    "sq_scan": ("sq_scan_launch",
                [_P] * 14 + [_I] * 8 + [_P] * 7),
    "kmeans_assign": ("kmeans_assign_launch",
                      [_P] * 3 + [_I] * 5 + [_P] * 6),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel libraries loaded into this process (each at most once); a traced
# scan reports the loads it caused as its `compiled` count
_LOADS = 0
# nvcc's stderr (the -Xptxas -v register / shared-memory report) per build
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def _sources(name: str) -> List[Path]:
    """The kernel's source and every header it may include (the library
    name hashes them all)."""
    return [CSRC / f"{name}.cu", CSRC / "topk_common.cuh",
            CSRC / "pred_program.cuh"]


def lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in _sources(name):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    out = lib_path(name)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half


def build_all(names=KERNELS) -> Dict[str, float]:
    """Compile every kernel not yet built, all nvcc processes at once.
    Returns the wall seconds each build took (0.0 = already built)."""
    t0 = time.perf_counter()
    procs = {n: _start_build(n) for n in names}
    secs = {}
    for n, proc in procs.items():
        if proc is None:
            secs[n] = 0.0
            continue
        _finish_build(n, proc)
        secs[n] = time.perf_counter() - t0
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    global _LOADS
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    proc = _start_build(name)
    if proc is not None:
        _finish_build(name, proc)
    lib = ctypes.CDLL(str(lib_path(name)))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _LIBS[name] = lib
    _LOADS += 1
    return lib


def load_count() -> int:
    """Kernel libraries loaded (built if needed) in this process so far."""
    return _LOADS


def check_launch(name: str, rc: int) -> None:
    """Raise when a launch entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
