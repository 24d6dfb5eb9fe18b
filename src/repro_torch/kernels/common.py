"""Argument plumbing shared by the kernel wrappers: device and dtype checks,
raw pointers for the C entry points, and the scan grid plan."""
from __future__ import annotations

from typing import Optional

import torch


def require_cuda(name: str, device: torch.device, *tensors) -> None:
    """Every tensor handed to a kernel must live on the same CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {device}")
    for t in tensors:
        if t is not None and t.device != device:
            raise ValueError(f"{name}: tensor on {t.device}, expected "
                             f"{device}")


def require_shape(name: str, shape, **tensors) -> None:
    """Each given tensor (None = absent) must have exactly `shape`."""
    for arg, t in tensors.items():
        if t is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def as_dtype(t: Optional[torch.Tensor], dtype: torch.dtype
             ) -> Optional[torch.Tensor]:
    """Contiguous tensor of `dtype`; bool masks become int8 (a view)."""
    if t is None:
        return None
    if t.dtype == torch.bool and dtype == torch.int8:
        return t.contiguous().view(torch.int8)
    return t.to(dtype).contiguous()


def program_args(name: str, kp: int, p_max: int, attrs, program):
    """(attrs as contiguous float32 or None, host pointer of the packed
    program or None, n_attr) for a scan's launch. A program needs the
    attribute tensor [kp, p_max, n_attr] holding every column it reads."""
    if program is None:
        return None, None, 0
    if attrs is None or attrs.dim() != 3 or \
            tuple(attrs.shape[:2]) != (kp, p_max):
        raise ValueError(f"{name}: a predicate program needs attrs "
                         f"[{kp}, {p_max}, n_attr]")
    if program.max_col >= attrs.shape[2]:
        raise ValueError(f"{name}: the predicate reads column "
                         f"{program.max_col} of {attrs.shape[2]}")
    return (as_dtype(attrs, torch.float32), program.packed.ctypes.data,
            attrs.shape[2])


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card behind `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# Most queries one K1 / K2 launch takes: pass 1's grid is (n_chunks, n_q)
# and its y dimension stops at 65535, so the wrappers cut larger batches
# into slices of this many queries. A query's result does not depend on
# the batch it rides in, so the slices concatenate to the same bits.
MAX_QUERIES_PER_LAUNCH = 32768


def query_slices(n_q: int):
    """[(start, stop)] cutting n_q queries into launches of at most
    MAX_QUERIES_PER_LAUNCH (one slice when n_q fits)."""
    m = MAX_QUERIES_PER_LAUNCH
    return [(s, min(s + m, n_q)) for s in range(0, max(n_q, 1), m)]


def scan_plan(n_q: int, n: int, p_max: int, sms: int, group: int = 1) -> int:
    """n_chunks for both scans (ivf_scan.cu, sq_scan.cu): each query's
    selected probe positions (all n without a selection) are shared out
    over n_chunks blocks, with `group` queries per block, so that there are
    about as many blocks as `sms` SMs hold at once (two 256-thread blocks
    per SM): more chunks only lengthen pass 2's merge of each query's
    lists. The shared memory a k_out needs is checked by the launch itself,
    which reports an oversize request as its error."""
    if n_q > 65535:
        # the wrappers slice at MAX_QUERIES_PER_LAUNCH: a guard only
        raise ValueError("a scan takes at most 65535 queries per launch")
    if n * p_max >= 2 ** 31:
        raise ValueError("probe list too long: n * p_max must stay below "
                         "2^31 positions")
    blocks_per_chunk = -(-n_q // group)
    return max(1, min(n, (2 * sms) // blocks_per_chunk))
