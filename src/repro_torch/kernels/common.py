"""Argument plumbing shared by the kernel wrappers: device and dtype checks,
raw pointers for the C entry points, and the scan grid plan."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

THREADS = 256          # threads per block of ivf_scan.cu
MAX_TILE = 1024        # candidate rows sorted per merge step
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may opt into


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


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def scan_plan(n_q: int, n: int, p_max: int, k_out: int, d: int,
              device: torch.device) -> Tuple[int, int, int]:
    """(n_chunks, chunk, tile) for a scan of n probe positions: enough
    (query, chunk) blocks to fill the card about eight deep, and a
    candidate tile of the next power of two above p_max (capped). Raises
    when the shared memory the launch needs exceeds what a block gets."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_chunks = min(n, max(1, -(-(sms * 8) // n_q)))
    chunk = -(-n // n_chunks)
    n_chunks = -(-n // chunk)
    tile = 32
    while tile < min(p_max, MAX_TILE):
        tile *= 2
    # pass 1: two k_out key buffers + the tile + the query (<= 10 d + 32
    # bytes for the int8 fold); pass 2: three k_out key buffers
    smem = max((2 * k_out + tile) * 8 + 12 * d + 64, 3 * k_out * 8)
    if smem > SMEM_LIMIT:
        raise ValueError(f"k_out={k_out} needs {smem} bytes of shared "
                         f"memory, above the {SMEM_LIMIT}-byte limit")
    if n_q > 65535:
        raise ValueError("a scan takes at most 65535 queries per call")
    if n * p_max >= 2 ** 31:
        raise ValueError("probe list too long: n * p_max must stay below "
                         "2^31 positions")
    return n_chunks, chunk, tile


def sq_scan_plan(n_q: int, n: int, device: torch.device) -> int:
    """n_chunks for sq_scan.cu: each query's selected pairs are shared out
    over n_chunks blocks, about as many (query, chunk) blocks as the card
    holds at once (two 256-thread blocks per SM at pass 1's ~120
    registers): more chunks only lengthen pass 2's serial merge of each
    query's lists. The shared memory a k_out needs is checked by the
    launch itself (sq_scan.cu), which reports an oversize request as its
    error."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_chunks = max(1, min(n, (2 * sms) // n_q))
    if n_q > 65535:
        raise ValueError("a scan takes at most 65535 queries per call")
    return n_chunks
