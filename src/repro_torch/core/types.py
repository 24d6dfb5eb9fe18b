"""Core datatypes for the MicroNN index (PyTorch port of repro.core.types).

The device-resident index is a dataclass of fixed-shape tensors in the
partition-major padded layout:

    vectors [k, p_max, d]   -- partition-major, padded to p_max per partition
    ids     [k, p_max]      -- asset ids, -1 marks padding / tombstones
    valid   [k, p_max]      -- live-row mask (False = padding or deleted)
    counts  [k]             -- live rows per partition

The delta-store (paper §3.6: "a reserved partition identifier") is carried
as a separate fixed-capacity block scanned by every query. All tensors of
one index live on one device (the engine's: "cuda" unless the caller asks
for "cpu"). `PagedIndex` is the disk-resident mode's view: metadata on the
device, the scan tier paged through a frame pool.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

# Distances are "smaller is better" throughout. L2 uses squared distance;
# ip/cosine negate the dot product. Cosine vectors are L2-normalised at
# ingest so cosine == ip on the stored data.

# Sentinel id for padding / tombstoned rows.
INVALID_ID = -1
# Score assigned to masked rows so they never enter a top-k.
MASKED_SCORE = float(torch.finfo(torch.float32).max)


@dataclasses.dataclass
class IVFConfig:
    """Index construction / search configuration (paper §3.1, §3.3)."""

    dim: int = 128
    metric: str = "l2"
    target_partition_size: int = 100  # paper default
    minibatch_size: int = 256
    kmeans_iters: int = 20
    balance_weight: float = 1.0  # lambda in NEAREST penalty
    balanced_final_assign: bool = False  # beyond-paper knob
    delta_capacity: int = 1024
    # Partition padding granularity; p_max is rounded up to a multiple of
    # this. The int8 layout keeps it too (no TPU tile bump in the port).
    pad_to: int = 8
    # Rebuild trigger: fraction growth of mean partition size (paper: 0.5).
    rebuild_growth_threshold: float = 0.5
    # Scalar-quantization tier: "none" keeps the float32-only index;
    # "int8" adds per-dimension SQ codes scanned by kernels/sq_scan.py
    # with a float32 rerank over k' = rerank_factor * k candidates.
    quantize: str = "none"  # "none" | "int8"
    rerank_factor: int = 4
    seed: int = 0


@dataclasses.dataclass
class DeltaStore:
    """Fixed-capacity staging area for streaming inserts (paper §3.6)."""

    vectors: torch.Tensor  # [cap, d] f32
    ids: torch.Tensor      # [cap] int32, INVALID_ID where empty
    attrs: torch.Tensor    # [cap, n_attr] f32
    valid: torch.Tensor    # [cap] bool
    count: int             # write cursor (host int: no device sync to read)
    # int8 SQ codes mirroring `vectors`, present iff the owning index is
    # quantized (encoded at insert, moved verbatim by flush_delta).
    codes: Optional[torch.Tensor] = None  # [cap, d] int8

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @staticmethod
    def empty(cap: int, dim: int, n_attr: int, quantized: bool = False,
              device=None) -> "DeltaStore":
        device = resolve_device(device)
        return DeltaStore(
            vectors=torch.zeros((cap, dim), dtype=torch.float32,
                                device=device),
            ids=torch.full((cap,), INVALID_ID, dtype=torch.int32,
                           device=device),
            attrs=torch.zeros((cap, n_attr), dtype=torch.float32,
                              device=device),
            valid=torch.zeros((cap,), dtype=torch.bool, device=device),
            count=0,
            codes=torch.zeros((cap, dim), dtype=torch.int8, device=device)
            if quantized else None,
        )


@dataclasses.dataclass
class QuantStats:
    """Per-dimension affine int8 quantizer parameters."""

    lo: torch.Tensor      # [d] f32 -- per-dimension minimum
    scale: torch.Tensor   # [d] f32 -- (hi - lo) / LEVELS, floored

    @property
    def dim(self) -> int:
        return self.lo.shape[0]


@dataclasses.dataclass
class IVFIndex:
    """Device-resident IVF index state (paper Fig. 2 schema, tensorised)."""

    centroids: torch.Tensor   # [k, d] f32
    csizes: torch.Tensor      # [k] f32 -- kmeans running counts
    vectors: torch.Tensor     # [k, p_max, d] f32
    ids: torch.Tensor         # [k, p_max] int32
    attrs: torch.Tensor       # [k, p_max, n_attr] f32
    valid: torch.Tensor       # [k, p_max] bool
    counts: torch.Tensor      # [k] int32 live rows per partition
    delta: DeltaStore
    # Mean partition size at last (re)build (the rebuild monitor's baseline).
    base_mean_size: float
    # Scalar-quantization tier (config.quantize == "int8"); None otherwise.
    codes: Optional[torch.Tensor] = None    # [k, p_max, d] int8
    qstats: Optional[QuantStats] = None
    # ||decode(codes)||^2 per row, recomputed whenever codes change (the l2
    # epilogue constant of the int8-domain scan).
    code_norms: Optional[torch.Tensor] = None  # [k, p_max] f32
    # Per-partition cumulative centroid drift (the maintenance signal).
    drift: Optional[torch.Tensor] = None    # [k] f32
    config: IVFConfig = dataclasses.field(default_factory=IVFConfig)

    @property
    def k(self) -> int:
        return self.centroids.shape[0]

    @property
    def p_max(self) -> int:
        return self.vectors.shape[1]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def n_attr(self) -> int:
        return self.attrs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def quantized(self) -> bool:
        return self.codes is not None

    def num_live(self) -> int:
        return int(self.counts.sum()) + int(self.delta.valid.sum())


@dataclasses.dataclass
class PagedIndex:
    """Memory-budgeted paged view of the index (the paper's disk-resident
    mode): only metadata is resident -- centroids, csizes, live counts, the
    delta store and the quantizer stats. The scan tier (int8 codes when
    quantized, float32 vectors otherwise) stays in SQLite and is faulted
    on demand into a storage/pager.PartitionCache frame pool;
    core/executor.paged_search drives fault -> frame scan -> disk rerank.
    Host-driven, not a tensor container: `counts` is a host array, and the
    cache is a stateful host object."""

    centroids: torch.Tensor    # [k, d] f32 (device)
    csizes: torch.Tensor       # [k] f32 (device)
    counts: np.ndarray         # [k] int64 host array -- live rows/partition
    delta: DeltaStore          # resident staging area (small, fixed cap)
    cache: object              # storage.pager.PartitionCache
    base_mean_size: float
    qstats: Optional[QuantStats] = None
    # per-partition drift (host array, the same signal as IVFIndex.drift)
    drift: Optional[np.ndarray] = None
    config: IVFConfig = dataclasses.field(default_factory=IVFConfig)

    @property
    def k(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def p_max(self) -> int:
        return self.cache.p_max

    @property
    def n_attr(self) -> int:
        return self.delta.attrs.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def quantized(self) -> bool:
        return self.qstats is not None and self.cache.payload == "int8"

    def num_live(self) -> int:
        return int(self.counts.sum()) + int(self.delta.valid.sum())


@dataclasses.dataclass
class SearchResult:
    """Top-k result batch. ids are INVALID_ID where fewer than k matches."""

    ids: torch.Tensor      # [Q, K] int32
    scores: torch.Tensor   # [Q, K] f32 (smaller is better)


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IEEE float32 matrix product. TF32 is switched off explicitly before
    every float32 product on the query and build path: TF32 keeps ~10
    mantissa bits, enough to reorder near-tied centroids and candidates
    against the float32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed pairwise order, with elementwise
    adds only (zero-padded to a power of two; adding 0.0 is exact). A
    library reduction picks its order by the tensor's shape, so a row's sum
    could change with the batch it rides in; this one gives a row the same
    bits in any batch, on either device (coalesced == solo)."""
    d = x.shape[-1]
    width = 1 << max(0, (d - 1).bit_length())
    if width != d:
        x = torch.nn.functional.pad(x, (0, width - d))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


# rows of one block of row_matmul
ROW_BLOCK = 32


def row_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, k] @ [k, n] as products of fixed-shape blocks of ROW_BLOCK rows
    of `a` (the last block zero-padded): every block has one shape, so the
    library runs one kernel whatever M is, and a row's products have the
    same bits in any batch."""
    m = a.shape[0]
    pad = -m % ROW_BLOCK
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    out = torch.cat([f32_matmul(a[s:s + ROW_BLOCK], b)
                     for s in range(0, m + pad, ROW_BLOCK)])
    return out[:m]


def normalize_if_cosine(x: torch.Tensor, metric: str) -> torch.Tensor:
    """L2-normalise rows for the cosine metric (the norm by pairwise_sum,
    so a row's bits do not depend on its batch)."""
    if metric == "cosine":
        n = torch.sqrt(pairwise_sum(x * x))[..., None]
        return x / torch.clamp(n, min=1e-12)
    return x


def pairwise_scores(q: torch.Tensor, v: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """[Q, d] x [N, d] -> [Q, N] scores, smaller is better.

    L2 uses the matmul expansion ||q-v||^2 = ||q||^2 + ||v||^2 - 2 q.v."""
    dots = f32_matmul(q, v.T)
    if metric in ("ip", "cosine"):
        return -dots
    q2 = torch.sum(q * q, dim=-1, keepdim=True)
    v2 = torch.sum(v * v, dim=-1)
    return q2 + v2[None, :] - 2.0 * dots


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU:
    None means "cuda", and a CUDA request without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def normalize_rows(rows: np.ndarray, metric: str) -> np.ndarray:
    """Host-side metric normalisation of durable float32 rows, the op
    recover() applies before packing the resident tier."""
    return normalize_if_cosine(
        torch.from_numpy(np.ascontiguousarray(rows, np.float32)),
        metric).numpy()


def to_device(blocks: Sequence[np.ndarray], device: torch.device
              ) -> torch.Tensor:
    """Stack host blocks into one tensor on `device`. On a CUDA device the
    stack lands in a pinned buffer and the copy is asynchronous on the
    current stream (no host sync)."""
    if device.type != "cuda":
        return torch.from_numpy(np.stack(blocks))
    first = np.asarray(blocks[0])
    buf = torch.empty((len(blocks),) + first.shape,
                      dtype=torch.from_numpy(first[:0]).dtype,
                      pin_memory=True)
    np.stack(blocks, out=buf.numpy())
    return buf.to(device, non_blocking=True)
