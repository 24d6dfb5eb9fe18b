// Block-level top-k building blocks shared by ivf_scan.cu and sq_scan.cu.
//
// A candidate is one 64-bit key: the score mapped to an order-preserving
// uint32 in the high half, its position in the flattened probe list
// (probe position * p_max + slot) in the low half. Keys are distinct (each
// position appears once per query), so "ascending key" is exactly the
// order jax.lax.top_k gives over the flattened [n * p_max] score list:
// ascending score, ties by position. Masked rows never become keys; the
// final pass fills the tail with (MASKED, -1) directly.
//
// Both scans run the same three steps: scan_pair_list compacts each
// query's selection row into its selected probe positions; pass 1 (per
// scan) filters keys against the running k-th, collects survivors in a
// shared candidate buffer and folds it into a running top-k with
// flush_candidates; topk_merge_pass2 merges each query's per-chunk lists.
#pragma once

#include <cstdint>
#include <cfloat>
#include <cuda_runtime.h>

#define EMPTY_KEY 0xffffffffffffffffull
#define MASKED_SCORE FLT_MAX

constexpr int THREADS = 256;            // threads of every scan block
constexpr int NWARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t f2ord(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float ord2f(uint32_t o) {
  uint32_t u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ uint64_t make_key(float s, uint32_t pos) {
  return ((uint64_t)f2ord(s) << 32) | (uint64_t)pos;
}

// Number of entries of the sorted a[0..n) strictly below key.
__device__ __forceinline__ int lower_bound_u64(const uint64_t* a, int n,
                                               uint64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// In-place ascending bitonic sort of a[0..n), n a power of two.
__device__ void block_bitonic_sort(uint64_t* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        int j = i + stride;
        bool up = (i & size) == 0;
        uint64_t x = a[i], y = a[j];
        if ((x > y) == up) { a[i] = y; a[j] = x; }
      }
    }
  }
  __syncthreads();
}

// Merge the sorted run[0..r) and the sorted cand[0..m) (distinct keys) into
// out[0..min(K, r+m)) by rank: each element's output slot is its own index
// plus the number of smaller keys in the other list. Returns the new length.
__device__ int block_merge(const uint64_t* run, int r, const uint64_t* cand,
                           int m, uint64_t* out, int K) {
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    int rank = i + lower_bound_u64(cand, m, run[i]);
    if (rank < K) out[rank] = run[i];
  }
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    int rank = j + lower_bound_u64(run, r, cand[j]);
    if (rank < K) out[rank] = cand[j];
  }
  __syncthreads();
  return min(K, r + m);
}

// Ascending sort of the first m (<= 32) keys of a[] in one warp's
// registers (bitonic over shuffles); entries [m, 32) are not written.
__device__ __forceinline__ void warp_sort32(uint64_t* a, int m) {
  const int lane = threadIdx.x & 31;
  uint64_t key = lane < m ? a[lane] : EMPTY_KEY;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint64_t other = __shfl_xor_sync(FULL, key, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      key = keep_min ? (other < key ? other : key)
                     : (other > key ? other : key);
    }
  }
  if (lane < m) a[lane] = key;
}

// Sort cand[0..m) at the next power of two of m (in one warp's registers
// for 32 or fewer) and merge it into the running list run[0..r) (into tmp,
// then swapped). Every thread of a THREADS-thread block calls it; returns
// the new length.
__device__ int flush_candidates(uint64_t*& run, uint64_t*& tmp, int r,
                                uint64_t* cand, int m, int k_out) {
  if (m <= 32) {
    if (threadIdx.x < 32) warp_sort32(cand, m);
    __syncthreads();
  } else {
    int p = 64;
    while (p < m) p <<= 1;
    for (int t = m + threadIdx.x; t < p; t += THREADS) cand[t] = EMPTY_KEY;
    block_bitonic_sort(cand, p);    // syncs before and after
  }
  r = block_merge(run, r, cand, m, tmp, k_out);   // syncs after
  uint64_t* sw = run; run = tmp; tmp = sw;
  return r;
}

// Each query's selected probe positions, in increasing order: pairs
// [n_q, n] (first pair_cnt[q] entries valid). One THREADS-thread block per
// query; the threads take 4 positions each per 1,024-position tile, and a
// block scan orders their writes.
__global__ void __launch_bounds__(THREADS)
scan_pair_list(const int8_t* __restrict__ qsel, int n,
               int32_t* __restrict__ pairs, int32_t* __restrict__ pair_cnt) {
  __shared__ int wsum[NWARPS];
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int8_t* row = qsel + (size_t)q * n;
  int32_t* out = pairs + (size_t)q * n;
  int base = 0;
  for (int t0 = 0; t0 < n; t0 += 4 * THREADS) {
    const int e0 = t0 + 4 * threadIdx.x;
    bool f[4];
    int c = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[b] = (e0 + b < n) && row[e0 + b] != 0;
      c += f[b];
    }
    int x = c;   // inclusive warp scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) wsum[w] = x;
    __syncthreads();
    int before = 0, tot = 0;
#pragma unroll
    for (int i = 0; i < NWARPS; ++i) {
      before += (i < w) ? wsum[i] : 0;
      tot += wsum[i];
    }
    int pos = base + before + x - c;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (f[b]) out[pos++] = e0 + b;
    base += tot;
    __syncthreads();   // wsum is rewritten by the next tile
  }
  if (threadIdx.x == 0) pair_cnt[q] = base;
}

// Pass 2 of both scans: one block per query merges the query's per-chunk
// partial lists (each sorted, part_cnt entries) into its top-k_out, maps
// positions to ids and fills the exhausted tail with (MASKED, -1).
// `limits` [n_q] may be null; else a key above limits[q] cannot be among
// the query's top-k_out (pass 1 published it: some chunk holds k_out keys
// at or below it), so each list is first cut to its keys at or below it,
// all lists at once, and the serial merge visits only lists that keep any
// (at an exact scan's hundreds of chunks, most keep none).
// `ids` [kp, p_max] may be null: then the flat row id p * p_max + slot is
// emitted (the int8 candidate stage feeds those rows to the f32 rerank).
__global__ void topk_merge_pass2(const uint64_t* __restrict__ part_keys,
                                 const int32_t* __restrict__ part_cnt,
                                 int n_chunks, int k_out,
                                 const unsigned long long* __restrict__ limits,
                                 const int32_t* __restrict__ ids,
                                 const int32_t* __restrict__ part_ids,
                                 int p_max, float* __restrict__ out_s,
                                 int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) uint64_t smem2[];
  uint64_t* run = smem2;
  uint64_t* tmp = run + k_out;
  uint64_t* cand = tmp + k_out;
  int* mc = reinterpret_cast<int*>(cand + k_out);   // [n_chunks]
  int* nz = mc + n_chunks;          // the chunks whose lists keep keys
  __shared__ int n_nz;
  const int q = blockIdx.x;
  const uint64_t limit = limits ? (uint64_t)limits[q] : EMPTY_KEY;
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    const size_t base = ((size_t)q * n_chunks + c) * (size_t)k_out;
    int m = part_cnt[(size_t)q * n_chunks + c];
    if (limit != EMPTY_KEY)
      m = lower_bound_u64(part_keys + base, m, limit + 1);
    mc[c] = m;
  }
  __syncthreads();
  if (threadIdx.x < 32) {           // one warp lists them, in order
    const int lane = threadIdx.x;
    int at = 0;
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      const bool some = c0 + lane < n_chunks && mc[c0 + lane] > 0;
      const unsigned b = __ballot_sync(FULL, some);
      if (some) nz[at + __popc(b & ((1u << lane) - 1u))] = c0 + lane;
      at += __popc(b);
    }
    if (lane == 0) n_nz = at;
  }
  int r = 0;
  for (int i = 0;; ++i) {
    __syncthreads();                  // nz is written; cand is free
    if (i >= n_nz) break;
    const int c = nz[i];
    int m = mc[c];
    const size_t base = ((size_t)q * n_chunks + c) * (size_t)k_out;
    for (int t = threadIdx.x; t < m; t += blockDim.x)
      cand[t] = part_keys[base + t];
    __syncthreads();
    if (r == k_out) {  // only entries below the current k-th can enter
      m = lower_bound_u64(cand, m, run[k_out - 1]);
      if (m == 0) continue;
    }
    r = block_merge(run, r, cand, m, tmp, k_out);
    uint64_t* sw = run; run = tmp; tmp = sw;
  }
  for (int t = threadIdx.x; t < k_out; t += blockDim.x) {
    float s = MASKED_SCORE;
    int32_t id = -1;
    if (t < r) {
      uint64_t key = run[t];
      s = ord2f((uint32_t)(key >> 32));
      uint32_t pos = (uint32_t)(key & 0xffffffffu);
      int j = (int)(pos / (uint32_t)p_max);
      int slot = (int)(pos % (uint32_t)p_max);
      size_t row = (size_t)part_ids[j] * p_max + slot;
      id = ids ? ids[row] : (int32_t)row;
    }
    out_s[(size_t)q * k_out + t] = s;
    out_i[(size_t)q * k_out + t] = id;
  }
}

// Shared-memory bytes of pass 2 for a given k_out and chunk count.
static inline size_t pass2_smem_bytes(int k_out, int n_chunks) {
  return (size_t)3 * k_out * sizeof(uint64_t) +
         (size_t)2 * n_chunks * sizeof(int);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
