// Block-level top-k building blocks shared by ivf_scan.cu and sq_scan.cu.
//
// A candidate is one 64-bit key: the score mapped to an order-preserving
// uint32 in the high half, its position in the flattened probe list
// (probe position * p_max + slot) in the low half. Keys are distinct (each
// position appears once per query), so "ascending key" is exactly the
// order jax.lax.top_k gives over the flattened [n * p_max] score list:
// ascending score, ties by position. Masked rows never become keys; the
// final pass fills the tail with (MASKED, -1) directly.
#pragma once

#include <cstdint>
#include <cfloat>
#include <cuda_runtime.h>

#define EMPTY_KEY 0xffffffffffffffffull
#define MASKED_SCORE FLT_MAX

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
        int i = 2 * stride * (t / stride) + (t % stride);
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

// Pass 2 of both scans: one block per query merges the query's per-chunk
// partial lists (each sorted, part_cnt entries) into its top-k_out, maps
// positions to ids and fills the exhausted tail with (MASKED, -1).
// `ids` [kp, p_max] may be null: then the flat row id p * p_max + slot is
// emitted (the int8 candidate stage feeds those rows to the f32 rerank).
__global__ void topk_merge_pass2(const uint64_t* __restrict__ part_keys,
                                 const int32_t* __restrict__ part_cnt,
                                 int n_chunks, int k_out,
                                 const int32_t* __restrict__ ids,
                                 const int32_t* __restrict__ part_ids,
                                 int p_max, float* __restrict__ out_s,
                                 int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) uint64_t smem2[];
  uint64_t* run = smem2;
  uint64_t* tmp = run + k_out;
  uint64_t* cand = tmp + k_out;
  const int q = blockIdx.x;
  int r = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t base = ((size_t)q * n_chunks + c) * (size_t)k_out;
    int m = part_cnt[(size_t)q * n_chunks + c];
    if (m == 0) continue;
    if (r == k_out) {  // only entries below the current k-th can enter
      m = lower_bound_u64(part_keys + base, m, run[k_out - 1]);
      if (m == 0) continue;
    }
    for (int t = threadIdx.x; t < m; t += blockDim.x)
      cand[t] = part_keys[base + t];
    __syncthreads();
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

// Shared-memory bytes of pass 2 for a given k_out.
static inline size_t pass2_smem_bytes(int k_out) {
  return (size_t)3 * k_out * sizeof(uint64_t);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
