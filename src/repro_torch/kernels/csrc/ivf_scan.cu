// Fused IVF partition scan + top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ivf_scan.py::ivf_scan_topk
// (body _scan_kernel, running merge _merge_topk).
//
// What it computes: for each query q and each probed partition part_ids[j]
// that q selects (qsel[q, j] != 0), the scores ||v||^2 - 2 q.v (l2) or
// -q.v (ip / cosine) of the partition's p_max rows, masked by `valid` and
// the optional post-filter `keep` mask, and the ascending top-k_out over
// the flattened [n * p_max] list, ties broken by position j * p_max + slot
// (the order lax.top_k gives). Fewer qualifying rows than k_out leaves
// (MASKED, -1) in the tail -- never a repeated id.
//
// What bounds it on the H100: bytes. Each probed (query, partition) pair
// does 2 * p_max * d flops over p_max * d * 4 bytes, i.e. 0.5 flop/byte,
// far below the ~20 flop/byte where float32 compute would take over. The
// least time is the probed partitions' payload read once at 3.35 TB/s.
//
// What the design does about it: the TPU walks the probe list serially,
// one grid step per partition, with a [Q, p_max] product that scores every
// query against every partition and masks most of it away. Here blocks run
// in parallel over (query, chunk of the probe list) and skip every pair the
// query did not select, so only Q * n_probe pairs read anything. A block
// keeps a sorted partial top-k_out in shared memory; pass 2 merges each
// query's partials. Each row's dot product is one thread's sequential
// IEEE float32 FMA chain over d, so a row's score does not depend on the
// chunking or the batch size. Rows of a partition shared by several
// queries are read once per query; L2 (50 MB) absorbs most of the repeats.
// Simple first: no TMA, no tensor cores (a later PR's work).

#include "topk_common.cuh"

namespace {

__global__ void ivf_scan_pass1(const float* __restrict__ queries,
                               const float* __restrict__ vectors,
                               const int8_t* __restrict__ valid,
                               const int8_t* __restrict__ keep,
                               const int32_t* __restrict__ part_ids,
                               const int8_t* __restrict__ qsel, int n_q,
                               int d, int p_max, int n, int chunk,
                               int n_chunks, int k_out, int metric_l2,
                               int tile, int vec4,
                               uint64_t* __restrict__ part_keys,
                               int32_t* __restrict__ part_cnt) {
  extern __shared__ __align__(16) uint64_t smem1[];
  uint64_t* run = smem1;
  uint64_t* tmp = run + k_out;
  uint64_t* cand = tmp + k_out;
  float* qs = reinterpret_cast<float*>(cand + tile);
  const int c = blockIdx.x;
  const int q = blockIdx.y;
  for (int t = threadIdx.x; t < d; t += blockDim.x)
    qs[t] = queries[(size_t)q * d + t];
  __syncthreads();

  int r = 0;
  const int j0 = c * chunk;
  const int j1 = min(n, j0 + chunk);
  for (int j = j0; j < j1; ++j) {
    if (qsel != nullptr && qsel[(size_t)q * n + j] == 0) continue;
    const size_t p = (size_t)part_ids[j];
    for (int s0 = 0; s0 < p_max; s0 += tile) {
      int found = 0;
      for (int t = threadIdx.x; t < tile; t += blockDim.x) {
        uint64_t key = EMPTY_KEY;
        const int slot = s0 + t;
        if (slot < p_max) {
          const size_t row = p * p_max + slot;
          if (valid[row] != 0 && (keep == nullptr || keep[row] != 0)) {
            const float* v = vectors + row * d;
            float dot = 0.f, v2 = 0.f;
            if (vec4) {
              const float4* v4 = reinterpret_cast<const float4*>(v);
              const float4* q4 = reinterpret_cast<const float4*>(qs);
              for (int e = 0; e < (d >> 2); ++e) {
                float4 a = v4[e];
                float4 b = q4[e];
                dot = fmaf(b.x, a.x, dot); v2 = fmaf(a.x, a.x, v2);
                dot = fmaf(b.y, a.y, dot); v2 = fmaf(a.y, a.y, v2);
                dot = fmaf(b.z, a.z, dot); v2 = fmaf(a.z, a.z, v2);
                dot = fmaf(b.w, a.w, dot); v2 = fmaf(a.w, a.w, v2);
              }
            } else {
              for (int e = 0; e < d; ++e) {
                float a = v[e];
                dot = fmaf(qs[e], a, dot);
                v2 = fmaf(a, a, v2);
              }
            }
            const float s = metric_l2 ? __fsub_rn(v2, __fmul_rn(2.f, dot))
                                      : -dot;
            key = make_key(s, (uint32_t)((size_t)j * p_max + slot));
            if (r == k_out && key >= run[k_out - 1]) key = EMPTY_KEY;
          }
        }
        cand[t] = key;
        found |= (key != EMPTY_KEY);
      }
      if (!__syncthreads_or(found)) continue;
      block_bitonic_sort(cand, tile);
      const int m = lower_bound_u64(cand, tile, EMPTY_KEY);
      r = block_merge(run, r, cand, m, tmp, k_out);
      uint64_t* sw = run; run = tmp; tmp = sw;
    }
  }
  const size_t base = ((size_t)q * n_chunks + c) * (size_t)k_out;
  for (int t = threadIdx.x; t < r; t += blockDim.x) part_keys[base + t] = run[t];
  if (threadIdx.x == 0) part_cnt[(size_t)q * n_chunks + c] = r;
}

}  // namespace

// Launches both passes on `stream`. Scratch (part_keys [Q, n_chunks, k_out]
// u64, part_cnt [Q, n_chunks] i32) and outputs are allocated by the caller.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ivf_scan_launch(const void* queries, const void* vectors,
                               const void* valid, const void* keep,
                               const void* ids, const void* part_ids,
                               const void* qsel, int n_q, int d, int p_max,
                               int n, int chunk, int n_chunks, int k_out,
                               int metric_l2, int tile, int threads,
                               void* part_keys, void* part_cnt, void* out_s,
                               void* out_i, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int vec4 = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(vectors) % 16 == 0);
  const size_t smem1 = (size_t)(2 * k_out + tile) * sizeof(uint64_t) +
                       (size_t)(d + 4) * sizeof(float);
  cudaError_t err = allow_smem(ivf_scan_pass1, smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1(n_chunks, n_q);
  ivf_scan_pass1<<<grid1, threads, smem1, st>>>(
      static_cast<const float*>(queries), static_cast<const float*>(vectors),
      static_cast<const int8_t*>(valid), static_cast<const int8_t*>(keep),
      static_cast<const int32_t*>(part_ids), static_cast<const int8_t*>(qsel),
      n_q, d, p_max, n, chunk, n_chunks, k_out, metric_l2, tile, vec4,
      static_cast<uint64_t*>(part_keys), static_cast<int32_t*>(part_cnt));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = pass2_smem_bytes(k_out);
  err = allow_smem(topk_merge_pass2, smem2);
  if (err != cudaSuccess) return (int)err;
  topk_merge_pass2<<<n_q, threads, smem2, st>>>(
      static_cast<const uint64_t*>(part_keys),
      static_cast<const int32_t*>(part_cnt), n_chunks, k_out,
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(part_ids),
      p_max, static_cast<float*>(out_s), static_cast<int32_t*>(out_i));
  return (int)cudaGetLastError();
}
