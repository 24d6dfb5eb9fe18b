// Fused int8 scalar-quantized IVF scan + top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sq_scan.py::sq_scan_topk
// (body _sq_scan_kernel).
//
// What it computes: the candidate stage of the quantized search. Queries
// arrive folded into the stacked two-term int8 form (quantize.fold_queries,
// run by the Python wrapper): q_i8 = [q1; q2] [2Q, d], alpha = [a1; a2]
// [2Q], beta [Q]. For each selected (query, probed partition) pair and
// each row code c, the integer products acc1 = q1.c, acc2 = q2.c are exact
// int32 sums; the epilogue, in float32 in the reference's order, is
//   dots  = (a1 * acc1 + a2 * acc2) + beta
//   score = v2 - 2 * dots (l2)  |  -dots (ip / cosine)
// with v2 from the precomputed code norms or, without them, from the
// decode-and-reduce sum of ((c + 128) * scale + lo)^2. Rows are masked by
// `valid` and the optional post-filter `keep` mask; the output is the
// ascending top-k_out by (score, position), carrying flat row ids
// p * p_max + slot (or `ids` when given), with (MASKED, -1) in the tail.
//
// What bounds it on the H100: bytes. The code tier is d bytes a row, 4x
// fewer than float32, and each pair does 4 * p_max * d integer operations
// over p_max * d bytes -- far below the int8 rate's balance point.
//
// What the design does about it: the same two-pass skeleton as ivf_scan.cu
// (parallel over (query, probe chunk), unselected pairs skipped, shared
// memory partial top-k, pass 2 merge). The accumulation is __dp4a over
// packed 4 x int8 words, exact, so the accumulators equal the plain
// version's bit for bit. No 32-row Q padding: the TPU's int8 tile minimum
// does not exist here.

#include "topk_common.cuh"

namespace {

__global__ void sq_scan_pass1(const int8_t* __restrict__ q_i8,
                              const float* __restrict__ alpha,
                              const float* __restrict__ beta,
                              const float* __restrict__ lo,
                              const float* __restrict__ scale,
                              const int8_t* __restrict__ codes,
                              const float* __restrict__ norms,
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
  float* los = reinterpret_cast<float*>(cand + tile);
  float* scs = los + d;
  int8_t* q1 = reinterpret_cast<int8_t*>(scs + d);
  int8_t* q2 = q1 + ((d + 15) & ~15);
  const int c = blockIdx.x;
  const int q = blockIdx.y;
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    q1[t] = q_i8[(size_t)q * d + t];
    q2[t] = q_i8[(size_t)(n_q + q) * d + t];
    los[t] = lo[t];
    scs[t] = scale[t];
  }
  const float a1 = alpha[q];
  const float a2 = alpha[n_q + q];
  const float b = beta[q];
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
            const int8_t* cr = codes + row * d;
            int acc1 = 0, acc2 = 0;
            if (vec4) {
              const int* c4 = reinterpret_cast<const int*>(cr);
              const int* x4 = reinterpret_cast<const int*>(q1);
              const int* y4 = reinterpret_cast<const int*>(q2);
              for (int e = 0; e < (d >> 2); ++e) {
                const int w = c4[e];
                acc1 = __dp4a(x4[e], w, acc1);
                acc2 = __dp4a(y4[e], w, acc2);
              }
            } else {
              for (int e = 0; e < d; ++e) {
                const int w = cr[e];
                acc1 += (int)q1[e] * w;
                acc2 += (int)q2[e] * w;
              }
            }
            const float t1 = __fmul_rn(a1, (float)acc1);
            const float t2 = __fmul_rn(a2, (float)acc2);
            const float dots = __fadd_rn(__fadd_rn(t1, t2), b);
            float s;
            if (metric_l2) {
              float v2;
              if (norms != nullptr) {
                v2 = norms[row];
              } else {
                v2 = 0.f;
                for (int e = 0; e < d; ++e) {
                  const float v = __fadd_rn(
                      __fmul_rn(__fadd_rn((float)cr[e], 128.f), scs[e]),
                      los[e]);
                  v2 = fmaf(v, v, v2);
                }
              }
              s = __fsub_rn(v2, __fmul_rn(2.f, dots));
            } else {
              s = -dots;
            }
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

// Launches both passes on `stream`; the caller allocates scratch and
// outputs. `norms` and `ids` may be null. Returns cudaGetLastError().
extern "C" int sq_scan_launch(const void* q_i8, const void* alpha,
                              const void* beta, const void* lo,
                              const void* scale, const void* codes,
                              const void* norms, const void* valid,
                              const void* keep, const void* ids,
                              const void* part_ids, const void* qsel,
                              int n_q, int d, int p_max, int n, int chunk,
                              int n_chunks, int k_out, int metric_l2,
                              int tile, int threads, void* part_keys,
                              void* part_cnt, void* out_s, void* out_i,
                              void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int vec4 = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(codes) % 4 == 0);
  const size_t smem1 = (size_t)(2 * k_out + tile) * sizeof(uint64_t) +
                       (size_t)2 * d * sizeof(float) +
                       (size_t)2 * ((d + 15) & ~15);
  cudaError_t err = allow_smem(sq_scan_pass1, smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1(n_chunks, n_q);
  sq_scan_pass1<<<grid1, threads, smem1, st>>>(
      static_cast<const int8_t*>(q_i8), static_cast<const float*>(alpha),
      static_cast<const float*>(beta), static_cast<const float*>(lo),
      static_cast<const float*>(scale), static_cast<const int8_t*>(codes),
      static_cast<const float*>(norms), static_cast<const int8_t*>(valid),
      static_cast<const int8_t*>(keep), static_cast<const int32_t*>(part_ids),
      static_cast<const int8_t*>(qsel), n_q, d, p_max, n, chunk, n_chunks,
      k_out, metric_l2, tile, vec4, static_cast<uint64_t*>(part_keys),
      static_cast<int32_t*>(part_cnt));
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
