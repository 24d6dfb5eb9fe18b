// Penalised nearest-centroid assignment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/kmeans_assign.py::kmeans_assign (body _assign_kernel).
//
// What it computes: for each row x of batch [s, d], the arg-min over
// centroids c of cost = ((||x||^2 + ||c||^2) - 2 x.c) + penalty[c], with
// penalty = counts * lambda * scale / target folded by the wrapper (0 for
// the unbalanced final assignment pass of the build). Returns
// (assign [s] int32, cost [s] f32). Ties go to the first index: every
// thread visits its centroids in increasing order with a strict `<`, and
// every reduction across threads or centroid groups breaks equal costs by
// the smaller index -- the same winner as the TPU kernel's running
// (best, arg) over tiles.
//
// What bounds it on the H100: operations. One call at the build's shape
// (4096 rows x ~10,000 centroids x 128) is ~10.5 GFLOP over ~7 MB, about
// 1,500 flop/byte; the float32 FMA rate (67 TFLOP/s outside the tensor
// cores) is the limit, not the 3.35 TB/s memory.
//
// What the design does about it: a block owns 64 rows and one contiguous
// group of centroids, which it streams through shared memory in 64-wide
// tiles and 16-deep chunks. Each thread keeps a 4 x 4 register tile of
// dot products (4 rows x 4 centroids), so one pair of float4 shared-memory
// reads feeds 16 FMAs. The centroid range is split across blockIdx.y so a
// 4096-row call still fills all 132 SMs; a second small pass reduces the
// groups' (best, arg) per row. Ragged edges (rows, centroids, depth) are
// handled by bounds and zero fill, not by the TPU's 1e18 padding. Each
// dot product is one sequential IEEE float32 FMA chain over d (no TF32).
// Tensor cores (3xTF32 or wgmma) are a later PR's work.

#include <cstdint>
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 64;          // rows per block
constexpr int BC = 64;          // centroids per tile
constexpr int DK = 16;          // depth of one shared-memory chunk
constexpr int TX = 16;          // threads across centroids
constexpr int TY = 16;          // threads across rows
constexpr int TR = BR / TY;     // rows per thread (4)
constexpr int TC = BC / TX;     // centroids per thread (4)
constexpr int LD = BR + 4;      // padded smem row: float4-aligned, few conflicts
constexpr int THREADS = TX * TY;

__global__ void __launch_bounds__(THREADS)
kmeans_assign_tiles(const float* __restrict__ batch,
                    const float* __restrict__ centroids,
                    const float* __restrict__ penalty, int s, int k, int d,
                    int per_group, float* __restrict__ part_d,
                    int32_t* __restrict__ part_i) {
  __shared__ __align__(16) float xs[DK][LD];   // [depth][row]
  __shared__ __align__(16) float cs[DK][LD];   // [depth][centroid]
  __shared__ float x2s[BR];
  __shared__ float c2s[BC];
  __shared__ float pens[BC];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.x * BR;
  const int g = blockIdx.y;
  const int c_begin = g * per_group;
  const int c_end = min(k, c_begin + per_group);

  float best[TR];
  int arg[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) { best[i] = FLT_MAX; arg[i] = c_begin; }
  float x2 = 0.f;   // threads [BR, 2 BR): ||x||^2 of row tid - BR

  for (int t0 = c_begin; t0 < c_end; t0 += BC) {
    float acc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
    float c2 = 0.f;  // threads [0, BC): ||c||^2 of centroid t0 + tid
    for (int d0 = 0; d0 < d; d0 += DK) {
      __syncthreads();
      for (int idx = tid; idx < DK * BR; idx += THREADS) {
        const int e = idx % DK, r = idx / DK;
        const int gr = row0 + r, gc = t0 + r, ge = d0 + e;
        xs[e][r] = (gr < s && ge < d) ? batch[(size_t)gr * d + ge] : 0.f;
        cs[e][r] = (gc < c_end && ge < d)
                       ? centroids[(size_t)gc * d + ge] : 0.f;
      }
      __syncthreads();
      if (tid < BC) {
        for (int e = 0; e < DK; ++e) c2 = fmaf(cs[e][tid], cs[e][tid], c2);
      } else if (tid < BC + BR && t0 == c_begin) {
        const int r = tid - BC;
        for (int e = 0; e < DK; ++e) x2 = fmaf(xs[e][r], xs[e][r], x2);
      }
#pragma unroll
      for (int e = 0; e < DK; ++e) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[e][ty * TR]);
        const float4 cv = *reinterpret_cast<const float4*>(&cs[e][tx * TC]);
        const float xa[TR] = {xv.x, xv.y, xv.z, xv.w};
        const float ca[TC] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(xa[i], ca[j], acc[i][j]);
      }
    }
    if (tid < BC) {
      c2s[tid] = c2;
      pens[tid] = (t0 + tid < c_end) ? penalty[t0 + tid] : 0.f;
    } else if (tid < BC + BR && t0 == c_begin) {
      x2s[tid - BC] = x2;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float xr2 = x2s[ty * TR + i];
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int cl = tx * TC + j;
        if (t0 + cl < c_end) {
          const float d2 = __fsub_rn(__fadd_rn(xr2, c2s[cl]),
                                     __fmul_rn(2.f, acc[i][j]));
          const float cost = __fadd_rn(d2, pens[cl]);
          if (cost < best[i]) { best[i] = cost; arg[i] = t0 + cl; }
        }
      }
    }
  }
  // reduce the TX threads of each row: min cost, ties to the smaller index
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float b = best[i];
    int a = arg[i];
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, b, off, TX);
      const int oa = __shfl_down_sync(0xffffffffu, a, off, TX);
      if (ob < b || (ob == b && oa < a)) { b = ob; a = oa; }
    }
    const int gr = row0 + ty * TR + i;
    if (tx == 0 && gr < s) {
      part_d[(size_t)g * s + gr] = b;
      part_i[(size_t)g * s + gr] = a;
    }
  }
}

// Pass 2: per row, the first group holding the smallest cost (groups
// cover increasing centroid ranges, so a strict `<` keeps the first index).
__global__ void kmeans_assign_groups(const float* __restrict__ part_d,
                                     const int32_t* __restrict__ part_i,
                                     int s, int n_groups,
                                     int32_t* __restrict__ out_i,
                                     float* __restrict__ out_d) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= s) return;
  float b = part_d[r];
  int a = part_i[r];
  for (int g = 1; g < n_groups; ++g) {
    const float ob = part_d[(size_t)g * s + r];
    if (ob < b) { b = ob; a = part_i[(size_t)g * s + r]; }
  }
  out_i[r] = a;
  out_d[r] = b;
}

}  // namespace

// Launches both passes on `stream`. The caller allocates the outputs and
// the group scratch (part_d f32 / part_i i32, [n_groups, s]); n_groups
// splits the centroids into ranges of `per_group` (a multiple of 64).
// Returns cudaGetLastError() (0 = launched).
extern "C" int kmeans_assign_launch(const void* batch, const void* centroids,
                                    const void* penalty, int s, int k, int d,
                                    int n_groups, int per_group,
                                    void* part_d, void* part_i, void* out_i,
                                    void* out_d, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((s + BR - 1) / BR, n_groups);
  kmeans_assign_tiles<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(batch), static_cast<const float*>(centroids),
      static_cast<const float*>(penalty), s, k, d, per_group,
      static_cast<float*>(part_d), static_cast<int32_t*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kmeans_assign_groups<<<(s + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int32_t*>(part_i),
      s, n_groups, static_cast<int32_t*>(out_i), static_cast<float*>(out_d));
  return (int)cudaGetLastError();
}
