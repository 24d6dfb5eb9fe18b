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
// cores) is the limit, not the 3.35 TB/s memory. So the design is an
// SGEMM-class main loop with a fused arg-min epilogue:
//
// - A block owns 128 rows and keeps their [128, d] tile resident in shared
//   memory for its whole sweep over one contiguous group of centroids (the
//   rows never change, so they are read from device memory once per
//   block). Where that tile does not fit (d above 256, e.g. GIST-960) the
//   rows stream through the ring beside the centroids instead, one 64-deep
//   chunk at a time.
// - Centroid tiles of 128 stream through a double-buffered ring of 64-deep
//   chunks filled by 16-byte cp.async copies (4-byte copies when
//   d % 4 != 0), so the loads of chunk t+1 overlap the FMAs of chunk t;
//   one barrier per chunk. (Measured on the H100: 64 x 2 stages beat
//   32 x 3 and 16 x 4; two blocks per SM at 128 registers, and an
//   outer-product ordering of the FMAs, were both slower.)
// - 256 threads, each with an 8 x 8 register tile (rows ty + 16 i,
//   centroids tx + 16 j). Shared tiles are row-major with a 4-float pad, so
//   a thread reads 4 depths of a row or centroid as one float4: 16 LDS.128
//   per 256 FMAs, the row reads broadcast within a warp and the centroid
//   reads conflict-free.
// - ||x||^2 and ||c||^2 are computed once per call by a small pre-pass
//   (row_sqnorms), not per block.
// - The centroid range is split across blockIdx.y so a 4096-row call still
//   fills all 132 SMs (one block per SM); a second small pass reduces the
//   groups' (best, arg) per row.
//
// Numerics: each dot product and each squared norm is one sequential IEEE
// float32 fmaf chain over d in increasing order (zero-filled padding adds
// exactly 0), whatever the tiling, so results do not depend on the block
// shape or the group split. No TF32: it would move costs by ~1e-3 relative
// and arg-mins with them.

#include <cstdint>
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int BR = 128;          // rows per block
constexpr int BC = 128;          // centroids per tile
constexpr int DK = 64;           // depth of one ring chunk
constexpr int LDK = DK + 4;      // padded chunk row (floats)
constexpr int NST = 2;           // ring stages
constexpr int THREADS = 256;     // 16 x 16 threads, 8 x 8 results each
constexpr int CHUNK_FLOATS = BC * LDK;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [r0, r0 + 128) x depths [e0, e0 + width) of src [n_rows, d]
// into dst [128][ld], zero-filling rows >= r_end and depths >= d.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, int r0,
                                          int r_end, int d, int e0,
                                          int width, bool vec4) {
  if (vec4) {
    const int segs = width >> 2;
    for (int i = threadIdx.x; i < BR * segs; i += THREADS) {
      const int r = i / segs, e = e0 + 4 * (i % segs);
      const bool ok = (r0 + r < r_end) && (e < d);
      cp_async16(dst + r * ld + (e - e0),
                 ok ? src + (size_t)(r0 + r) * d + e : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BR * width; i += THREADS) {
      const int r = i / width, e = e0 + i % width;
      const bool ok = (r0 + r < r_end) && (e < d);
      cp_async4(dst + r * ld + (e - e0),
                ok ? src + (size_t)(r0 + r) * d + e : src, ok);
    }
  }
}

constexpr int NORM_WARPS = 2;   // warps per block of row_sqnorms
constexpr int NORM_DK = 128;    // depths a warp stages at once

// ||row||^2 of the rows of x [n, d] (then of c [k, d]) into out [n + k]:
// a warp stages 32 rows x 128 depths through shared memory with
// coalesced loads (16 bytes a lane, eight rows in flight), then each lane
// runs its row's sequential fmaf chain.
__global__ void __launch_bounds__(NORM_WARPS * 32)
row_sqnorms(const float* __restrict__ x, int n, const float* __restrict__ c,
            int k, int d, int vec4, float* __restrict__ out) {
  __shared__ float tile[NORM_WARPS][32][NORM_DK + 1];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = (blockIdx.x * NORM_WARPS + w) * 32;
  if (base >= n + k) return;
  float acc = 0.f;
  for (int e0 = 0; e0 < d; e0 += NORM_DK) {
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const int row = base + r;
      const float* src = row < n ? x + (size_t)row * d
                                 : c + (size_t)(row - n) * d;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      const int e = e0 + 4 * lane;
      if (row < n + k) {
        if (vec4) {
          if (e < d) {
            const float4 f = *reinterpret_cast<const float4*>(src + e);
            v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
          }
        } else {
#pragma unroll
          for (int h = 0; h < 4; ++h)
            if (e + h < d) v[h] = src[e + h];
        }
      }
#pragma unroll
      for (int h = 0; h < 4; ++h) tile[w][r][4 * lane + h] = v[h];
    }
    __syncwarp();
    const int te = min(NORM_DK, d - e0);
    for (int t = 0; t < te; ++t) {
      const float v = tile[w][lane][t];
      acc = fmaf(v, v, acc);
    }
    __syncwarp();
  }
  if (base + lane < n + k) out[base + lane] = acc;
}

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
kmeans_assign_tiles(const float* __restrict__ batch,
                    const float* __restrict__ centroids,
                    const float* __restrict__ penalty,
                    const float* __restrict__ sqn,   // [s + k] from row_sqnorms
                    int s, int k, int d, int per_group, int vec4,
                    float* __restrict__ part_d,
                    int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  const int d_pad = (d + DK - 1) / DK * DK;
  const int ldx = RESIDENT ? d_pad + 4 : LDK;
  // [resident rows | ring: NST x (centroid chunk [, row chunk])] + x2
  float* xres = smem;
  float* ring = smem + (RESIDENT ? BR * ldx : 0);
  const int stage_floats = RESIDENT ? CHUNK_FLOATS : 2 * CHUNK_FLOATS;
  float* x2s = ring + NST * stage_floats;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BR;
  const int g = blockIdx.y;
  const int c_begin = g * per_group;
  const int c_end = min(k, c_begin + per_group);
  const int nch = d_pad / DK;
  const int total = (c_end - c_begin + BC - 1) / BC * nch;
  const bool v4 = vec4 != 0;

  if (tid < BR) x2s[tid] = (row0 + tid < s) ? sqn[row0 + tid] : 0.f;
  if (RESIDENT) load_rows(xres, ldx, batch, row0, s, d, 0, d_pad, v4);

  auto issue = [&](int it) {
    if (it < total) {
      const int t0 = c_begin + (it / nch) * BC, e0 = (it % nch) * DK;
      float* st = ring + (it % NST) * stage_floats;
      load_rows(st, LDK, centroids, t0, c_end, d, e0, DK, v4);
      if (!RESIDENT)
        load_rows(st + CHUNK_FLOATS, LDK, batch, row0, s, d, e0, DK, v4);
    }
    cp_async_commit();   // an empty group keeps the wait counts uniform
  };
#pragma unroll
  for (int p = 0; p < NST - 1; ++p) issue(p);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { best[i] = FLT_MAX; arg[i] = c_begin; }

  for (int it = 0; it < total; ++it) {
    cp_async_wait<NST - 2>();
    __syncthreads();          // chunk `it` landed; chunk it-1 fully read
    issue(it + NST - 1);
    const int kc = it % nch;
    const float* cb = ring + (it % NST) * stage_floats;
    const float* xb = RESIDENT ? xres + kc * DK : cb + CHUNK_FLOATS;
#pragma unroll
    for (int e = 0; e < DK; e += 4) {
      float4 xa[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xa[i] = *reinterpret_cast<const float4*>(xb + (ty + 16 * i) * ldx + e);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 cv =
            *reinterpret_cast<const float4*>(cb + (tx + 16 * j) * LDK + e);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float a = acc[i][j];
          a = fmaf(xa[i].x, cv.x, a);
          a = fmaf(xa[i].y, cv.y, a);
          a = fmaf(xa[i].z, cv.z, a);
          a = fmaf(xa[i].w, cv.w, a);
          acc[i][j] = a;
        }
      }
    }
    if (kc == nch - 1) {      // the tile's last chunk: fused arg-min
      const int t0 = c_begin + (it / nch) * BC;
      float c2v[8], pv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = t0 + tx + 16 * j;
        c2v[j] = (c < c_end) ? sqn[s + c] : 0.f;
        pv[j] = (c < c_end) ? penalty[c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xr2 = x2s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = t0 + tx + 16 * j;
          const float d2 = __fsub_rn(__fadd_rn(xr2, c2v[j]),
                                     __fmul_rn(2.f, acc[i][j]));
          const float cost = __fadd_rn(d2, pv[j]);
          if (c < c_end && cost < best[i]) { best[i] = cost; arg[i] = c; }
          acc[i][j] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  // reduce the 16 tx threads of each row: min cost, ties to the smaller index
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float b = best[i];
    int a = arg[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, b, off, 16);
      const int oa = __shfl_down_sync(0xffffffffu, a, off, 16);
      if (ob < b || (ob == b && oa < a)) { b = ob; a = oa; }
    }
    const int gr = row0 + ty + 16 * i;
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

// Dynamic shared memory of the tile kernel; resident when it fits.
size_t tile_smem(int d, bool resident) {
  const int d_pad = (d + DK - 1) / DK * DK;
  const size_t ring = (size_t)NST * (resident ? 1 : 2) * CHUNK_FLOATS;
  return ((resident ? (size_t)BR * (d_pad + 4) : 0) + ring + BR) *
         sizeof(float);
}

constexpr size_t SMEM_LIMIT = 227 * 1024;   // a block's shared memory

}  // namespace

// Launches the norm pre-pass and both passes on `stream`. The caller
// allocates the outputs, the norms scratch sqn [s + k] f32 and the group
// scratch (part_d f32 / part_i i32, [n_groups, s]); n_groups splits the
// centroids into ranges of `per_group` (a multiple of 128). Returns
// cudaGetLastError() (0 = launched).
extern "C" int kmeans_assign_launch(const void* batch, const void* centroids,
                                    const void* penalty, int s, int k, int d,
                                    int n_groups, int per_group, void* sqn,
                                    void* part_d, void* part_i, void* out_i,
                                    void* out_d, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(batch);
  const float* c = static_cast<const float*>(centroids);
  float* nrm = static_cast<float*>(sqn);
  const int vec4 = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(batch) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(centroids) % 16 == 0);
  const int rows_per_block = 32 * NORM_WARPS;
  row_sqnorms<<<(s + k + rows_per_block - 1) / rows_per_block,
                NORM_WARPS * 32, 0, st>>>(x, s, c, k, d, vec4, nrm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool resident = tile_smem(d, true) <= SMEM_LIMIT;
  const size_t smem = tile_smem(d, resident);
  auto kern = resident ? kmeans_assign_tiles<true>
                       : kmeans_assign_tiles<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + BR - 1) / BR, n_groups);
  kern<<<grid, THREADS, smem, st>>>(
      x, c, static_cast<const float*>(penalty), nrm, s, k, d, per_group,
      vec4, static_cast<float*>(part_d), static_cast<int32_t*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kmeans_assign_groups<<<(s + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_d), static_cast<const int32_t*>(part_i),
      s, n_groups, static_cast<int32_t*>(out_i), static_cast<float*>(out_d));
  return (int)cudaGetLastError();
}
